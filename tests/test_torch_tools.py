"""The port's tools around the main path (``rte_rrtmgp_torch/tools``:
``profile_stages``, ``ablate``, ``crosscheck``, ``scaling_bench``,
``bench_rt_solve``, ``plot_fluxes``) on the CPU, at small sizes (8
columns x 24 layers, ``gpt_per_band`` 2):

* ``profile_stages.profile`` profiles ``step.make_step`` itself: its
  fluxes equal an unprofiled step's in float64 at rtol 1e-10 in every
  layout, one chunk and several, and it times every stage the driver's
  ranges name;
* ``ablate``'s full LW / SW pipelines equal the broadband solvers' sums
  at rtol 1e-10;
* ``crosscheck --device cpu`` runs all its legs and passes, and its CPU
  float64 aerosky output equals the JAX package's CLI on the same files
  and flags at rtol 1e-10;
* ``scaling_bench`` on a mesh listing the CPU twice equals the unsharded
  step within 1e-10 relative, in both modes;
* ``bench_rt_solve`` at a 4x4x12 domain (14 g-points in ``lanes``): the
  flux at the top exact and energy closed within 2%;
* ``plot_fluxes`` writes a PNG;
* every tool that computes raises without a card unless given the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu import cli as jcli
from rte_rrtmgp_tpu.utils.ncio import NcReader as JNcReader

from rte_rrtmgp_torch import step
from rte_rrtmgp_torch.ops import gas_optics as go, rte_lw, rte_sw
from rte_rrtmgp_torch.tools import (ablate, bench_rt_solve, crosscheck,
                                    make_goldens, plot_fluxes, profile_stages,
                                    scaling_bench)
from rte_rrtmgp_torch.utils.ncio import NcReader

torch.set_num_threads(2)

F64 = torch.float64
NCOL, NLAY = 8, 24
LAYOUTS = {"default": dict(cellw=True, layer_major=False),
           "cellw_off": dict(cellw=False, layer_major=False),
           "layer_major": dict(cellw=True, layer_major=True)}


@pytest.fixture(scope="module")
def case():
    tables = step.build_tables(2, dtype=F64, device="cpu")
    arrs = step.atmos_arrays(NCOL, NLAY, dtype=np.float64)
    return tables, arrs


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1e-300)).max())


# The step's broadband SW solve combines the gas optics and adds the
# clouds inside its solve (the fused entry): no sw_combine or
# sw_cloud_increment range.
STEP_STAGES = {f"{s}_{n}" for s in ("lw", "sw") for n in (
    "inputs", "col_gas", "cloud_optics", "interpolation", "gas_optics",
    "solve", "fluxes")} | {"lw_planck", "lw_cloud_add"}


@pytest.mark.parametrize("chunk", [None, 12])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_chain_matches_step(case, layout, chunk):
    """``profile`` runs the step itself: its fluxes equal an unprofiled
    ``make_step`` and its ranges name every stage of the layout's path."""
    tables, _ = case
    arrs = step.atmos_arrays(NCOL, NLAY, seed=0)
    ref = step.make_step(*tables, gpt_chunk=chunk, **LAYOUTS[layout])(
        *[arrs[k] for k in step.ARG_NAMES])
    res = profile_stages.profile(NCOL, NLAY, chunk, "cpu", warmup=0, iters=1,
                                 tables=tables, **LAYOUTS[layout])
    got = res["out"]
    assert sorted(got) == sorted(ref) and res["layout"] == layout
    for k in ref:
        assert got[k].dtype == F64
        assert _rel(got[k], ref[k]) <= 1e-10, k
    lm = {"lw_layer_major", "sw_layer_major"}
    assert set(res["stages"]) == STEP_STAGES | (
        lm if layout == "layer_major" else set())
    nchunks = 1 if chunk is None else -(-tables[0].ngpt // chunk)
    assert res["calls"]["lw_gas_optics"] == nchunks
    # The accumulators' zeros, one sum a chunk, the outputs.
    assert res["calls"]["lw_fluxes"] == nchunks + 2


def test_profile_times_every_stage(capsys, monkeypatch):
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "1")
    monkeypatch.setenv("RTE_RRTMGP_LAYERMAJOR", "0")
    assert profile_stages.main(["8", "24", "128", "--device", "cpu",
                                "--iters", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["layout"] == "default" and res["shape"] == [8, 24, 128]
    assert set(res["stages"]) == STEP_STAGES
    assert all(ms > 0 for ms in res["stages"].values())
    # 256 LW and 224 SW g-points: two chunks each at gpt_chunk 128.
    assert res["calls"]["lw_gas_optics"] == 2 == res["calls"]["sw_solve"]
    assert res["calls"]["lw_fluxes"] == 4
    assert res["sum_ms"] == pytest.approx(sum(res["stages"].values()))
    assert res["device_ms"] is None and res["event_ms"] > 0


def test_ablate_full_equals_broadband_solvers(case):
    (kd_lw, kd_sw, _, _), arrs = case
    a = ablate.top_first(arrs, F64, "cpu")
    lw, sw = ablate.lw_full(kd_lw, a), ablate.sw_full(kd_sw, a)
    op, src = go.gas_optics_lw(kd_lw, a["p_lay"], a["p_lev"], a["t_lay"],
                               a["t_lev"], a["t_sfc"], a["vmr"], a["col_dry"],
                               NLAY - 1)
    n, m = kd_lw.ngpt, kd_sw.ngpt
    up, dn, _ = rte_lw.lw_solver_noscat_broadband(
        op.tau, src.lay_src, src.lev_src, torch.full((NCOL, n), 0.98, dtype=F64),
        src.sfc_src, src.sfc_src_jac, torch.zeros((NCOL, n), dtype=F64))
    assert _rel(lw["lw_flux_up"], up) <= 1e-10
    assert _rel(lw["lw_flux_dn"], dn) <= 1e-10
    # The surface is the last layer: LW up there near sigma T^4.
    ratio = lw["lw_flux_up"][:, -1] / (5.670374419e-8 * a["t_sfc"] ** 4)
    assert bool(((ratio > 0.9) & (ratio < 1.01)).all())
    op2, _ = go.gas_optics_sw(kd_sw, a["p_lay"], a["p_lev"], a["t_lay"],
                              a["vmr"], a["col_dry"])
    alb = torch.full((NCOL, m), 0.06, dtype=F64)
    ref = rte_sw.sw_solver_2stream_broadband(
        op2.tau, op2.ssa, op2.g, a["mu0"].clamp(min=0.1), alb, alb,
        torch.ones((NCOL, m), dtype=F64))
    for k, r in zip(("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"), ref):
        assert _rel(sw[k], r) <= 1e-10, k


def test_ablate_runs_seven_pipelines():
    res = ablate.run(NCOL, NLAY, "cpu", iters=1, verbose=False)
    assert list(res) == [name for name, _, _ in ablate.PIPELINES]
    assert all(v > 0 for v in res.values())


@pytest.fixture(scope="module")
def crosschecked(tmp_path_factory):
    d = tmp_path_factory.mktemp("crosscheck")
    return d, crosscheck.run(str(d), device="cpu", gpt_per_band=2)


def test_crosscheck_cpu_runs_every_leg(crosschecked):
    _, res = crosschecked
    assert res["ok"]
    for case in crosscheck.CASES:
        r = res[case]
        assert r["ok"] and len(r["dev_vs_cpu_f32"]) == 7
        # --device cpu: the "device" leg is the CPU's float32 run again.
        assert max(r["dev_vs_cpu_f32"].values()) == 0.0
        assert 0 < max(r["cpu_f32_vs_f64"].values()) <= crosscheck.INFO_WM2
        assert r["launches"] == {"cpu_f64": {}, "cpu_f32": {}, "dev_f32": {}}


def test_crosscheck_f64_aerosky_equals_jax_cli(crosschecked):
    d, res = crosschecked
    case = d / "aerosky"
    out = str(case / "jax_f64.nc")
    argv = ["--input", "rte_rrtmgp_input.nc", "--coefs-lw",
            "coefficients_lw.nc", "--coefs-sw", "coefficients_sw.nc",
            "--cloud-lw", "cloud_coefficients_lw.nc", "--cloud-sw",
            "cloud_coefficients_sw.nc", "--aerosol", "aerosol_optics.nc"]
    argv = [str(case / a) if a.endswith(".nc") else a for a in argv]
    assert jcli.main(argv + crosscheck.COMMON + crosscheck.CASES["aerosky"]
                     + ["--precision", "float64", "--output", out]) == 0
    with NcReader(res["aerosky"]["files"]["cpu_f64"]) as p, \
            JNcReader(out) as j:
        names = [v for v in p.variables() if "_flux_" in v]
        assert len(names) == 7
        for v in names:
            np.testing.assert_allclose(p.read(v), j.read(v), rtol=1e-10,
                                       err_msg=v)


@pytest.mark.parametrize("mode", ["annotate", "shardmap"])
def test_scaling_bench_cpu_mesh_equals_unsharded(case, mode):
    tables, arrs = case
    ref = step.make_step(*tables, gpt_chunk=12)(
        *[arrs[k] for k in step.ARG_NAMES])
    res, out = scaling_bench.measure(2, mode, tables, arrs, gpt_chunk=12,
                                     iters=1, device="cpu")
    assert res["devices"] == 2 and res["distinct_devices"] == 1
    assert res["ncol"] == NCOL and res["ms_per_step"] > 0
    for k in ref:
        assert _rel(out[k], ref[k]) <= 1e-10, k


def test_bench_rt_solve_closes_energy():
    res = bench_rt_solve.measure(nx=4, nlay=24, nz=12, ppp=4, gpt_per_band=1,
                                 spectral="lanes", warmup=0, device="cpu")
    out = res["out"]
    assert res["ngpt"] == 14 and res["photons_per_s"] > 0
    assert all(bool(torch.isfinite(getattr(out, k)).all())
               for k in out._fields if k.startswith("rt_flux"))
    assert res["tod_dn_mean_wm2"] == pytest.approx(res["tod_dn_exact_wm2"],
                                                   rel=1e-6)
    assert abs(res["closure"]) <= 0.02


def test_plot_fluxes_writes_png(crosschecked, tmp_path):
    pytest.importorskip("matplotlib")
    _, res = crosschecked
    files = res["allsky"]["files"]
    png = tmp_path / "fluxes.png"
    inp = os.path.join(os.path.dirname(files["cpu_f64"]), "rte_rrtmgp_input.nc")
    assert plot_fluxes.main([files["dev_f32"], files["cpu_f64"], "--input",
                             inp, "--out", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    means = plot_fluxes.column_means(files["cpu_f64"])
    assert set(means) == set(plot_fluxes.VARS)
    assert all(v.shape == (73,) for v in means.values())


@pytest.mark.parametrize("tool", [profile_stages, ablate, crosscheck,
                                  bench_rt_solve, scaling_bench, make_goldens],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_refuse_to_run_without_a_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--out-dir", str(tmp_path)] if tool is make_goldens else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
