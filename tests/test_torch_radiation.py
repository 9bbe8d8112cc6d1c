"""The port end to end on the CPU.

* The port's version of ``golden_case.solve_case`` (f64: LW clear and
  cloudy, SW all-sky with aerosols, delta-scaled) is held to the frozen
  goldens at the reference CI gate, 5.8e-2 W m-2.
* The port's flagship step in f32 is held to the JAX ``make_step`` in f32 at
  0.7 W m-2 (the crosscheck gate; f32 is never held to the f64 goldens).
* Both gates hold in each of the step's layouts (``cellw=False``,
  ``layer_major=True``), and each layout's broadband fluxes agree with JAX
  in f64; ``None`` layouts come from the environment.
* The solver classes' other outputs (by-band fluxes, optical properties,
  several Gauss angles, night columns) agree with JAX in f64.
* With no card, an entry point called without ``device="cpu"`` raises.
"""

import os

import numpy as np
import pytest
import torch

import jax
import golden_case
import __graft_entry__ as graft
from rte_rrtmgp_tpu.models import RadiationSolverLW as JSolverLW
from rte_rrtmgp_tpu.models import RadiationSolverSW as JSolverSW
from rte_rrtmgp_tpu.utils.ncio import NcReader

from rte_rrtmgp_torch import config, convert, step
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import (AerosolLUT, CloudLUT, KDist,
                                     RadiationSolverLW, RadiationSolverSW)
from rte_rrtmgp_torch.models.kdist import META_FIELDS, TABLE_FIELDS

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "fluxes_f64.nc")
F32_GATE_WM2 = 0.7


def solve_case_port(**layout):
    """``golden_case.solve_case`` through the port, float64 on the CPU;
    ``layout``: the solvers' ``cellw`` / ``layer_major``."""
    f64, cpu = torch.float64, "cpu"
    gases = golden_case.GOLDEN_GASES
    kd_lw = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=4),
                           gases, dtype=f64, device=cpu)
    kd_sw = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=4),
                           gases, dtype=f64, device=cpu)
    cl_lw = CloudLUT.from_raw(synthetic.make_cloud_raw(True), dtype=f64, device=cpu)
    cl_sw = CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=f64, device=cpu)
    alut = AerosolLUT.from_raw(synthetic.make_aerosol_raw(), dtype=f64, device=cpu)
    atm = make_atmosphere(golden_case.NCOL, golden_case.NLAY, seed=7)
    emis = np.full((golden_case.NCOL, kd_lw.nbnd), 0.98)
    alb = np.full((golden_case.NCOL, kd_sw.nbnd), 0.06)
    common = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
                  p_lev=atm["p_lev"], t_lay=atm["t_lay"])
    out = {}
    lw = RadiationSolverLW(kd_lw, cl_lw)
    clear = lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"], emis_sfc=emis,
                     **common, **layout)
    cloudy = lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"], emis_sfc=emis,
                      lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                      dei=atm["dei"], **common, **layout)
    for k in ("lw_flux_up", "lw_flux_dn"):
        out["clear_" + k] = clear[k].numpy()
        out["cloudy_" + k] = cloudy[k].numpy()
    sw = RadiationSolverSW(kd_sw, cl_sw, alut)
    swout = sw.solve(mu0=atm["mu0"], sfc_alb_dir=alb, sfc_alb_dif=alb,
                     lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                     dei=atm["dei"], rh=atm["rh"], aermr=atm["aermr"],
                     delta_cloud=True, delta_aerosol=True, **common, **layout)
    for k in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"):
        out["allsky_" + k] = swout[k].numpy()
    return out


def _golden_worst(got):
    worst = {}
    with NcReader(GOLDEN) as nc:
        for name, arr in got.items():
            ref = nc.read(name)
            assert ref.shape == arr.shape, name
            worst[name] = float(np.abs(arr - ref).max())
    return worst


def test_golden_case_within_gate():
    worst = _golden_worst(solve_case_port())
    report = ", ".join(f"{k}={v:.2e}" for k, v in sorted(worst.items()))
    assert max(worst.values()) <= golden_case.THRESHOLD_WM2, report


# The two layouts besides the default: (cellw, layer_major).
NEW_LAYOUTS = {"cellw_off": dict(cellw=False, layer_major=False),
               "layer_major": dict(cellw=True, layer_major=True)}


@pytest.mark.parametrize("layout", list(NEW_LAYOUTS))
def test_golden_case_layouts_within_gate(layout):
    worst = _golden_worst(solve_case_port(**NEW_LAYOUTS[layout]))
    report = ", ".join(f"{k}={v:.2e}" for k, v in sorted(worst.items()))
    assert max(worst.values()) <= golden_case.THRESHOLD_WM2, report


@pytest.fixture(scope="module")
def f32_case():
    """8 columns x 16 layers, gpt_per_band=2, gpt_chunk=16: two spectral
    chunks in the LW (32 g-points) and the SW (28).  The port's tables and
    inputs, and the JAX f32 step's fluxes."""
    ncol, nlay, chunk = 8, 16, 16
    tables = step.build_tables(2, dtype=torch.float32, device="cpu")
    arrs = step.atmos_arrays(ncol, nlay)
    jarrs = graft._atmos_arrays(ncol, nlay)
    for k in step.ARG_NAMES:
        np.testing.assert_array_equal(arrs[k], jarrs[k], err_msg=k)
    jstep = jax.jit(graft.make_step(*graft._build(2), gpt_chunk=chunk))
    ref = jstep(*[jarrs[k] for k in step.ARG_NAMES])
    return tables, [arrs[k] for k in step.ARG_NAMES], chunk, ref


def _f32_within_gate(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape == (8, 17), k
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= F32_GATE_WM2, (k, np.abs(a - b).max())


def test_flagship_step_f32_matches_jax(f32_case):
    tables, args, chunk, ref = f32_case
    _f32_within_gate(step.make_step(*tables, gpt_chunk=chunk)(*args), ref)


@pytest.mark.parametrize("layout", list(NEW_LAYOUTS))
def test_flagship_step_f32_layouts_match_jax(f32_case, layout):
    tables, args, chunk, ref = f32_case
    _f32_within_gate(step.make_step(*tables, gpt_chunk=chunk,
                                    **NEW_LAYOUTS[layout])(*args), ref)


@pytest.fixture(scope="module")
def small_tables():
    """gpt_per_band=1 tables in f64, the port's carried over from the JAX
    package's through ``convert``."""
    from rte_rrtmgp_tpu.models.kdist import KDist as JKDist
    gases = golden_case.GOLDEN_GASES
    out = {}
    for lw in (True, False):
        jkd = JKDist.from_raw(synthetic.make_kdist_raw(lw, gpt_per_band=1),
                              gases, dtype=np.float64)
        kd = convert.kdist_from_numpy(
            {k: None if getattr(jkd, k) is None else np.asarray(getattr(jkd, k))
             for k in TABLE_FIELDS},
            {k: getattr(jkd, k) for k in META_FIELDS},
            device="cpu", dtype=torch.float64)
        out[lw] = (kd, jkd)
    return out


def _jax_luts(tmp_path):
    from rte_rrtmgp_tpu.data import synthetic as jsyn
    from rte_rrtmgp_tpu.models import AerosolLUT as JA, CloudLUT as JC
    luts = {}
    for lw in (True, False):
        p = str(tmp_path / f"c{int(lw)}.nc")
        jsyn.write_cloud_nc(p, jsyn.make_cloud_raw(lw))
        luts[lw] = JC.from_netcdf(p, dtype=np.float64)
    p = str(tmp_path / "a.nc")
    jsyn.write_aerosol_nc(p, jsyn.make_aerosol_raw())
    return luts, JA.from_netcdf(p, dtype=np.float64)


def _close(got, ref, keys):
    """rtol 1e-10 with an absolute floor of 1e-10 of each array's largest
    magnitude: the by-band down-fluxes just below the top are ~1e-10 of the
    array's maximum, where 1 - exp(-tau*D) cancels for tau ~ 1e-10 and the
    two libraries' float64 exp, equal to the last bit elsewhere, leave
    ~1e-6 relative in those elements."""
    for k in keys:
        b = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(), err_msg=k)


@pytest.fixture(scope="module")
def options_case(small_tables, tmp_path_factory):
    """The LW and SW solves with every output option (by-band fluxes,
    optical properties, two Gauss angles, a night column): the port's
    solvers, the inputs, and the JAX solvers' outputs."""
    jluts, jalut = _jax_luts(tmp_path_factory.mktemp("luts"))
    f64, cpu = torch.float64, "cpu"
    out = {}

    kd, jkd = small_tables[True]
    atm = make_atmosphere(4, 8, seed=5)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], t_lev=atm["t_lev"],
              t_sfc=atm["t_sfc"], emis_sfc=np.full((4, kd.nbnd), 0.95),
              lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
              gpt_chunk=6, output_bnd_fluxes=True, n_gauss_angles=2,
              output_optical=True)
    solver = RadiationSolverLW(kd, CloudLUT.from_raw(
        synthetic.make_cloud_raw(True), dtype=f64, device=cpu))
    out[True] = (solver, kw, JSolverLW(jkd, jluts[True]).solve(**kw))

    kd, jkd = small_tables[False]
    atm = make_atmosphere(4, 8, seed=6)
    mu0 = atm["mu0"].copy()
    mu0[2] = -0.1                         # a night column
    alb = np.full((4, kd.nbnd), 0.1)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], mu0=mu0,
              sfc_alb_dir=alb, sfc_alb_dif=alb, lwp=atm["lwp"],
              iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"], rh=atm["rh"],
              aermr=atm["aermr"], gpt_chunk=5, output_bnd_fluxes=True,
              delta_cloud=True, output_optical=True)
    solver = RadiationSolverSW(
        kd, CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=f64,
                              device=cpu),
        AerosolLUT.from_raw(synthetic.make_aerosol_raw(), dtype=f64,
                            device=cpu))
    out[False] = (solver, kw, JSolverSW(jkd, jluts[False], jalut).solve(**kw))
    return out


def test_lw_solver_options_match_jax(options_case):
    solver, kw, ref = options_case[True]
    got = solver.solve(**kw)
    assert set(got) == set(ref)
    _close(got, ref, ref)


def test_sw_solver_options_match_jax(options_case):
    solver, kw, ref = options_case[False]
    got = solver.solve(**kw)
    assert set(got) == set(ref)
    _close(got, ref, ref)
    assert float(got["sw_flux_dn"][2].abs().max()) == 0.0


# (cellw, layer_major): the two layouts besides the default, and
# layer-major without cellw, which JAX's predicate sends to the default
# layout.
LAYOUTS = {"cellw_off": (False, False), "layer_major": (True, True),
           "layer_major_without_cellw": (False, True)}


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: (calls.append(1), fn(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_solve_layouts_match_jax(options_case, monkeypatch, longwave,
                                 layout):
    """The broadband fluxes of each layout (broadband output only, so that
    layer-major applies) against the JAX solve of the same inputs, which
    runs its XLA path for every layout on the CPU.  rtol 1e-10; each case
    checks which path ran: the SW solves from the gas optics through the
    fused entries (their twin in float64)."""
    from rte_rrtmgp_torch.ops import gas_optics as go, rte_lw, rte_sw
    cellw, layer_major = LAYOUTS[layout]
    solver, kw, ref = options_case[longwave]
    planes = _count_calls(monkeypatch, go, "tau_major_and_pfrac" if longwave
                          else "tau_major_and_rayleigh")
    lm = _count_calls(monkeypatch, rte_lw if longwave else rte_sw,
                      "lw_solver_noscat_broadband_lm" if longwave
                      else "sw_solver_2stream_fused_broadband_lm")
    cm = _count_calls(monkeypatch, rte_lw if longwave else rte_sw,
                      "lw_solver_noscat_broadband" if longwave
                      else "sw_solver_2stream_fused_broadband")
    got = solver.solve(**dict(kw, output_bnd_fluxes=False,
                              output_optical=False),
                       cellw=cellw, layer_major=layer_major)
    nchunks = -(-solver.kdist.ngpt // kw["gpt_chunk"])
    assert len(lm) == (nchunks if layout == "layer_major" else 0)
    assert len(cm) == (0 if layout == "layer_major" else nchunks)
    assert len(planes) == (0 if cellw else nchunks)
    bb = [k for k in ref if "_bnd_" not in k and k.split("_")[0] in ("lw", "sw")
          and "flux" in k]
    assert set(got) == set(bb)
    for k in bb:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, atol=0.0, err_msg=k)


def test_layout_from_environment(options_case, monkeypatch):
    """cellw / layer_major left as None read RTE_RRTMGP_PALLAS_CELLW
    (default on) and RTE_RRTMGP_LAYERMAJOR (default off), parsed as the JAX
    package parses them."""
    from rte_rrtmgp_torch.ops import gas_optics as go, rte_lw
    monkeypatch.delenv("RTE_RRTMGP_PALLAS_CELLW", raising=False)
    monkeypatch.delenv("RTE_RRTMGP_LAYERMAJOR", raising=False)
    assert config.cellw_enabled() and not config.layer_major_enabled()
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "off")
    monkeypatch.setenv("RTE_RRTMGP_LAYERMAJOR", "1")
    assert not config.cellw_enabled() and config.layer_major_enabled()
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "true")
    solver, kw, _ = options_case[True]
    lm = _count_calls(monkeypatch, rte_lw, "lw_solver_noscat_broadband_lm")
    planes = _count_calls(monkeypatch, go, "tau_major_and_pfrac")
    solver.solve(**dict(kw, output_bnd_fluxes=False, output_optical=False))
    assert len(lm) == 3 and not planes


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = synthetic.make_kdist_raw(True, gpt_per_band=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KDist.from_raw(raw, golden_case.GOLDEN_GASES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CloudLUT.from_raw(synthetic.make_cloud_raw(True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AerosolLUT.from_raw(synthetic.make_aerosol_raw())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step.build_tables(1)
    # The explicit CPU request works.
    assert KDist.from_raw(raw, golden_case.GOLDEN_GASES,
                          device="cpu").device.type == "cpu"
