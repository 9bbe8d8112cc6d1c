"""The port's CLI (``rte_rrtmgp_torch/cli.py``), case tools and RFMIP sweep
against the JAX package's, on the same input files.

One tiny case written by the JAX writers (3 x 2 columns x 16 layers,
``gpt_per_band=2``, clouds and aerosols) runs through both CLIs with the
same flags:

* in float64 (the port with ``--device cpu``): every output variable has
  the same name, dimensions and shape, and values agree at rtol 1e-10,
  with an absolute floor of 1e-10 x the array's largest magnitude for the
  by-band and optical arrays (as ``tests/test_torch_radiation.py``: there
  1 - exp(-tau) cancels at tiny tau and the two libraries' float64 exp
  differ in the last bit); ``cases.check.compare`` passes both ways at
  its 5.8e-2 W m-2 gate;
* broadband in float32: within 0.7 W m-2 of JAX's float32 run (the
  crosscheck gate, PARITY.md:144-154).

Also: the port's input writer and case generator give JAX's arrays;
``--no-fluxes`` writes no flux variable; the checker tells cloud from no
cloud; the CLI refuses to run without a card unless given ``--device cpu``
(float64 included) before reading a table; ``rfmip.run``
(float32 by design) within 0.7 W m-2 of JAX's.
"""

import os

import h5py
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu import cli as jcli
from rte_rrtmgp_tpu.cases import inputs as jinputs
from rte_rrtmgp_tpu.cases import rfmip as jrfmip
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jmake_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.utils.ncio import NcReader as JNcReader

from rte_rrtmgp_torch import cli
from rte_rrtmgp_torch.cases import check, inputs, rfmip
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.utils import ncio

torch.set_num_threads(2)

F32_GATE_WM2 = 0.7
FLAGS = {
    "bybnd_aerosol": ["--cloud-optics", "--aerosol-optics", "--delta-cloud",
                      "--output-bnd-fluxes"],
    "broadband": ["--cloud-optics"],
    "optical": ["--no-shortwave", "--no-fluxes", "--output-optical"],
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The case files (JAX writers) and a cache of both CLIs' outputs."""
    d = tmp_path_factory.mktemp("case")
    atm = jmake_atmosphere(6, 16, seed=4, perturb=True)
    jinputs.write_input_nc(str(d / "rte_rrtmgp_input.nc"), atm, 3, 2,
                           with_clouds=True, with_aerosols=True)
    for lw, tag in ((True, "lw"), (False, "sw")):
        jsyn.write_kdist_nc(str(d / f"coefficients_{tag}.nc"),
                            jsyn.make_kdist_raw(lw, gpt_per_band=2))
        jsyn.write_cloud_nc(str(d / f"cloud_coefficients_{tag}.nc"),
                            jsyn.make_cloud_raw(lw))
    jsyn.write_aerosol_nc(str(d / "aerosol_optics.nc"), jsyn.make_aerosol_raw())
    return d, {}


def _run(case, which, flags, precision):
    """Output path of ``which`` ("jax" or "port") CLI for these flags."""
    d, done = case
    key = (which, tuple(flags), precision)
    if key not in done:
        out = str(d / f"out_{which}_{len(done)}.nc")
        argv = [*flags, "--precision", precision, "--output", out]
        cwd = os.getcwd()
        os.chdir(d)
        try:
            if which == "jax":
                rc = jcli.main(argv)
            else:
                rc = cli.main(argv + ["--device", "cpu"])
        finally:
            os.chdir(cwd)
        assert rc == 0
        done[key] = out
    return done[key]


def _jax_variables(path):
    """{name: (dims, array)} of a JAX output file, without its dimension
    scales (HDF5 stores each dimension as a dataset)."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            if ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                continue
            dims = tuple(ds.dims[i][0].name.rsplit("/", 1)[-1]
                         for i in range(ds.ndim))
            out[name] = (dims, ds[()])
    return out


def _port_variables(path):
    with netcdf_file(path, "r", mmap=False) as f:
        dims = {n: v.dimensions for n, v in f.variables.items()}
    with ncio.NcReader(path) as nc:
        return {n: (dims[n], nc.read(n)) for n in nc.variables()}


def _is_broadband(name):
    return name.split("_")[0] in ("lw", "sw") and "_flux_" in name \
        and "_bnd_" not in name


@pytest.mark.parametrize("flags", list(FLAGS))
def test_cli_float64_matches_jax_cli(case, flags):
    ref_path = _run(case, "jax", FLAGS[flags], "float64")
    got_path = _run(case, "port", FLAGS[flags], "float64")
    ref, got = _jax_variables(ref_path), _port_variables(got_path)
    assert set(got) == set(ref)
    for name, (dims, b) in ref.items():
        gdims, a = got[name]
        assert gdims == dims and a.shape == b.shape, name
        floor = 0.0 if _is_broadband(name) else 1e-10 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=floor, err_msg=name)
    if flags == "optical":
        assert not any("_flux_" in n for n in got)
        assert {"lw_tau", "lay_source", "lev_source", "sfc_source"} <= set(got)
    else:
        assert check.compare(got_path, ref_path, verbose=False)
        assert check.compare(ref_path, got_path, verbose=False)
        assert check.self_consistency(got_path, verbose=False)


def test_cli_float32_within_crosscheck_gate(case):
    ref = _jax_variables(_run(case, "jax", FLAGS["broadband"], "float32"))
    got = _port_variables(_run(case, "port", FLAGS["broadband"], "float32"))
    fluxes = [n for n in ref if _is_broadband(n)]
    assert len(fluxes) == 7
    for name in fluxes:
        a, b = got[name][1], ref[name][1]
        assert a.dtype == b.dtype == np.float32, name
        assert np.abs(a.astype(np.float64) - b).max() <= F32_GATE_WM2, name


def test_checker_tells_cloud_from_clear(case):
    clear = _run(case, "port", ["--no-shortwave"], "float64")
    cloudy = _run(case, "port", FLAGS["broadband"], "float64")
    assert check.compare(clear, clear, verbose=False)
    assert not check.compare(clear, cloudy, verbose=False)
    assert check.main([cloudy, "--self-consistency"]) == 0


def _read_all(path, reader):
    with reader(path) as nc:
        return {n: nc.read(n) for n in nc.variables()}


def test_case_writers_match_jax(tmp_path):
    """``write_input_nc`` (clouds, aerosols, ray-tracing grid) and
    ``make_case_files`` give JAX's arrays, read back through both readers
    (the JAX writer's float32 dimension scales left out)."""
    d_j, d_p = tmp_path / "jax", tmp_path / "port"
    os.makedirs(d_j)
    jpaths = jinputs.make_case_files(str(d_j), "allsky", gpt_per_band=1)
    ppaths = inputs.make_case_files(str(d_p), "allsky", gpt_per_band=1)
    for name, make, mod in ((d_j / "rt.nc", jmake_atmosphere, jinputs),
                            (d_p / "rt.nc", make_atmosphere, inputs)):
        mod.write_input_nc(str(name), make(4, 6, seed=1), 2, 2,
                           with_aerosols=True, rt_grid=dict(nz=3, sza=0.4))
    jpaths["rt"], ppaths["rt"] = str(d_j / "rt.nc"), str(d_p / "rt.nc")
    assert set(jpaths) == set(ppaths)
    for kind in jpaths:
        ref = {n: v for n, v in _jax_variables(jpaths[kind]).items()}
        for reader in (JNcReader, ncio.NcReader):
            got = _read_all(ppaths[kind], reader)
            assert set(ref) <= set(got), kind
            assert set(got) - set(ref) <= {"x", "y", "z"}, kind
            for n, (_, b) in ref.items():
                np.testing.assert_array_equal(got[n], b, err_msg=f"{kind} {n}")


def test_cli_refuses_to_run_without_a_card(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(case[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--output", str(case[0] / "never.nc")])
    assert not os.path.exists(case[0] / "never.nc")


def test_cli_refuses_float64_on_the_card_before_reading(case, monkeypatch,
                                                       capsys):
    """float64 on the card is a valid request now (the wrappers take their
    plain twins there); the only refusal left is the missing card, and it
    comes before any file is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = []
    monkeypatch.setattr(cli, "NcReader",
                        lambda *a, **kw: opened.append(a) or 1 / 0)
    monkeypatch.setattr(cli.KDist, "from_netcdf",
                        lambda *a, **kw: opened.append(a) or 1 / 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--precision", "float64", "--device", "cuda"])
    assert not opened
    assert "--device cpu" not in capsys.readouterr().err


def test_rfmip_within_crosscheck_gate(tmp_path):
    kw = dict(n_experiments=2, n_sites=4, n_layers=12, gpt_per_band=2)
    ref = _read_all(jrfmip.run(str(tmp_path / "jax"), **kw), JNcReader)
    got = _read_all(rfmip.run(str(tmp_path / "port"), device="cpu", **kw),
                    ncio.NcReader)
    for name in ("rld", "rlu", "rsd", "rsu"):
        a, b = got[name], ref[name]
        assert a.shape == b.shape == (2, 13, 4) and a.dtype == np.float32
        assert np.isfinite(a).all() and a.min() >= 0
        assert np.abs(a.astype(np.float64) - b).max() <= F32_GATE_WM2, name


def test_cli_profiling_trace_and_summary(case, tmp_path, monkeypatch):
    """``--profiling`` traces one more solve of each spectrum and writes
    the chrome trace beside the output (the profiler is stubbed here: its
    start-up costs seconds on the CPU); the summary tool sums device
    intervals as a union and refuses a trace without device events."""
    import gzip
    import json
    import torch.profiler
    from rte_rrtmgp_torch.tools import trace_summary

    traced = []

    class FakeProfile:
        def __init__(self, activities):
            self.activities = activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            traced.append(self.activities)
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op",
                                            "name": "op", "ts": 0,
                                            "dur": 5}]}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    out = str(tmp_path / "p.nc")
    monkeypatch.chdir(case[0])
    assert cli.main(["--profiling", "--device", "cpu", "--output", out]) == 0
    assert traced == [[torch.profiler.ProfilerActivity.CPU]] * 2
    for label in ("longwave", "shortwave"):
        trace = str(tmp_path / f"p_{label}_trace.json")
        with pytest.raises(ValueError, match="no device events"):
            trace_summary.summarize(trace)
    fake = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "op", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 60, "dur": 10}]}
    path = str(tmp_path / "fake.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(fake, f)
    s = trace_summary.summarize(path)
    assert s["span_ms"] == 0.1 and s["device_busy_ms"] == 0.04
    assert s["top"][0] == ("k", 2, 0.03)


def test_no_fluxes_under_layer_major_runs_no_solver(case, monkeypatch,
                                                    tmp_path):
    """``--no-fluxes`` takes the optics-only exit where layer-major is
    chosen (JAX's predicate: layer-major only with fluxes): no solver
    runs, and the optical output equals the default layout's."""
    from rte_rrtmgp_torch.ops import rte_lw, rte_sw
    flags = ["--no-fluxes", "--output-optical", "--precision", "float64",
             "--device", "cpu"]
    monkeypatch.chdir(case[0])
    assert cli.main(flags + ["--output", str(tmp_path / "a.nc")]) == 0
    monkeypatch.setenv("RTE_RRTMGP_LAYERMAJOR", "1")
    calls = []
    for mod, names in ((rte_lw, ("lw_solver_noscat", "lw_solver_noscat_broadband",
                                 "lw_solver_noscat_broadband_lm")),
                       (rte_sw, ("sw_solver_2stream", "sw_solver_2stream_broadband",
                                 "sw_solver_2stream_broadband_lm",
                                 "sw_solver_2stream_fused_broadband",
                                 "sw_solver_2stream_fused_broadband_lm"))):
        for name in names:
            monkeypatch.setattr(mod, name,
                                lambda *a, _n=name, **kw: calls.append(_n))
    assert cli.main(flags + ["--output", str(tmp_path / "b.nc")]) == 0
    assert not calls
    a = _read_all(str(tmp_path / "a.nc"), ncio.NcReader)
    b = _read_all(str(tmp_path / "b.nc"), ncio.NcReader)
    assert set(a) == set(b) and "sw_tau" in a and "lw_tau" in a
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_check_inputs_false_skips_the_range_checks():
    from rte_rrtmgp_torch.data import synthetic
    from rte_rrtmgp_torch.models import KDist, RadiationSolverLW
    kd = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=1),
                        ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"],
                        dtype=torch.float64, device="cpu")
    atm = make_atmosphere(2, 6, seed=1)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], t_lev=atm["t_lev"],
              t_sfc=atm["t_sfc"] + 400.0, emis_sfc=np.full((2, kd.nbnd), 0.98))
    with pytest.raises(ValueError, match="t_sfc is out of range"):
        RadiationSolverLW(kd).solve(**kw)
    out = RadiationSolverLW(kd).solve(check_inputs=False, **kw)
    assert set(out) == {"lw_flux_up", "lw_flux_dn", "lw_flux_net"}
