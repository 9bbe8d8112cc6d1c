"""The port's ray-tracing CLIs (``rte_rrtmgp_torch/cli_rt.py``,
``cli_rt_lite.py``), its TICA preprocessing and its synthetic Mie table
against the JAX package's, on the same input files (a 3 x 2 column case,
10 layers, 6 of them ray-traced, ``gpt_per_band=1``, written by the JAX
writers).

* ``cli_rt`` of both packages with the same flags: the same variables,
  dimensions and shapes; the two-stream fluxes within float32 rounding
  (rtol 1e-5 of each field's largest value); the Monte-Carlo fields'
  domain means within 4 sigma of the Monte-Carlo error (sigma from the
  spread of a few port seeds), ``rt_flux_tod_dn`` exactly.
* ``--tica --output-bnd-fluxes`` keeps the untilted grid and the by-band
  sums; ``--gpt-per-dispatch 5`` (windows of 2 of the 14 g-points) equals
  one window up to accumulation order; ``--cloud-mie`` on the port's
  synthetic Mie file.
* ``cli_rt_lite`` on a box cloud: the JAX CLI's variables, two-stream
  within float32 rounding of JAX's solver, energy closed, and the camera
  flag refused.
* ``tica_tilt`` equal to JAX's; ``make_mie_raw`` equal to JAX's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rte_rrtmgp_tpu import cli_rt as jcli_rt
from rte_rrtmgp_tpu.cases import inputs as jinputs
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jmake_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.tools import box_cloud as jbox
from rte_rrtmgp_tpu.tools import tica_tilt as jtica
from rte_rrtmgp_tpu.utils.ncio import NcReader as JNcReader

from rte_rrtmgp_torch import cli_rt, cli_rt_lite
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.tools import tica_tilt
from rte_rrtmgp_torch.utils import ncio

torch.set_num_threads(2)

NX, NY, NLAY, NZ = 3, 2, 10, 6
SINGLE = ["--raytracing", "16", "--two-stream", "--cloud-optics",
          "--delta-cloud", "--single-gpt", "5"]
TWO_STREAM = ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("rt_cli")
    atm = jmake_atmosphere(NX * NY, NLAY, seed=21)
    jinputs.write_input_nc(str(d / "rte_rrtmgp_input.nc"), atm, NX, NY,
                           rt_grid={"nz": NZ, "sza": 0.3})
    jinputs.write_input_nc(str(d / "one_column.nc"),
                           jmake_atmosphere(1, NLAY, seed=22), 1, 1,
                           rt_grid={"nz": NZ, "sza": 0.3, "ngrid_x": 1,
                                    "ngrid_y": 1})
    for lw, tag in ((True, "lw"), (False, "sw")):
        jsyn.write_kdist_nc(str(d / f"coefficients_{tag}.nc"),
                            jsyn.make_kdist_raw(lw, gpt_per_band=1))
        jsyn.write_cloud_nc(str(d / f"cloud_coefficients_{tag}.nc"),
                            jsyn.make_cloud_raw(lw))
    return d


def _run(d, main, argv, name):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert main(argv + ["--output", name]) == 0
    finally:
        os.chdir(cwd)
    return str(d / name)


def _read(path, reader):
    with reader(path) as nc:
        return {n: np.asarray(nc.read(n)) for n in nc.variables()
                if n not in ("x", "y", "z", "lev", "band_sw")}


def _within_mc(ref: dict, runs: list, n_sigma=4.0):
    """Each domain mean of ``ref`` within ``n_sigma`` of the Monte-Carlo
    error of one run, from the spread of ``runs`` (sigma * sqrt(1 + 1/n))."""
    n = len(runs)
    for name, r in ref.items():
        vals = np.array([x[name].mean() for x in runs])
        sigma = vals.std(ddof=1) * np.sqrt(1.0 + 1.0 / n)
        assert abs(r.mean() - vals.mean()) <= n_sigma * sigma \
            + 1e-6 * abs(r.mean()), (name, r.mean(), vals)


def test_cli_rt_matches_jax_cli(case):
    ref = _read(_run(case, jcli_rt.main, SINGLE, "jax.nc"), JNcReader)
    runs = [_read(_run(case, cli_rt.main, SINGLE + ["--device", "cpu",
                                                    "--seed", str(s)],
                       f"port{s}.nc"), ncio.NcReader) for s in range(4)]
    got = runs[0]
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
    with JNcReader(str(case / "jax.nc")) as a, \
            ncio.NcReader(str(case / "port0.nc")) as b:
        assert {n: a.dim(n) for n in ("x", "y", "z", "lev")} == \
            {n: b.dim(n) for n in ("x", "y", "z", "lev")}
    assert got["rt_flux_abs_dir"].shape == (NZ + 1, NY, NX)
    for name in TWO_STREAM:
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=1e-5 * np.abs(ref[name]).max(),
                                   err_msg=name)
    np.testing.assert_allclose(got["rt_flux_tod_dn"], ref["rt_flux_tod_dn"],
                               rtol=1e-5)
    _within_mc({n: v for n, v in ref.items() if n.startswith("rt_")
                and n != "rt_flux_tod_dn"}, runs)


def test_cli_rt_tica_keeps_grid_and_byband_sums(case):
    out = _read(_run(case, cli_rt.main, [
        "--device", "cpu", "--raytracing", "1", "--two-stream",
        "--cloud-optics", "--tica", "--output-bnd-fluxes", "--gpt-chunk",
        "8"], "tica.nc"), ncio.NcReader)
    sfc = out["rt_flux_sfc_dir"]
    assert sfc.shape == (NY, NX) and np.isfinite(sfc).all()
    assert out["rt_flux_abs_dir"].shape == (NZ + 1, NY, NX)
    assert out["sw_flux_dn"].shape == (NLAY + 1, NY, NX)
    assert np.isfinite(out["sw_flux_dn"]).all()
    assert out["rt_bnd_flux_sfc_dir"].shape == (14, NY, NX)
    np.testing.assert_allclose(out["rt_bnd_flux_sfc_dir"].sum(0), sfc,
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(out["sw_bnd_flux_dn"].sum(0),
                               out["sw_flux_dn"], rtol=2e-5, atol=1e-3)


def test_cli_rt_gpt_per_dispatch_equals_one_window(case):
    """Windows of 2 g-points (the largest divisor of 14 not above 5) chain
    the accumulators: equal to one window up to accumulation order (the
    lanes mode is held to the scan in ``test_torch_radiation_rt.py``).  One
    column, one photon a g-point: the full spectrum costs little."""
    base = ["--device", "cpu", "--raytracing", "1", "--independent-column",
            "--input", str(case / "one_column.nc")]
    one = _read(_run(case, cli_rt.main, base, "one.nc"), ncio.NcReader)
    win = _read(_run(case, cli_rt.main, base + ["--gpt-per-dispatch", "5"],
                     "win.nc"), ncio.NcReader)
    for name in one:
        np.testing.assert_allclose(win[name], one[name], rtol=2e-6,
                                   atol=1e-6 * np.abs(one[name]).max(),
                                   err_msg=name)


def test_cli_rt_cloud_mie_and_the_synthetic_table(case):
    raw, jraw = synthetic.make_mie_raw(nbnd=14), jsyn.make_mie_raw(nbnd=14)
    assert sorted(raw) == sorted(jraw)
    for k in raw:
        np.testing.assert_array_equal(raw[k], jraw[k], err_msg=k)
    synthetic.write_mie_nc(str(case / "mie.nc"), raw)
    with ncio.NcReader(str(case / "mie.nc")) as nc:
        np.testing.assert_array_equal(nc.read("phase_cdf_angle"),
                                      raw["phase_cdf_angle"])
    out = _read(_run(case, cli_rt.main, [
        "--device", "cpu", "--raytracing", "16", "--cloud-mie",
        "--liq-cloud-optics", "--mie-file", "mie.nc", "--single-gpt", "5"],
        "mie_out.nc"), ncio.NcReader)
    assert all(np.isfinite(v).all() for v in out.values())
    with JNcReader(str(case / "rte_rrtmgp_input.nc")) as nc:
        z = nc.read("z")
    toa = out["rt_flux_tod_dn"].mean()
    budget = (out["rt_flux_tod_up"].mean()
              + (out["rt_flux_sfc_dir"] + out["rt_flux_sfc_dif"]
                 - out["rt_flux_sfc_up"]).mean()
              + (out["rt_flux_abs_dir"] + out["rt_flux_abs_dif"])
              .mean(axis=(1, 2)).sum() * float(z[1] - z[0]))
    assert abs(budget - toa) / toa < 0.05, (budget, toa)
    with pytest.raises(SystemExit, match="liquid-only"):
        cli_rt.main(["--device", "cpu", "--cloud-mie", "--cloud-optics",
                     "--input", str(case / "rte_rrtmgp_input.nc")])


def test_cli_rt_refuses_to_run_without_a_card(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_rt.main(["--input", str(case / "never.nc")])


@pytest.fixture(scope="module")
def lite_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("rt_lite")
    jbox.write_rt_lite_input(str(d / "rt_lite_input.nc"), jbox.make_box_cloud(
        nx=8, ny=8, nz=4, tau_cloud=2.0, ngrid=(2, 4, 4)))
    return d


def test_cli_rt_lite(lite_case):
    """The port's rt_lite on a box cloud: the JAX CLI's variables, its
    two-stream fluxes equal to JAX's solver on the same columns (float32
    rounding), the incident flux exact, energy closed; the camera flag
    refused without a camera group in the input (its render is held in
    ``tests/test_torch_cli_bw.py``).  (The JAX CLI runs op by op: ~10 s
    here.)"""
    from rte_rrtmgp_tpu.ops import rte_sw as jrte_sw

    out = _read(_run(lite_case, cli_rt_lite.main, [
        "--raytracing", "8", "--two-stream", "--device", "cpu"], "port.nc"),
        ncio.NcReader)
    data = jbox.make_box_cloud(nx=8, ny=8, nz=4, tau_cloud=2.0)
    nz, ny, nx = data["tot_tau"].shape
    assert sorted(out) == sorted(
        ["flux_tod_dn", "flux_tod_up", "flux_sfc_dir", "flux_sfc_dif",
         "flux_sfc_up", "flux_abs_dir", "flux_abs_dif", *TWO_STREAM])
    to_col = lambda a: jnp.flip(jnp.asarray(a, jnp.float32).reshape(nz, -1).T,
                                axis=1)[:, :, None]
    mu0 = float(np.cos(data["sza"]))
    ncol = nx * ny
    alb = jnp.full((ncol, 1), data["albedo"][0, 0], jnp.float32)
    ref = jax.jit(jrte_sw.sw_solver_2stream)(
        to_col(data["tot_tau"]), to_col(data["tot_ssa"]),
        to_col(data["tot_asy"]), jnp.full((ncol,), mu0, jnp.float32), alb,
        alb, jnp.full((ncol, 1), data["tod_direct"], jnp.float32),
        jnp.full((ncol, 1), data["tod_diffuse"], jnp.float32))
    for name, r in zip(TWO_STREAM, ref):
        r = np.flip(np.asarray(r)[:, :, 0], axis=1).T.reshape(nz + 1, ny, nx)
        np.testing.assert_allclose(out[name], r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(out["flux_tod_dn"],
                               data["tod_direct"] * mu0 + data["tod_diffuse"],
                               rtol=1e-5)
    dz = float(data["z"][1] - data["z"][0])
    budget = (out["flux_tod_up"].mean()
              + (out["flux_sfc_dir"] + out["flux_sfc_dif"]
                 - out["flux_sfc_up"]).mean()
              + (out["flux_abs_dir"] + out["flux_abs_dif"])
              .mean(axis=(1, 2)).sum() * dz)
    toa = out["flux_tod_dn"].mean()
    assert abs(budget - toa) / toa < 0.03, (budget, toa)
    with pytest.raises(KeyError, match="camera-settings"):
        cli_rt_lite.main(["--bw-raytracing", "4", "--device", "cpu",
                          "--input", str(lite_case / "rt_lite_input.nc")])


def test_tica_tilt_matches_jax():
    rng = np.random.default_rng(3)
    nx, ny, nz, nlay = 3, 2, 6, 9
    ncol = nx * ny
    xh = np.arange(nx + 1) * 1000.0
    yh = np.arange(ny + 1) * 1000.0
    zh = np.arange(nz + 1) * 500.0
    z = 0.5 * (zh[1:] + zh[:-1])
    p_lev = np.sort(rng.uniform(1e3, 1e5, (ncol, nlay + 1)), axis=1)[:, ::-1]
    p_lay = 0.5 * (p_lev[:, 1:] + p_lev[:, :-1])
    t_lev = rng.uniform(200.0, 300.0, (ncol, nlay + 1))
    t_lay = 0.5 * (t_lev[:, 1:] + t_lev[:, :-1])
    fields = {"lwp": rng.uniform(0.0, 50.0, (ncol, nlay)),
              "rel": rng.uniform(5.0, 15.0, (ncol, nlay)),
              "vmr_h2o": rng.uniform(1e-3, 2e-2, (ncol, nlay))}
    args = (0.5, 0.7, nx, ny, xh, yh, zh, z, fields, p_lay, t_lay, p_lev,
            t_lev)
    ref = jtica.tica_tilt(*args)
    got = tica_tilt.tica_tilt(*args)
    assert got["path"] == ref["path"] and got["n_tilt"] == ref["n_tilt"]
    for k in ("p_lay", "t_lay", "p_lev", "t_lev", "zh_tilted"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)
    for k in fields:
        np.testing.assert_allclose(got["fields"][k], ref["fields"][k],
                                   rtol=1e-12, err_msg=k)
