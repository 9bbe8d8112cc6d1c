"""The port's 3D forward ray-traced solver (``rte_rrtmgp_torch/models/
radiation_rt.py``) against the JAX package's, on the same NumPy inputs
(a 3 x 4 column domain, 10 layers, 6 of them ray-traced, clouds and
aerosols).

* Deterministic, float64 at rtol 1e-10: pass 1's two-stream fluxes,
  broadband and by band (with an absolute floor of 1e-10 of each array's
  largest value for the by-band arrays, as ``tests/test_torch_radiation.py``:
  1 - exp(-tau) cancels at tiny tau), and the gas (tau, ssa) planes pass 1
  returns (``return_gas_planes``).
* Monte-Carlo, statistical (port only): clear-sky MC against the
  two-stream surface fluxes within 5% (domain means, total and direct,
  as ``tests/test_radiation_rt.py``) and energy closure within 2%; the
  TOD extra cell's shape and values; by-band sums against broadband;
  windows (``gpt_per_dispatch``) equal to one window and the ``lanes``
  mode equal to the scan, up to accumulation order.
"""

import functools

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models import AerosolLUT as JAerosolLUT
from rte_rrtmgp_tpu.models import CloudLUT as JCloudLUT
from rte_rrtmgp_tpu.models import KDist as JKDist
from rte_rrtmgp_tpu.models import radiation_rt as jrr

from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import AerosolLUT, CloudLUT, KDist
from rte_rrtmgp_torch.models import radiation_rt as rr
from rte_rrtmgp_torch.models import raytracer as rt

torch.set_num_threads(2)

NY, NX, NZ, NLAY = 3, 4, 6, 10
DZ = 500.0
GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
F64 = torch.float64


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("rt")
    raw = synthetic.make_kdist_raw(False, gpt_per_band=1)
    jsyn.write_cloud_nc(str(d / "c.nc"), jsyn.make_cloud_raw(False))
    jsyn.write_aerosol_nc(str(d / "a.nc"), jsyn.make_aerosol_raw())
    jax_tables = (JKDist.from_raw(raw, GASES, dtype=np.float64),
                  JCloudLUT.from_netcdf(str(d / "c.nc"), dtype=np.float64),
                  JAerosolLUT.from_netcdf(str(d / "a.nc"), dtype=np.float64))
    port_tables = (
        KDist.from_raw(raw, GASES, dtype=F64, device="cpu"),
        CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=F64,
                          device="cpu"),
        AerosolLUT.from_raw(synthetic.make_aerosol_raw(), dtype=F64,
                            device="cpu"))
    atm = make_atmosphere(NY * NX, NLAY, seed=5)
    return jax_tables, port_tables, atm


def _args(atm, nbnd, clouds=True, aerosols=True, **kw):
    ncol = NY * NX
    args = dict(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(ncol, 0.8), azi=np.full(ncol, 0.3),
        sfc_alb_dir=np.full((ncol, nbnd), 0.06),
        sfc_alb_dif=np.full((ncol, nbnd), 0.08),
        grid_cells=(NZ, NY, NX), grid_d=(DZ, 1000.0, 1000.0),
        kn_grid=(2, 3, 2), photons_per_pixel=16)
    if clouds:
        args.update(lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                    dei=atm["dei"], delta_cloud=True)
    if aerosols:
        args.update(rh=atm["rh"], aermr=atm["aermr"], delta_aerosol=True)
    args.update(kw)
    return args


def test_twostream_pass_matches_jax(case):
    (jkd, jcl, jal), (kd, cl, al), atm = case
    kw = _args(atm, kd.nbnd, raytracing=False, twostream=True,
               output_bnd_fluxes=True)
    ref = jrr.RadiationSolverRT(jkd, jcl, jal).solve(dtype=np.float64, **kw)
    got = rr.RadiationSolverRT(kd, cl, al).solve(dtype=F64, **kw)
    for name in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir",
                 "sw_bnd_flux_up", "sw_bnd_flux_dn", "sw_bnd_flux_dn_dir"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        floor = 1e-10 * np.abs(b).max() if "bnd" in name else 0.0
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=floor, err_msg=name)
    for name in ("rt_flux_tod_dn", "rt_flux_abs_dir"):
        assert not getattr(got, name).any()
    assert got.rt_flux_abs_dir.shape == (NZ + 1, NY, NX)


def test_gas_planes_match_jax(case, monkeypatch):
    (jkd, jcl, jal), (kd, cl, al), atm = case
    monkeypatch.setattr(jrr, "_solve_rt_impl", functools.partial(
        jrr._solve_rt_impl, return_gas_planes=True))
    monkeypatch.setattr(rr, "_solve_rt_impl", functools.partial(
        rr._solve_rt_impl, return_gas_planes=True))
    kw = _args(atm, kd.nbnd, gpt_chunk=5)
    ref = jrr.RadiationSolverRT(jkd, jcl, jal).solve(dtype=np.float64, **kw)
    got = rr.RadiationSolverRT(kd, cl, al).solve(dtype=F64, **kw)
    for name, a, b in zip(("tau", "ssa"), got, ref):
        assert a.shape == (NY * NX, NLAY, kd.ngpt), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-300, err_msg=name)


def _closure(out):
    toa = float(out.rt_flux_tod_dn.mean())
    tod_up = float(out.rt_flux_tod_up.mean())
    sfc = float((out.rt_flux_sfc_dir + out.rt_flux_sfc_dif
                 - out.rt_flux_sfc_up).mean())
    atm = float((out.rt_flux_abs_dir + out.rt_flux_abs_dif)
                .mean(dim=(1, 2)).sum() * DZ)
    return (tod_up + sfc + atm - toa) / toa


@pytest.mark.parametrize("gpt", [3, 9])
def test_clear_sky_mc_matches_twostream(case, gpt):
    """One g-point each (the full spectrum costs seconds a g-point here)."""
    _, (kd, cl, al), atm = case
    out = rr.RadiationSolverRT(kd).solve(
        **_args(atm, kd.nbnd, clouds=False, aerosols=False, twostream=True,
                single_gpt=gpt, photons_per_pixel=256, dtype=F64))
    toa = float(kd.solar_source[gpt - 1]) * 0.8
    np.testing.assert_allclose(out.rt_flux_tod_dn.numpy(), toa, rtol=1e-5)
    mc_sfc = float((out.rt_flux_sfc_dir + out.rt_flux_sfc_dif).mean())
    ts_sfc = float(out.sw_flux_dn[:, 0].mean())
    assert abs(mc_sfc - ts_sfc) / ts_sfc < 0.05, (mc_sfc, ts_sfc)
    mc_dir = float(out.rt_flux_sfc_dir.mean())
    ts_dir = float(out.sw_flux_dn_dir[:, 0].mean())
    assert abs(mc_dir - ts_dir) / ts_dir < 0.05, (mc_dir, ts_dir)
    assert abs(_closure(out)) < 0.02, _closure(out)


def test_tod_extra_cell(case, monkeypatch):
    """The cell above the domain integrates every above-domain layer: its
    extinction times dz is the layers' summed optical depth and its
    scattering the summed scattering optical depth, while the domain's
    cells keep their own; without layers above the domain there is no
    extra cell."""
    _, (kd, _, _), atm = case
    seen = []
    trace = rt.trace_rays
    monkeypatch.setattr(rt, "trace_rays", lambda *a, **kw: (
        seen.append(a), trace(*a, **kw))[1])
    solver = rr.RadiationSolverRT(kd)
    kw = _args(atm, kd.nbnd, clouds=False, aerosols=False, single_gpt=4,
               photons_per_pixel=4, dtype=F64)
    out = solver.solve(**kw)
    assert out.rt_flux_abs_dir.shape == (NZ + 1, NY, NX)
    k_ext, k_sca_gas = seen[0][1:3]
    assert k_ext.shape == (NZ + 1, NY, NX)
    monkeypatch.setattr(rr, "_solve_rt_impl", functools.partial(
        rr._solve_rt_impl, return_gas_planes=True))
    tau, ssa = (p[:, :, 0] for p in solver.solve(**kw))
    to3d = lambda q: q.T.reshape(-1, NY, NX)
    np.testing.assert_allclose((k_ext * DZ).numpy(), torch.cat(
        [to3d(tau[:, :NZ]), to3d(tau[:, NZ:].sum(1, keepdim=True))]).numpy(),
        rtol=1e-12)
    sca = tau * ssa
    np.testing.assert_allclose((k_sca_gas * DZ).numpy(), torch.cat(
        [to3d(sca[:, :NZ]), to3d(sca[:, NZ:].sum(1, keepdim=True))]).numpy(),
        rtol=1e-10)
    monkeypatch.undo()
    monkeypatch.setattr(rt, "trace_rays", lambda *a, **kw: (
        seen.append(a), trace(*a, **kw))[1])
    out = solver.solve(**dict(kw, grid_cells=(NLAY, NY, NX)))
    assert seen[-1][1].shape == (NLAY, NY, NX)
    assert out.rt_flux_abs_dir.shape == (NLAY, NY, NX)


@pytest.fixture(scope="module")
def window_case(case):
    """Four g-points of four bands (the first four of the k-distribution),
    clouds and aerosols, by-band output."""
    _, (kd, cl, al), atm = case
    solver = rr.RadiationSolverRT(kd.slice_gpt(0, 4), cl, al)
    kw = _args(atm, 4, output_bnd_fluxes=True, photons_per_pixel=8, seed=3,
               dtype=F64)
    return solver, kw, solver.solve(**kw)


def test_byband_sums_equal_broadband(window_case):
    _, _, out = window_case
    for name in ("tod_dn", "tod_up", "sfc_dir", "sfc_dif", "sfc_up"):
        bb = getattr(out, f"rt_flux_{name}")
        bnd = getattr(out, f"rt_bnd_flux_{name}")
        assert bnd.shape == (4, NY, NX)
        np.testing.assert_allclose(bnd.sum(0).numpy(), bb.numpy(),
                                   rtol=1e-12, atol=1e-12 * float(bb.max()))
    assert bool((out.rt_bnd_flux_tod_dn > 0).all())
    assert abs(_closure(out)) < 0.05


@pytest.mark.parametrize("mode", [dict(gpt_per_dispatch=3),
                                  dict(spectral_mode="lanes"),
                                  dict(spectral_mode="lanes",
                                       gpt_per_dispatch=2)])
def test_windows_and_lanes_equal_one_scan(window_case, mode):
    """Each g-point traces the stream of seed + igpt in every mode, so the
    modes agree up to accumulation order (3 -> windows of 2)."""
    solver, kw, ref = window_case
    got = solver.solve(**kw, **mode)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()),
                                   err_msg=name)
