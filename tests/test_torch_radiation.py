"""The port end to end on the CPU.

* The port's version of ``golden_case.solve_case`` (f64: LW clear and
  cloudy, SW all-sky with aerosols, delta-scaled) is held to the frozen
  goldens at the reference CI gate, 5.8e-2 W m-2.
* The port's flagship step in f32 is held to the JAX ``make_step`` in f32 at
  0.7 W m-2 (the crosscheck gate; f32 is never held to the f64 goldens).
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


def solve_case_port():
    """``golden_case.solve_case`` through the port, float64 on the CPU."""
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
                     **common)
    cloudy = lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"], emis_sfc=emis,
                      lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                      dei=atm["dei"], **common)
    for k in ("lw_flux_up", "lw_flux_dn"):
        out["clear_" + k] = clear[k].numpy()
        out["cloudy_" + k] = cloudy[k].numpy()
    sw = RadiationSolverSW(kd_sw, cl_sw, alut)
    swout = sw.solve(mu0=atm["mu0"], sfc_alb_dir=alb, sfc_alb_dif=alb,
                     lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                     dei=atm["dei"], rh=atm["rh"], aermr=atm["aermr"],
                     delta_cloud=True, delta_aerosol=True, **common)
    for k in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"):
        out["allsky_" + k] = swout[k].numpy()
    return out


def test_golden_case_within_gate():
    got = solve_case_port()
    worst = {}
    with NcReader(GOLDEN) as nc:
        for name, arr in got.items():
            ref = nc.read(name)
            assert ref.shape == arr.shape, name
            worst[name] = float(np.abs(arr - ref).max())
    report = ", ".join(f"{k}={v:.2e}" for k, v in sorted(worst.items()))
    assert max(worst.values()) <= golden_case.THRESHOLD_WM2, report


def test_flagship_step_f32_matches_jax():
    """8 columns x 16 layers, gpt_per_band=2, gpt_chunk=16: two spectral
    chunks in the LW (32 g-points) and the SW (28)."""
    ncol, nlay, chunk = 8, 16, 16
    tables = step.build_tables(2, dtype=torch.float32, device="cpu")
    arrs = step.atmos_arrays(ncol, nlay)
    jarrs = graft._atmos_arrays(ncol, nlay)
    for k in step.ARG_NAMES:
        np.testing.assert_array_equal(arrs[k], jarrs[k], err_msg=k)
    got = step.make_step(*tables, gpt_chunk=chunk)(
        *[arrs[k] for k in step.ARG_NAMES])
    jstep = jax.jit(graft.make_step(*graft._build(2), gpt_chunk=chunk))
    ref = jstep(*[jarrs[k] for k in step.ARG_NAMES])
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape == (ncol, nlay + 1), k
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= F32_GATE_WM2, (k, np.abs(a - b).max())


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


def test_lw_solver_options_match_jax(small_tables, tmp_path):
    kd, jkd = small_tables[True]
    jluts, _ = _jax_luts(tmp_path)
    clut = CloudLUT.from_raw(synthetic.make_cloud_raw(True),
                             dtype=torch.float64, device="cpu")
    atm = make_atmosphere(4, 8, seed=5)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], t_lev=atm["t_lev"],
              t_sfc=atm["t_sfc"], emis_sfc=np.full((4, kd.nbnd), 0.95),
              lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"],
              gpt_chunk=6, output_bnd_fluxes=True, n_gauss_angles=2,
              output_optical=True)
    got = RadiationSolverLW(kd, clut).solve(**kw)
    ref = JSolverLW(jkd, jluts[True]).solve(**kw)
    assert set(got) == set(ref)
    _close(got, ref, ref)


def test_sw_solver_options_match_jax(small_tables, tmp_path):
    kd, jkd = small_tables[False]
    jluts, jalut = _jax_luts(tmp_path)
    clut = CloudLUT.from_raw(synthetic.make_cloud_raw(False),
                             dtype=torch.float64, device="cpu")
    alut = AerosolLUT.from_raw(synthetic.make_aerosol_raw(),
                               dtype=torch.float64, device="cpu")
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
    got = RadiationSolverSW(kd, clut, alut).solve(**kw)
    ref = JSolverSW(jkd, jluts[False], jalut).solve(**kw)
    assert set(got) == set(ref)
    _close(got, ref, ref)
    assert float(got["sw_flux_dn"][2].abs().max()) == 0.0


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
