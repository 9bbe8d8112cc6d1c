"""The solvers' ``dtype=`` against the JAX package's (x64 on, as these tests
run it), on NumPy float64 inputs at the golden-case size (8 x 24).

* LW clear sky and SW clear sky, for the four combinations of the tables'
  dtype and ``dtype=``: the port's output dtype equals JAX's.  Its values
  match at rtol 1e-10 where JAX computes in float64 throughout (float32
  tables with ``dtype`` None solve in float64, as JAX does with x64;
  float64 tables with None); within 1e-5 of the largest value of the
  solve's fluxes where JAX's result is float32 (the two float32
  two-stream solves, each ~5e-5 of sw_flux_up's largest value from
  float64, differ by ~2e-5 of it); and at rtol 1e-7 (about one float32
  ulp, 6e-8) where float32 inputs meet float64 tables: there XLA on the
  CPU contracts a float32 ``a * b + c`` into one FMA under ``jit`` and its
  float32 ``log`` is not correctly rounded, while PyTorch rounds each
  operation (measured gaps 2.7e-8 in the LW, 2.4e-8 in the camera
  solver's gas planes).  JAX's SW refuses float64 tables with
  ``dtype=float32`` (its scan's carry changes dtype); the port promotes,
  returns float64 and is held to the float64 solve within 1e-3 W m-2.
* The tracers' defaults (float32) with float64 tables:
  ``RadiationSolverRT``'s gas planes against JAX's at rtol 1e-10, and its
  two-stream pass, which JAX's scan refuses there, within 1e-3 W m-2 of
  the float64 solve; ``RadiationSolverBW``'s gas-optics stage against
  JAX's at rtol 1e-7.
* The kernels' twin rule: a wrapper launches only when its operands are
  float32 on a card; any float64 operand takes the twin.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import golden_case
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models import KDist as JKDist
from rte_rrtmgp_tpu.models import RadiationSolverLW as JSolverLW
from rte_rrtmgp_tpu.models import RadiationSolverSW as JSolverSW
from rte_rrtmgp_tpu.models import radiation_bw as jrb
from rte_rrtmgp_tpu.models import radiation_rt as jrr
from rte_rrtmgp_tpu.ops import gas_optics as jgo

from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import (KDist, RadiationSolverLW,
                                     RadiationSolverSW)
from rte_rrtmgp_torch.models import radiation_bw as rb
from rte_rrtmgp_torch.models import radiation_rt as rr
from rte_rrtmgp_torch.models import raytracer_bw as bw
from rte_rrtmgp_torch.ops.kernels._checks import takes_twin

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
GASES = golden_case.GOLDEN_GASES
NCOL, NLAY = golden_case.NCOL, golden_case.NLAY
# (tables, dtype=): the four rows of the dtype rule.
ROWS = {"f32_tables_none": (F32, None), "f32_tables_f32": (F32, F32),
        "f64_tables_f32": (F64, F32), "f64_tables_none": (F64, None)}
NP = {F32: np.float32, F64: np.float64, None: None}
STEP_GAP_WM2 = 1e-3
MIXED_RTOL = 1e-7     # float32 inputs, float64 tables (module docstring)


@pytest.fixture(scope="module")
def tables():
    """{(longwave, torch dtype): (port KDist, JAX KDist)}."""
    out = {}
    for lw in (True, False):
        raw = synthetic.make_kdist_raw(lw, gpt_per_band=2)
        for dt in (F32, F64):
            out[lw, dt] = (
                KDist.from_raw(raw, GASES, dtype=dt, device="cpu"),
                JKDist.from_raw(jsyn.make_kdist_raw(lw, gpt_per_band=2),
                                GASES, dtype=NP[dt]))
    return out


@pytest.fixture(scope="module")
def atm():
    return make_atmosphere(NCOL, NLAY, seed=7)


def _solve(tables, atm, longwave, tdt, dt, jax_side):
    kd, jkd = tables[longwave, tdt]
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"])
    if longwave:
        kw.update(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
                  emis_sfc=np.full((NCOL, kd.nbnd), 0.98))
    else:
        alb = np.full((NCOL, kd.nbnd), 0.06)
        kw.update(mu0=atm["mu0"], sfc_alb_dir=alb, sfc_alb_dif=alb)
    if jax_side:
        cls = JSolverLW if longwave else JSolverSW
        return cls(jkd).solve(dtype=NP[dt], **kw)
    cls = RadiationSolverLW if longwave else RadiationSolverSW
    return cls(kd).solve(**({} if dt is None else dict(dtype=dt)), **kw)


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_solve_dtype_matches_jax(tables, atm, longwave, row):
    tdt, dt = ROWS[row]
    got = _solve(tables, atm, longwave, tdt, dt, jax_side=False)
    if not longwave and row == "f64_tables_f32":
        with pytest.raises(TypeError, match="carry"):
            _solve(tables, atm, longwave, tdt, dt, jax_side=True)
        ref = _solve(tables, atm, longwave, F64, None, jax_side=True)
        for k, v in ref.items():
            assert got[k].dtype == F64, k
            gap = np.abs(got[k].numpy() - np.asarray(v)).max()
            assert gap <= STEP_GAP_WM2, (k, gap)
        return
    ref = _solve(tables, atm, longwave, tdt, dt, jax_side=True)
    assert set(got) == set(ref)
    top = max(np.abs(np.asarray(v)).max() for v in ref.values())
    for k, v in ref.items():
        b = np.asarray(v)
        assert got[k].numpy().dtype == b.dtype, k
        if b.dtype == np.float64:
            rtol = MIXED_RTOL if row == "f64_tables_f32" else 1e-10
            np.testing.assert_allclose(got[k].numpy(), b, rtol=rtol,
                                       atol=0.0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), b, rtol=0.0,
                                       atol=1e-5 * top, err_msg=k)


# ---- the tracers' defaults with float64 tables ----
NY, NX, NZ, RT_NLAY = 2, 3, 6, 12


def _rt_args(atm_rt, nbnd, **kw):
    ncol = NY * NX
    return dict(gas_concs=atm_rt["gas_concs"], p_lay=atm_rt["p_lay"],
                p_lev=atm_rt["p_lev"], t_lay=atm_rt["t_lay"],
                mu0=np.full(ncol, 0.8), azi=np.full(ncol, 0.3),
                sfc_alb_dir=np.full((ncol, nbnd), 0.06),
                sfc_alb_dif=np.full((ncol, nbnd), 0.08),
                grid_cells=(NZ, NY, NX), grid_d=(500.0, 1000.0, 1000.0),
                kn_grid=(2, 2, 3), photons_per_pixel=4, **kw)


def test_rt_default_dtype_matches_jax(tables, monkeypatch):
    """float32 (the default) inputs with float64 tables: the gas planes
    equal JAX's; the two-stream pass, which JAX's scan refuses there,
    returns float64 within 1e-3 W m-2 of the float64 solve."""
    kd, jkd = tables[False, F64]
    atm_rt = make_atmosphere(NY * NX, RT_NLAY, seed=5)
    kw = _rt_args(atm_rt, kd.nbnd, raytracing=False, twostream=True)
    with pytest.raises(TypeError, match="carry"):
        jrr.RadiationSolverRT(jkd).solve(**kw)
    ref = jrr.RadiationSolverRT(jkd).solve(dtype=np.float64, **kw)
    got = rr.RadiationSolverRT(kd).solve(**kw)
    for name in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"):
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == F64, name
        assert np.abs(a.numpy() - b).max() <= STEP_GAP_WM2, name

    planes = lambda mod: monkeypatch.setattr(mod, "_solve_rt_impl",
                                             functools.partial(
                                                 mod._solve_rt_impl,
                                                 return_gas_planes=True))
    planes(jrr)
    planes(rr)
    kw = _rt_args(atm_rt, kd.nbnd)
    ref = jrr.RadiationSolverRT(jkd).solve(**kw)
    got = rr.RadiationSolverRT(kd).solve(**kw)
    for name, a, b in zip(("tau", "ssa"), got, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype == np.float64, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-300,
                                   err_msg=name)


class _Stop(Exception):
    pass


def test_bw_gas_planes_default_dtype_match_jax(tables, monkeypatch):
    """The camera solver's gas-optics stage with float64 tables and the
    default float32: the port's planes against those JAX's solve computes
    (recorded from inside its compiled gas optics), each solve stopped
    after them."""
    kd, jkd = tables[False, F64]
    atm_bw = make_atmosphere(NY * NX, 8, seed=5)
    kw = dict(gas_concs=atm_bw["gas_concs"], p_lay=atm_bw["p_lay"],
              p_lev=atm_bw["p_lev"], t_lay=atm_bw["t_lay"],
              mu0=np.full(NY * NX, 0.7), azi=np.full(NY * NX, 0.4),
              sfc_alb=np.full((NY * NX, kd.nbnd), 0.15),
              land_use_map=np.zeros(NY * NX), grid_cells=(4, NY, NX),
              grid_d=(3750.0, 1000.0, 1000.0), kn_grid=(2, 2, 2),
              z_lev=np.asarray(atm_bw["z_lev"]), mode="broadband")
    rec = []
    combine = jgo.combine_abs_and_rayleigh

    def record(t, r):
        out = combine(t, r)
        jax.debug.callback(lambda a, b: rec.append((np.asarray(a),
                                                    np.asarray(b))),
                           *out[:2])
        return out

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(jgo, "combine_abs_and_rayleigh", record)
    monkeypatch.setattr(jrb, "spectral_weights", stop)
    with pytest.raises(_Stop):
        jrb.RadiationSolverBW(jkd).solve(
            camera=jrb.rbw.Camera(cam_type=2, nx=3, ny=2), **kw)
    jax.effects_barrier()      # the callbacks run with the dispatch
    got, planes = [], rb.gas_planes
    monkeypatch.setattr(rb, "gas_planes",
                        lambda *a: (got.append(planes(*a)), stop()))
    with pytest.raises(_Stop):
        rb.RadiationSolverBW(kd).solve(camera=bw.Camera(cam_type=2, nx=3,
                                                        ny=2), **kw)
    (tau, ssa), = got
    ref = [np.concatenate([r[i][:, ::-1] for r in rec], -1)
           for i in range(2)]
    for name, a, b in zip(("tau", "ssa"), (tau, ssa), ref):
        assert a.numpy().dtype == b.dtype == np.float64, name
        np.testing.assert_allclose(a.numpy(), b, rtol=MIXED_RTOL,
                                   atol=1e-300, err_msg=name)


def test_twin_rule_takes_any_float64_operand():
    """On a card (the meta device stands in here) float32 operands go to
    the kernel; one float64 operand, or the first on the CPU, takes the
    twin; ``None`` operands are skipped."""
    meta = lambda dt: torch.empty(2, dtype=dt, device="meta")
    assert not takes_twin(meta(F32), meta(F32), None)
    assert takes_twin(meta(F32), None, meta(F64))
    assert takes_twin(meta(F64))
    assert takes_twin(torch.empty(2, dtype=F32), meta(F32))
