"""The plain reference against the program's plain twins on the CPU at a
tiny size (8 columns x 12 layers, 2 g-points a band), and the control
(the reference in bfloat16) failing the limits a tiny run holds."""

import numpy as np
import pytest
import torch

from benchmark.inputs import atmosphere, tables
from benchmark.reference import rrtmgp
from benchmark.tests.tiny import TINY_LIMITS

NCOL, NLAY, GPB, SEED = 8, 12, 2, 2 ** 31 + 99
LW = ("lw_flux_up", "lw_flux_dn", "lw_flux_net")
SW = ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir", "sw_flux_net")
# The step's options in the configurations' float32.
F32 = {"delta_cloud": True, "guard_dtype": torch.float32}


def _raws(seed=SEED):
    return {"kd_lw": tables.make_kdist_raw(True, seed, gpt_per_band=GPB),
            "kd_sw": tables.make_kdist_raw(False, seed, gpt_per_band=GPB),
            "cloud_lw": tables.make_cloud_raw(True, seed),
            "cloud_sw": tables.make_cloud_raw(False, seed)}


def _program_tables(raws, dtype):
    from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
    from rte_rrtmgp_torch.models.kdist import KDist

    return (KDist.from_raw(raws["kd_lw"], atmosphere.GASES, dtype=dtype,
                           device="cpu"),
            KDist.from_raw(raws["kd_sw"], atmosphere.GASES, dtype=dtype,
                           device="cpu"),
            CloudLUT.from_raw(raws["cloud_lw"], dtype=dtype, device="cpu"),
            CloudLUT.from_raw(raws["cloud_sw"], dtype=dtype, device="cpu"))


def _step(raws, arr, dtype):
    from rte_rrtmgp_torch import step

    tabs = _program_tables(raws, dtype)
    assert tabs[0].gas_names == atmosphere.GASES
    run = step.make_step(*tabs, gpt_chunk=8 * GPB)
    out = run(*[arr[k] for k in step.ARG_NAMES])
    return {k: v.double().numpy() for k, v in out.items()}


def _gap(a, b, keys):
    return max(float(np.abs(a[k] - b[k]).max()) for k in keys)


def test_reference_equals_float64_program_with_its_guards():
    """In float64 with float64 guards the reference and the program's
    float64 step compute the same thing: equal to rounding (the LW
    Gauss angle is rounded to float32 in the reference)."""
    raws = _raws()
    arr = atmosphere.step_arrays(
        atmosphere.make_atmosphere(NCOL, NLAY, SEED), np.float64)
    got = _step(raws, arr, torch.float64)
    ref = rrtmgp.fluxes(rrtmgp.Tables(raws, atmosphere.GASES), arr,
                        delta_cloud=True, guard_dtype=torch.float64)
    assert _gap(got, ref, LW) < 1e-5
    assert _gap(got, ref, SW) < 1e-9


@pytest.mark.parametrize("seed", [SEED, 5, 2 ** 33 + 1])
def test_float32_step_within_tiny_limits(seed):
    raws = _raws(seed)
    arr = atmosphere.step_arrays(atmosphere.make_atmosphere(NCOL, NLAY, seed))
    got = _step(raws, arr, torch.float32)
    ref = rrtmgp.outputs(raws, dict(arr, gases=atmosphere.GASES), F32, "cpu")
    assert _gap(got, ref, LW) < TINY_LIMITS["lw_flux_err_wm2"]
    assert _gap(got, ref, SW) < TINY_LIMITS["sw_flux_err_wm2"]


def test_float32_solver_classes_within_tiny_limits():
    from rte_rrtmgp_torch.models.gas_concs import GasConcs
    from rte_rrtmgp_torch.models.radiation import (RadiationSolverLW,
                                                   RadiationSolverSW)

    raws = _raws()
    atm = atmosphere.make_atmosphere(NCOL, NLAY, SEED)
    kd_lw, kd_sw, cl_lw, cl_sw = _program_tables(raws, torch.float32)
    gas = GasConcs()
    for g in atmosphere.GASES:
        gas.set_vmr(g, atm["vmr"][g])
    f = {k: np.asarray(atm[k], np.float32) for k in
         ("p_lay", "p_lev", "t_lay", "t_lev", "t_sfc", "lwp", "iwp", "rel",
          "dei", "mu0")}
    clouds = {k: f[k] for k in ("lwp", "iwp", "rel", "dei")}
    emis = np.full((NCOL, 16), 0.98, np.float32)
    alb = np.full((NCOL, 14), 0.06, np.float32)
    lw = RadiationSolverLW(kd_lw, cl_lw).solve(
        gas, f["p_lay"], f["p_lev"], f["t_lay"], f["t_lev"], f["t_sfc"],
        emis, **clouds)
    sw = RadiationSolverSW(kd_sw, cl_sw).solve(
        gas, f["p_lay"], f["p_lev"], f["t_lay"], f["mu0"], alb, alb,
        **clouds)
    got = {k: v.double().numpy() for k, v in {**lw, **sw}.items()}
    inp = dict(f, emis_sfc=emis, sfc_alb_dir=alb, sfc_alb_dif=alb,
               tsi_scaling=np.ones(NCOL, np.float32), col_dry=None,
               vmr=atmosphere.vmr_field(atm["vmr"], NCOL, NLAY),
               gases=atmosphere.GASES)
    ref = rrtmgp.outputs(raws, inp, dict(F32, delta_cloud=False), "cpu")
    assert _gap(got, ref, LW) < TINY_LIMITS["lw_flux_err_wm2"]
    assert _gap(got, ref, SW) < TINY_LIMITS["sw_flux_err_wm2"]


@pytest.mark.parametrize("seed", [SEED, 5, 2 ** 33 + 1])
def test_bfloat16_control_fails(seed):
    """The control, the reference in the nearest precision below the
    configuration's float32, is not correct by the tiny run's limits
    (each of its two numbers read 3 to 40 W m-2)."""
    raws = _raws(seed)
    arr = atmosphere.step_arrays(atmosphere.make_atmosphere(NCOL, NLAY, seed))
    arr["gases"] = atmosphere.GASES
    ref = rrtmgp.outputs(raws, arr, F32, "cpu")
    ctl = rrtmgp.outputs(raws, arr, F32, "cpu", dtype=torch.bfloat16)
    assert _gap(ctl, ref, LW) > 10 * TINY_LIMITS["lw_flux_err_wm2"]
    assert _gap(ctl, ref, SW) > 10 * TINY_LIMITS["sw_flux_err_wm2"]


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    from benchmark.tests.tiny import REPO

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.rrtmgp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "rte_rrtmgp_torch" not in out and "rte_rrtmgp_tpu" not in out
