"""The port differentiates on the CPU, as the JAX package does
(``tests/test_autodiff.py``): gradients of fluxes with respect to the
atmospheric state flow through gas optics, the solvers and the flux sums
of the plain PyTorch path (the CUDA kernels have no backward and refuse a
float32 input that requires grad; ``test_torch_kernels_gpu.py``).

The two quantities of ``test_autodiff.py`` at 3 columns x 10 layers in
float64: d(OLR)/d(t_sfc) through the LW no-scattering solve, and
d(surface SW down)/d(scaling of the absorber columns) through the SW
two-stream solve.  Each is held to central finite differences of the
port's own function at JAX's tolerances, and to JAX's gradient (one
``jax.grad`` of both quantities, under ``jax.jit``) at rtol 1e-9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rte_rrtmgp_tpu.ops import fluxes as jflux, gas_optics as jgas
from rte_rrtmgp_tpu.ops import rte_lw as jlw, rte_sw as jsw
from helpers import atmos_inputs, small_atmos, small_kdist

from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import KDist
from rte_rrtmgp_torch.ops import fluxes as flux_ops, gas_optics as gas_ops
from rte_rrtmgp_torch.ops import rte_lw, rte_sw

torch.set_num_threads(2)
F64 = torch.float64
MU0 = 0.7


@pytest.fixture(scope="module")
def case():
    jkd_lw, jkd_sw = small_kdist(longwave=True), small_kdist(longwave=False)
    atm = small_atmos(ncol=3, nlay=10, seed=7)
    vmr, col_dry = atmos_inputs(jkd_lw, atm)
    port_kd = lambda lw: KDist.from_raw(
        synthetic.make_kdist_raw(lw, seed=0, gpt_per_band=4),
        jkd_lw.gas_names, dtype=F64, device="cpu")
    flip = lambda a: np.ascontiguousarray(np.flip(np.asarray(a), axis=1))
    arrs = dict(p_lay=flip(atm["p_lay"]), p_lev=flip(atm["p_lev"]),
                t_lay=flip(atm["t_lay"]), t_lev=flip(atm["t_lev"]),
                vmr=flip(vmr), col_dry=flip(col_dry),
                t_sfc=np.asarray(atm["t_sfc"], np.float64))
    return dict(jkd=(jkd_lw, jkd_sw), kd=(port_kd(True), port_kd(False)),
                arrs=arrs)


def _olr(kd, a, t_sfc):
    """TOA upward LW flux summed over the columns, as a function of the
    surface temperature (top-first inputs)."""
    t = lambda k: torch.from_numpy(a[k])
    op, src = gas_ops.gas_optics_lw(
        kd, t("p_lay"), t("p_lev"), t("t_lay"), t("t_lev"), t_sfc, t("vmr"),
        t("col_dry"), sfc_lay=a["p_lay"].shape[1] - 1)
    ncol, ngpt = src.sfc_src.shape
    emis = torch.full((ncol, ngpt), 0.98, dtype=F64)
    up, _, _ = rte_lw.lw_solver_noscat(
        op.tau, src.lay_src, src.lev_src, emis, src.sfc_src,
        src.sfc_src_jac, torch.zeros((ncol, ngpt), dtype=F64), 1)
    return flux_ops.sum_broadband(up)[:, 0].sum()


def _sfc_dn(kd, a, scale):
    """Surface SW down summed over the columns, as a function of a scaling
    of every absorber's volume mixing ratio."""
    t = lambda k: torch.from_numpy(a[k])
    op, toa = gas_ops.gas_optics_sw(kd, t("p_lay"), t("p_lev"), t("t_lay"),
                                    t("vmr") * scale, t("col_dry"))
    ncol, ngpt = toa.shape
    alb = torch.full((ncol, ngpt), 0.1, dtype=F64)
    mu0 = torch.full((ncol,), MU0, dtype=F64)
    _, dn, _ = rte_sw.sw_solver_2stream(op.tau, op.ssa, op.g, mu0, alb, alb,
                                        toa)
    return flux_ops.sum_broadband(dn)[:, -1].sum()


def _jax_grads(case):
    """JAX's gradients of both quantities: one jax.grad, under jax.jit, of
    their sum (the OLR does not depend on the scaling, the SW flux not on
    the surface temperature)."""
    jkd_lw, jkd_sw = case["jkd"]
    a = {k: jnp.asarray(v) for k, v in case["arrs"].items()}

    def total(t_sfc, scale):
        op, src = jgas.gas_optics_lw(
            jkd_lw, a["p_lay"], a["p_lev"], a["t_lay"], a["t_lev"], t_sfc,
            a["vmr"], a["col_dry"], sfc_lay=a["p_lay"].shape[1] - 1)
        ncol, ngpt = src.sfc_src.shape
        emis = jnp.full((ncol, ngpt), 0.98, op.tau.dtype)
        up, _, _ = jlw.lw_solver_noscat(
            op.tau, src.lay_src, src.lev_src, emis, src.sfc_src,
            src.sfc_src_jac, jnp.zeros((ncol, ngpt), op.tau.dtype), 1)
        olr = jflux.sum_broadband(up)[:, 0].sum()
        op, toa = jgas.gas_optics_sw(jkd_sw, a["p_lay"], a["p_lev"],
                                     a["t_lay"], a["vmr"] * scale,
                                     a["col_dry"])
        alb = jnp.full(toa.shape, 0.1, op.tau.dtype)
        _, dn, _ = jsw.sw_solver_2stream(
            op.tau, op.ssa, op.g, jnp.full((toa.shape[0],), MU0), alb, alb,
            toa)
        return olr + jflux.sum_broadband(dn)[:, -1].sum()

    g_t, g_s = jax.jit(jax.grad(total, argnums=(0, 1)))(a["t_sfc"], 1.0)
    return np.asarray(g_t), float(g_s)


@pytest.fixture(scope="module")
def jax_grads(case):
    return _jax_grads(case)


def test_lw_gradient_wrt_tsfc(case, jax_grads):
    kd, a = case["kd"][0], case["arrs"]
    t_sfc = torch.from_numpy(a["t_sfc"].copy()).requires_grad_()
    g, = torch.autograd.grad(_olr(kd, a, t_sfc), t_sfc)
    eps = 1e-3
    e0 = torch.zeros_like(t_sfc.detach())
    e0[0] = eps
    with torch.no_grad():
        fd = (_olr(kd, a, t_sfc + e0) - _olr(kd, a, t_sfc - e0)) / (2 * eps)
    assert torch.isfinite(g).all()
    assert float(g[0]) > 0   # a warmer surface emits more to space
    np.testing.assert_allclose(float(g[0]), float(fd), rtol=5e-4)
    np.testing.assert_allclose(g.numpy(), jax_grads[0], rtol=1e-9)


def test_sw_gradient_wrt_absorber_scaling(case, jax_grads):
    kd, a = case["kd"][1], case["arrs"]
    scale = torch.tensor(1.0, dtype=F64, requires_grad=True)
    g, = torch.autograd.grad(_sfc_dn(kd, a, scale), scale)
    eps = 1e-4
    with torch.no_grad():
        fd = (_sfc_dn(kd, a, 1.0 + eps) - _sfc_dn(kd, a, 1.0 - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    assert float(g) < 0   # more absorber, less sunlight at the surface
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)
    np.testing.assert_allclose(float(g), jax_grads[1], rtol=1e-9)
