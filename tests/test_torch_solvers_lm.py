"""The port's layer-major solvers vs the JAX package, float64 on the CPU.

The plain twins of the layer-major solver kernels (``lw_sweep_lm``,
``sw_2stream_lm``), through ``lw_solver_noscat_broadband_lm`` and
``sw_solver_2stream_broadband_lm``, against JAX's
``lw_solver_noscat(...).sum(-1)`` and ``sw_solver_2stream(...).sum(-1)`` on
the same inputs in layer-major order (the reference
``tests/test_pallas_layergrid.py`` uses): ncol 13, not a multiple of 8; one
and three Gauss angles; with and without a diffuse incident flux.  rtol
1e-10 (order of float64 sums).
"""

import numpy as np
import pytest
import torch

import jax
from rte_rrtmgp_tpu.ops import rte_lw as jlw
from rte_rrtmgp_tpu.ops import rte_sw as jsw

from rte_rrtmgp_torch.ops import rte_lw, rte_sw

torch.set_num_threads(2)

RTOL = 1e-10
NCOL, NLAY, G = 13, 9, 12


def close(a, b, name=""):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=0.0,
                               err_msg=name)


def _lm(a):
    """(ncol, n, G) -> (n*ncol, G) with cell (c, l) at row l*ncol + c."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (1, 0, 2)).reshape(-1, a.shape[2])))


@pytest.mark.parametrize("n_angles", [1, 3])
def test_lw_sweep_lm_twin_matches_jax(n_angles):
    rng = np.random.default_rng(31)
    tau = rng.uniform(0.0, 3.0, (NCOL, NLAY, G))
    tau[0, :, :3] = 0.0                                  # transparent
    tau[1, :, 3:6] = rng.uniform(0.0, 1e-3, (NLAY, 3))   # series branch
    lev = rng.uniform(10.0, 120.0, (NCOL, NLAY + 1, G))
    lay = 0.5 * (lev[:, 1:] + lev[:, :-1]) * rng.uniform(0.9, 1.1,
                                                         (NCOL, NLAY, G))
    sfc = [rng.uniform(lo, hi, (NCOL, G)) for lo, hi in
           ((0.8, 1.0), (50.0, 150.0), (0.5, 2.0), (0.0, 5.0))]
    lev_lm = _lm(lev)
    pieces = (lev_lm[:NCOL], lev_lm[NCOL:NLAY * NCOL], lev_lm[NLAY * NCOL:])
    got = rte_lw.lw_solver_noscat_broadband_lm(
        _lm(tau), _lm(lay), pieces, *map(torch.from_numpy, sfc), ncol=NCOL,
        n_gauss_angles=n_angles)
    ref = jax.jit(jlw.lw_solver_noscat, static_argnames=("n_gauss_angles",))(
        tau, lay, lev, *sfc, n_gauss_angles=n_angles)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        close(a, np.asarray(b).sum(-1), name)


@pytest.mark.parametrize("with_dif", [False, True], ids=["no_dif", "dif"])
def test_sw_2stream_lm_twin_matches_jax(with_dif):
    rng = np.random.default_rng(32)
    tau = rng.uniform(0.0, 4.0, (NCOL, NLAY, G))
    tau[2, :, :4] = 0.0
    ssa = rng.uniform(0.0, 1.0, (NCOL, NLAY, G))
    ssa[4] = 1.0                                         # conservative
    g = rng.uniform(0.0, 0.9, (NCOL, NLAY, G))
    mu0 = rng.uniform(0.05, 1.0, NCOL)
    sfc = [rng.uniform(0.0, hi, (NCOL, G)) for hi in (0.5, 0.5, 100.0)]
    inc_dif = 0.3 * sfc[2] if with_dif else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = rte_sw.sw_solver_2stream_broadband_lm(
        _lm(tau), _lm(ssa), _lm(g), t(mu0), *map(t, sfc), t(inc_dif),
        ncol=NCOL)
    ref = jax.jit(jsw.sw_solver_2stream)(tau, ssa, g, mu0, *sfc, inc_dif)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        close(a, np.asarray(b).sum(-1), name)
