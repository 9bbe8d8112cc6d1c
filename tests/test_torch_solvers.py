"""Port RTE solvers vs the JAX package, in float64 on the CPU.

On CPU tensors the broadband entry points take the plain twins of the LW
sweep and SW two-stream kernels; the JAX side runs its XLA solvers.
Inputs come from a NumPy seed; G = 12 is deliberately not a multiple of
32, and the SW case has night columns (mu0 <= 0, run with the safe mu0 the
radiation layer passes).  Tolerance: rtol 1e-10 (order of float64 sums).
Three intermediates, the two-stream r_dif, r_dir and t_dir, also get an
absolute floor of 1e-10 times their largest magnitude: where tau is tiny,
1 - exp(-2*k*tau) and the direct-beam differences cancel, and the last-bit
difference between the two libraries' float64 exp grows to ~1e-9 relative
in those elements.  The broadband and per-g-point fluxes need no floor."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rte_rrtmgp_tpu.ops import rte_lw as jlw
from rte_rrtmgp_tpu.ops import rte_sw as jsw

from rte_rrtmgp_torch.ops import rte_lw, rte_sw

torch.set_num_threads(2)

RTOL = 1e-10
NCOL, NLAY, G = 5, 9, 12


def close(a, b, name="", floor=False):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                               atol=RTOL * np.abs(b).max() if floor else 0.0,
                               err_msg=name)


@pytest.fixture(scope="module")
def lw_inputs():
    rng = np.random.default_rng(21)
    tau = rng.uniform(0.0, 3.0, (NCOL, NLAY, G))
    tau[0, :, :3] = 0.0                   # transparent
    tau[1, :, 3:6] = rng.uniform(0.0, 1e-3, (NLAY, 3))  # series branch
    lev = rng.uniform(10.0, 120.0, (NCOL, NLAY + 1, G))
    lay = 0.5 * (lev[:, 1:] + lev[:, :-1]) * rng.uniform(0.9, 1.1, (NCOL, NLAY, G))
    arrs = dict(tau=tau, lay_src=lay, lev_src=lev,
                sfc_emis=rng.uniform(0.8, 1.0, (NCOL, G)),
                sfc_src=rng.uniform(50.0, 150.0, (NCOL, G)),
                sfc_src_jac=rng.uniform(0.5, 2.0, (NCOL, G)),
                inc_flux=rng.uniform(0.0, 5.0, (NCOL, G)))
    return arrs


@pytest.fixture(scope="module")
def sw_inputs():
    rng = np.random.default_rng(22)
    mu0 = rng.uniform(0.05, 1.0, NCOL)
    mu0[1] = -0.3                         # night columns
    mu0[3] = 0.0
    arrs = dict(tau=rng.uniform(0.0, 4.0, (NCOL, NLAY, G)),
                ssa=rng.uniform(0.0, 1.0, (NCOL, NLAY, G)),
                g=rng.uniform(0.0, 0.9, (NCOL, NLAY, G)),
                mu0=np.where(mu0 > 0.0, mu0, 1.0),
                sfc_alb_dir=rng.uniform(0.0, 0.5, (NCOL, G)),
                sfc_alb_dif=rng.uniform(0.0, 0.5, (NCOL, G)),
                inc_flux_dir=rng.uniform(0.0, 100.0, (NCOL, G)),
                inc_flux_dif=rng.uniform(0.0, 5.0, (NCOL, G)))
    arrs["tau"][2, :, :4] = 0.0
    arrs["ssa"][4, :, :] = 1.0            # conservative scattering
    return arrs


def _both(arrs):
    return ({k: torch.from_numpy(v) for k, v in arrs.items()},
            {k: jnp.asarray(v) for k, v in arrs.items()})


@pytest.mark.parametrize("n_angles", [1, 4])
def test_lw_broadband_twin(lw_inputs, n_angles):
    t, j = _both(lw_inputs)
    got = rte_lw.lw_solver_noscat_broadband(**t, n_gauss_angles=n_angles)
    ref = jlw.lw_solver_noscat_broadband(**j, n_gauss_angles=n_angles)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        close(a, b, name)


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_lw_per_gpoint(lw_inputs, n_angles):
    t, j = _both(lw_inputs)
    got = rte_lw.lw_solver_noscat(**t, n_gauss_angles=n_angles)
    ref = jlw.lw_solver_noscat(**j, n_gauss_angles=n_angles)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        close(a, b, name)


def test_two_stream_coeffs(sw_inputs):
    t, j = _both(sw_inputs)
    got = rte_sw.two_stream_coeffs(t["tau"], t["ssa"], t["g"], t["mu0"])
    ref = jsw.two_stream_coeffs(j["tau"], j["ssa"], j["g"], j["mu0"])
    for name, a, b in zip(("r_dif", "t_dif", "r_dir", "t_dir", "t_noscat"),
                          got, ref):
        close(a, b, name, floor=name in ("r_dif", "r_dir", "t_dir"))


@pytest.mark.parametrize("with_dif", [False, True], ids=["no_dif", "dif"])
def test_sw_broadband_twin(sw_inputs, with_dif):
    t, j = _both(sw_inputs)
    if not with_dif:
        t["inc_flux_dif"] = j["inc_flux_dif"] = None
    got = rte_sw.sw_solver_2stream_broadband(**t)
    ref = jsw.sw_solver_2stream_broadband(**j)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        close(a, b, name)


def test_sw_per_gpoint(sw_inputs):
    t, j = _both(sw_inputs)
    got = rte_sw.sw_solver_2stream(**t)
    ref = jsw.sw_solver_2stream(**j)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        close(a, b, name)
