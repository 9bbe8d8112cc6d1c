"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (marker ``gpu``; skipped inside the ``cuda`` fixture where there is no
card).  Run on a machine with an NVIDIA card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the shared conftest configures JAX, which these tests do
not use).  Tolerance: 1e-5 of each output's largest magnitude, for float32
sums over g taken in another order than the twin's."""

import numpy as np
import pytest
import torch

from rte_rrtmgp_torch.ops import kernels
from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as b1
from rte_rrtmgp_torch.ops.kernels import solvers as b23
from rte_rrtmgp_torch.ops import gas_optics as go, rte_lw, rte_sw

pytestmark = pytest.mark.gpu
REL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kernels.build()
    return torch.device("cuda")


def _assert_close(a, b, name):
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    assert err <= REL * scale, f"{name}: max abs err {err} > {REL} * {scale}"


@pytest.mark.parametrize("G", [12, 96, 128])
def test_lw_sweep(cuda, G):
    rng = np.random.default_rng(G)
    ncol, nlay = 17, 30
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    lev = rng.uniform(10, 120, (ncol, nlay + 1, G))
    args = [t(rng.uniform(0, 3, (ncol, nlay, G))),
            t(0.5 * (lev[:, 1:] + lev[:, :-1])), t(lev),
            t(rng.uniform(0.8, 1, (ncol, G))), t(rng.uniform(50, 150, (ncol, G))),
            t(rng.uniform(0.5, 2, (ncol, G))), t(np.zeros((ncol, G)))]
    got = b23.lw_sweep(*args, D=1.66, w=1.0)
    ref = rte_lw.lw_sweep_plain(*args, 1.66, 1.0)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        _assert_close(a, b, name)


@pytest.mark.parametrize("G", [12, 96, 128])
def test_sw_2stream(cuda, G):
    rng = np.random.default_rng(G + 1)
    ncol, nlay = 17, 30
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    args = [t(rng.uniform(0, 4, (ncol, nlay, G))), t(rng.uniform(0, 1, (ncol, nlay, G))),
            t(rng.uniform(0, 0.9, (ncol, nlay, G))), t(rng.uniform(0.1, 1, ncol)),
            t(rng.uniform(0, 0.5, (ncol, G))), t(rng.uniform(0, 0.5, (ncol, G))),
            t(rng.uniform(0, 100, (ncol, G)))]
    got = b23.sw_2stream(*args)
    ref = rte_sw.sw_2stream_plain(*args)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        _assert_close(a, b, name)


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_gas_optics_interp(cuda, longwave):
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.data import synthetic
    from rte_rrtmgp_torch.models.kdist import KDist
    gases = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
    kd = KDist.from_raw(synthetic.make_kdist_raw(longwave, gpt_per_band=4),
                        gases, device=cuda)
    atm = make_atmosphere(9, 20, seed=2)
    t = lambda a: torch.tensor(np.ascontiguousarray(a[:, ::-1]),
                               dtype=torch.float32, device=cuda)
    play, tlay = t(atm["p_lay"]), t(atm["t_lay"])
    vmr = t(atm["gas_concs"].materialize(gases, 9, 20))
    col_dry = go.get_col_dry(vmr[:, :, 0], t(atm["p_lev"]))
    col_gas = go.build_col_gas(vmr, col_dry)
    interp = go.interpolation(kd, play, tlay, col_gas)
    for g0, g1 in ((0, 36), (36, kd.ngpt)):
        kdc = kd.slice_gpt(g0, g1)
        sc = go.minor_scaling(kdc, interp, play, tlay, col_gas)
        got = b1.gas_optics_interp(kdc, interp, sc, rayleigh=not longwave)
        ref = go.majmin_plain(kdc, interp, sc, rayleigh=not longwave)
        for name, a, b in zip(("tau", "second"), got, ref):
            _assert_close(a, b, f"{name} [{g0}, {g1})")


def test_wrappers_refuse_float64_on_card(cuda):
    x = torch.zeros((2, 3, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        b23.lw_sweep(x, x, torch.zeros((2, 4, 4), dtype=torch.float64,
                                       device=cuda),
                     *[torch.zeros((2, 4), dtype=torch.float64, device=cuda)] * 4,
                     D=1.66, w=1.0)
