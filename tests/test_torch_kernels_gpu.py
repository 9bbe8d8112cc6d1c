"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (marker ``gpu``; skipped inside the ``cuda`` fixture where there is no
card).  Run on a machine with an NVIDIA card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the shared conftest configures JAX, which these tests do
not use).  Tolerance: 1e-5 of each output's largest magnitude, for float32
sums over g taken in another order than the twin's.  Also on the card:
float64 through the twins (the golden case within its 5.8e-2 W m-2 gate,
no launch), the forward and camera tracers against the CPU (statistical),
``cli_rt`` and ``cli_bw`` with their gas-optics launch counts, the
camera solver in float64 through the twins (no launch), the gradient guard
(a float32 input that requires grad raises; float64 differentiates as on
the CPU), B1-B3 launched on ``cuda:1`` while ``cuda:0`` is current (skipped
with fewer than two cards), and the step sharded on a mesh that lists the
card 4 times."""

import json
import os

import numpy as np
import pytest
import torch

from rte_rrtmgp_torch.ops import kernels
from rte_rrtmgp_torch.ops.kernels import gas_optics_interp as b1
from rte_rrtmgp_torch.ops.kernels import interp_rows as b45
from rte_rrtmgp_torch.ops.kernels import solvers as b23
from rte_rrtmgp_torch.ops import gas_optics as go, rte_lw, rte_sw
from rte_rrtmgp_torch import cli, cli_bw, cli_rt, step
from rte_rrtmgp_torch.cases import inputs
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import (AerosolLUT, CloudLUT, KDist,
                                     RadiationSolverLW, RadiationSolverSW,
                                     raytracer, raytracer_bw)
from rte_rrtmgp_torch.models.radiation_bw import RadiationSolverBW
from rte_rrtmgp_torch.tools import set_virtual_camera
from rte_rrtmgp_torch.utils import ncio, tuner

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


def _sw_args(cuda, rng, ncol, nlay, G, lm):
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    plane = (lambda a: _lm(t(a))) if lm else t
    return [plane(rng.uniform(0, 4, (ncol, nlay, G))),
            plane(rng.uniform(0, 1, (ncol, nlay, G))),
            plane(rng.uniform(0, 0.9, (ncol, nlay, G))),
            t(rng.uniform(0.1, 1, ncol)), t(rng.uniform(0, 0.5, (ncol, G))),
            t(rng.uniform(0, 0.5, (ncol, G))), t(rng.uniform(0, 100, (ncol, G))),
            t(rng.uniform(0, 5, (ncol, G)))]


def _sw_check(args, ncol, lm):
    if lm:
        got = b23.sw_2stream_lm(*args, ncol=ncol)
        ref = rte_sw.sw_2stream_lm_plain(*args, ncol=ncol)
    else:
        got = b23.sw_2stream(*args)
        ref = rte_sw.sw_2stream_plain(*args)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        _assert_close(a, b, name)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("G", [12, 13, 96, 128])
def test_sw_2stream_tiles(cuda, monkeypatch, G, tile, lm):
    """Every g-tile width (clusters of 1-4 blocks a column), an ncol that is
    no multiple of anything, G not a multiple of 4 (4-byte copies, ragged
    level sums), both layouts."""
    monkeypatch.setattr(b23, "SW_TILE", tile)
    ncol, nlay = 19, 72
    _sw_check(_sw_args(cuda, np.random.default_rng(G + tile), ncol, nlay, G,
                       lm), ncol, lm)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("nlay", [1, 450])
@pytest.mark.parametrize("G", [12, 96])
def test_sw_2stream_depths(cuda, G, nlay, lm):
    """One layer, and enough layers (450 at tile 32) to take the
    global-scratch branch."""
    ncol = 5
    geo = b23.sw_geometry(ncol, nlay, G)
    assert geo.branch == ("global" if nlay == 450 else "shared")
    _sw_check(_sw_args(cuda, np.random.default_rng(nlay + G), ncol, nlay, G,
                       lm), ncol, lm)


def _gas_case(cuda, longwave, ncol=9, nlay=20, gpt_per_band=4):
    """k-distribution and an ncol x nlay atmosphere on the card."""
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere
    from rte_rrtmgp_torch.data import synthetic
    from rte_rrtmgp_torch.models.kdist import KDist
    gases = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
    kd = KDist.from_raw(synthetic.make_kdist_raw(longwave,
                                                 gpt_per_band=gpt_per_band),
                        gases, device=cuda)
    atm = make_atmosphere(ncol, nlay, seed=2)
    t = lambda a: torch.tensor(np.ascontiguousarray(a[:, ::-1]),
                               dtype=torch.float32, device=cuda)
    play, tlay = t(atm["p_lay"]), t(atm["t_lay"])
    vmr = t(atm["gas_concs"].materialize(gases, ncol, nlay))
    col_dry = go.get_col_dry(vmr[:, :, 0], t(atm["p_lev"]))
    col_gas = go.build_col_gas(vmr, col_dry)
    interp = go.interpolation(kd, play, tlay, col_gas)
    return kd, interp, play, tlay, col_gas, col_dry


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_gas_optics_interp(cuda, longwave):
    kd, interp, play, tlay, col_gas, _ = _gas_case(cuda, longwave)
    for g0, g1 in ((0, 36), (36, kd.ngpt)):
        kdc = kd.slice_gpt(g0, g1)
        sc = go.minor_scaling(kdc, interp, play, tlay, col_gas)
        got = b1.gas_optics_interp(kdc, interp, sc, rayleigh=not longwave)
        ref = go.majmin_plain(kdc, interp, sc, rayleigh=not longwave)
        for name, a, b in zip(("tau", "second"), got, ref):
            _assert_close(a, b, f"{name} [{g0}, {g1})")


def _exact(a, b, name):
    err = float((a - b).abs().max())
    assert err == 0.0, f"{name}: max abs err {err}, expected bit-equal"


@pytest.mark.parametrize("tile", [8, 32, 64])
@pytest.mark.parametrize("order", ["cm", "lm"])
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_gas_optics_interp_exact(cuda, monkeypatch, longwave, order, tile):
    """B1 bit-equal to its twin: chunks with minor intervals ([0, 12),
    [0, 96)) and without ([128, 224)), G = 12 and 96, a chunk view starting
    off a 16-byte boundary with a ragged tail ([2, 15): the scalar path),
    37 x 20 cells (no multiple of the tile), in column-major and
    layer-major cell order."""
    monkeypatch.setattr(b1, "TILE_CELLS", tile)
    kd, interp, play, tlay, col_gas, _ = _gas_case(cuda, longwave, 37, 20,
                                                   gpt_per_band=16)
    if order == "lm":
        interp, play, tlay, col_gas = map(go.layer_major,
                                          (interp, play, tlay, col_gas))
    for g0, g1 in ((0, 12), (0, 96), (128, 224), (2, 15)):
        kdc = kd.slice_gpt(g0, g1)
        sc = go.minor_scaling(kdc, interp, play, tlay, col_gas)
        got = b1.gas_optics_interp(kdc, interp, sc, rayleigh=not longwave)
        ref = go.majmin_plain(kdc, interp, sc, rayleigh=not longwave)
        for name, a, b in zip(("tau", "second"), got, ref):
            _exact(a, b, f"{name} [{g0}, {g1}) minor="
                         f"{len(go.minor_specs(kdc))}")


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_interp_rows_multi(cuda, longwave):
    """B4: kmajor + planck (LW) or kmajor + krayl (SW) over shared planes,
    on a chunk view of the tables (strided rows)."""
    kd, interp, *_ = _gas_case(cuda, longwave)
    kdc = kd.slice_gpt(36, kd.ngpt)
    rows, jes, fms, fp, cms = go._fused_inputs(kdc, interp, True)
    second = (kdc.planck_rows, rows) if longwave else (
        kdc.krayl_rows, go._ray_rows(kdc, interp))
    args = ([kdc.kmajor_rows, second[0]], [rows, second[1]], jes, fms, fp,
            [cms, None])
    got = b45.interp_rows_multi(*args)
    ref = go.interp_rows_plain(*args)
    for name, a, b in zip(("tau", "second"), got, ref):
        _assert_close(a, b, name)


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_interp_rows_minor(cuda, longwave):
    """B5 over the minor contributor axis (CT not a multiple of 32)."""
    kd, interp, play, tlay, col_gas, _ = _gas_case(cuda, longwave)
    tbl, rows, flav, _, _, _, CT = go._minor_prep(kd, interp, play, tlay,
                                                  col_gas)
    F = kd.nflav
    plane = lambda x, c: x[:, :, c * F:(c + 1) * F].index_select(
        2, flav).reshape(-1, CT)
    jes = tuple(plane(interp.jeta0, i) for i in range(2))
    fms = tuple(plane(interp.fminor, c) for c in range(4))
    _assert_close(b45.interp_rows(tbl, rows, jes, fms),
                  go.interp_rows_plain([tbl], [rows], jes, fms, None,
                                       [None])[0], f"minor CT={CT}")


def test_tau_major_on_card_launches_interp_rows(cuda):
    """The single-quantity gas-optics functions dispatch by device: on CUDA
    tensors tau_major launches the weight-plane kernel, and agrees with the
    plain body."""
    kd, interp, *_ = _gas_case(cuda, True)
    kernels.reset_launch_counts()
    tau = go.tau_major(kd, interp)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["interp_rows"] == 1
    _assert_close(tau, go._interp3d_rows(kd, kd.kmajor_rows, interp, True),
                  "tau_major")


def _lm(a):
    return a.transpose(0, 1).reshape(-1, a.shape[2]).contiguous()


@pytest.mark.parametrize("G", [12, 96, 128])
def test_lw_sweep_lm(cuda, G):
    rng = np.random.default_rng(G + 2)
    ncol, nlay = 17, 30
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    lev = rng.uniform(10, 120, (ncol, nlay + 1, G))
    lev_lm = _lm(t(lev))
    pieces = (lev_lm[:ncol], lev_lm[ncol:nlay * ncol], lev_lm[nlay * ncol:])
    args = [_lm(t(rng.uniform(0, 3, (ncol, nlay, G)))),
            _lm(t(0.5 * (lev[:, 1:] + lev[:, :-1]))), pieces,
            t(rng.uniform(0.8, 1, (ncol, G))), t(rng.uniform(50, 150, (ncol, G))),
            t(rng.uniform(0.5, 2, (ncol, G))), t(rng.uniform(0, 5, (ncol, G)))]
    got = b23.lw_sweep_lm(*args, ncol=ncol, D=1.66, w=1.0)
    ref = rte_lw.lw_sweep_lm_plain(*args, ncol, 1.66, 1.0)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        _assert_close(a, b, name)


def _lw_args(cuda, rng, ncol, nlay, G, lm, thin=False):
    """LW sweep inputs, column-major or layer-major (level source in its
    three pieces).  ``thin``: a third of tau zero and a third below the
    series switch (tau*D < tau_thres)."""
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    lev = rng.uniform(10, 120, (ncol, nlay + 1, G))
    tau = rng.uniform(0, 3, (ncol, nlay, G))
    if thin:
        pick = rng.integers(0, 3, tau.shape)
        tau = np.where(pick == 0, 0.0,
                       np.where(pick == 1, rng.uniform(0, 4e-3, tau.shape), tau))
    planes = [t(tau), t(0.5 * (lev[:, 1:] + lev[:, :-1])), t(lev)]
    if lm:
        planes = [_lm(planes[0]), _lm(planes[1]), _lm(planes[2])]
        lev_lm = planes[2]
        planes[2] = (lev_lm[:ncol], lev_lm[ncol:nlay * ncol],
                     lev_lm[nlay * ncol:])
    return planes + [t(rng.uniform(0.8, 1, (ncol, G))),
                     t(rng.uniform(50, 150, (ncol, G))),
                     t(rng.uniform(0.5, 2, (ncol, G))),
                     t(rng.uniform(0, 5, (ncol, G)))]


def _lw_check(args, ncol, lm, D=1.66, w=1.0):
    if lm:
        got = b23.lw_sweep_lm(*args, ncol=ncol, D=D, w=w)
        ref = rte_lw.lw_sweep_lm_plain(*args, ncol, D, w)
    else:
        got = b23.lw_sweep(*args, D=D, w=w)
        ref = rte_lw.lw_sweep_plain(*args, D, w)
    for name, a, b in zip(("up", "dn", "jac"), got, ref):
        _assert_close(a, b, name)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("gb", [32, 64, 128])
@pytest.mark.parametrize("G", [12, 13, 96, 128, 256])
def test_lw_sweep_shapes(cuda, monkeypatch, G, gb, lm):
    """G with a ragged g tail and not a multiple of 4, blocks of 32, 64 and
    128 g-points (a column's cluster of 1 to 8 blocks), nlay 37 (a ragged
    chunk of layers), ncol 19, both layouts."""
    monkeypatch.setattr(b23, "LW_BLOCK_G", gb)
    ncol, nlay = 19, 37
    _lw_check(_lw_args(cuda, np.random.default_rng(G + gb), ncol, nlay, G,
                       lm), ncol, lm)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("G, nlay, branch", [
    (13, 1, "shared"), (128, 1, "shared"), (128, 300, "global"),
    (256, 72, "shared"), (256, 300, "global"), (1024, 40, "shared"),
    (1024, 230, "global")])
def test_lw_sweep_depths(cuda, G, nlay, branch, lm):
    """One layer, the flagship depth at the whole LW k-distribution's 256
    g-points, and columns deep enough to take the device-scratch branch."""
    ncol = 5
    assert b23.lw_geometry(ncol, nlay, G).branch == branch
    _lw_check(_lw_args(cuda, np.random.default_rng(nlay + G), ncol, nlay, G,
                       lm), ncol, lm)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("angle", [0, 1, 2])
def test_lw_sweep_thin_layers_and_angles(cuda, angle, lm):
    """tau = 0 and tau below the series switch in one chunk, at the D and w
    of each angle of a three-angle Gauss quadrature."""
    ncol, nlay, G = 11, 72, 128
    D = float(rte_lw.GAUSS_DS[2, angle])
    w = float(rte_lw.GAUSS_WTS[2, angle])
    _lw_check(_lw_args(cuda, np.random.default_rng(angle), ncol, nlay, G, lm,
                       thin=True), ncol, lm, D, w)


@pytest.mark.parametrize("G", [12, 96, 128])
def test_sw_2stream_lm(cuda, G):
    rng = np.random.default_rng(G + 3)
    ncol, nlay = 17, 30
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    args = [_lm(t(rng.uniform(0, 4, (ncol, nlay, G)))),
            _lm(t(rng.uniform(0, 1, (ncol, nlay, G)))),
            _lm(t(rng.uniform(0, 0.9, (ncol, nlay, G)))),
            t(rng.uniform(0.1, 1, ncol)), t(rng.uniform(0, 0.5, (ncol, G))),
            t(rng.uniform(0, 0.5, (ncol, G))), t(rng.uniform(0, 100, (ncol, G))),
            t(rng.uniform(0, 5, (ncol, G)))]
    got = b23.sw_2stream_lm(*args, ncol=ncol)
    ref = rte_sw.sw_2stream_lm_plain(*args, ncol=ncol)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        _assert_close(a, b, name)


def test_wrappers_take_twins_for_float64_on_card(cuda):
    """float64 on the card takes the plain twins (the JAX package's dtype
    rule) and counts no launch; a dtype the kernels do not take still
    raises."""
    rng = np.random.default_rng(5)
    t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=cuda)
    ncol, nlay, G = 2, 3, 4
    lw = [t(rng.uniform(0, 2, (ncol, nlay, G))),
          t(rng.uniform(0, 5, (ncol, nlay, G))),
          t(rng.uniform(0, 5, (ncol, nlay + 1, G)))] + [
        t(rng.uniform(0.5, 1, (ncol, G))) for _ in range(4)]
    sw = [t(rng.uniform(0, 2, (nlay * ncol, G))),
          t(rng.uniform(0, 1, (nlay * ncol, G))),
          t(rng.uniform(0, 0.9, (nlay * ncol, G))),
          t(rng.uniform(0.1, 1, ncol))] + [
        t(rng.uniform(0, 0.5, (ncol, G))) for _ in range(3)]
    je = torch.zeros((6, G), dtype=torch.int32, device=cuda)
    rows = [t(rng.uniform(0, 1, (3, 5, G))),
            torch.zeros((6, 2), dtype=torch.int32, device=cuda), (je, je),
            tuple(t(rng.uniform(0, 1, (6, G))) for _ in range(4))]
    kernels.reset_launch_counts()
    got = (b23.lw_sweep(*lw, D=1.66, w=1.0), b23.sw_2stream_lm(*sw, ncol=ncol),
           (b45.interp_rows(*rows),))
    assert not any(kernels.launch_counts().values())
    ref = (rte_lw.lw_sweep_plain(*lw, 1.66, 1.0),
           rte_sw.sw_2stream_lm_plain(*sw, ncol=ncol),
           (go.interp_rows_plain([rows[0]], [rows[1]], *rows[2:], None,
                                 [None])[0],))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == torch.float64 and a.device.type == "cuda"
            assert torch.equal(a, b)
    with pytest.raises(TypeError):
        b23.lw_sweep(*[x.half() for x in lw], D=1.66, w=1.0)
    with pytest.raises(ValueError):
        b23.lw_sweep(lw[0].float(), *[x.float().cpu() for x in lw[1:]],
                     D=1.66, w=1.0)


def _b123_against_twins(dev):
    """B1 (LW and SW), B2 and B3 launched on tensors on ``dev``, each held
    to its twin; returns the launch counts."""
    kernels.reset_launch_counts()
    for longwave in (True, False):
        kd, interp, play, tlay, col_gas, _ = _gas_case(dev, longwave)
        sc = go.minor_scaling(kd, interp, play, tlay, col_gas)
        got = b1.gas_optics_interp(kd, interp, sc, rayleigh=not longwave)
        ref = go.majmin_plain(kd, interp, sc, rayleigh=not longwave)
        for name, a, b in zip(("tau", "second"), got, ref):
            assert a.device == dev
            _assert_close(a, b, f"B1 {name} longwave={longwave}")
    rng = np.random.default_rng(11)
    lw = _lw_args(dev, rng, 9, 20, 96, False)
    for name, a, b in zip(("up", "dn", "jac"),
                          b23.lw_sweep(*lw, D=1.66, w=1.0),
                          rte_lw.lw_sweep_plain(*lw, 1.66, 1.0)):
        assert a.device == dev
        _assert_close(a, b, f"B2 {name}")
    sw = _sw_args(dev, rng, 9, 20, 96, False)
    for name, a, b in zip(("up", "dn", "dir"), b23.sw_2stream(*sw),
                          rte_sw.sw_2stream_plain(*sw)):
        assert a.device == dev
        _assert_close(a, b, f"B3 {name}")
    torch.cuda.synchronize(dev)
    return kernels.launch_counts()


@pytest.fixture(scope="module")
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    return torch.device("cuda", 1)


def test_kernels_launch_on_their_tensors_device(second_card):
    """B1-B3 on tensors on cuda:1 while cuda:0 is the current device."""
    with torch.cuda.device(0):
        counts = _b123_against_twins(second_card)
        assert torch.cuda.current_device() == 0
    assert counts["gas_optics_interp"] == 2
    assert counts["lw_sweep"] == counts["sw_2stream"] == 1


def test_float32_input_requiring_grad_raises(cuda):
    """The kernels have no backward: a float32 CUDA input that requires
    grad raises while grad mode is on, and runs under no_grad."""
    rng = np.random.default_rng(3)
    lw = _lw_args(cuda, rng, 5, 7, 12, False)
    sw = _sw_args(cuda, rng, 5, 7, 12, False)
    lw[4].requires_grad_()
    sw[1].requires_grad_()
    with pytest.raises(RuntimeError, match="lw_sweep.*no backward"):
        b23.lw_sweep(*lw, D=1.66, w=1.0)
    with pytest.raises(RuntimeError, match="sw_2stream.*no backward"):
        b23.sw_2stream(*sw)
    with torch.no_grad():
        b23.lw_sweep(*lw, D=1.66, w=1.0)
        b23.sw_2stream(*sw)
    kd, interp, play, tlay, col_gas, _ = _gas_case(cuda, True)
    sc = go.minor_scaling(kd, interp, play, tlay, col_gas).requires_grad_()
    with pytest.raises(RuntimeError, match="gas_optics_interp"):
        b1.gas_optics_interp(kd, interp, sc, rayleigh=False)
    rows, jes, fms, fp, cms = go._fused_inputs(kd, interp, True)
    fms = [f.clone().requires_grad_() for f in fms]
    with pytest.raises(RuntimeError, match="interp_rows"):
        b45.interp_rows(kd.kmajor_rows, rows, jes, fms, fp, cms)
    # the flagship step: t_sfc reaches the LW sweep's surface source
    tables = step.build_tables(2, dtype=torch.float32, device=cuda)
    arrs = step.atmos_arrays(8, 20)
    args = [torch.as_tensor(arrs[k], device=cuda) for k in step.ARG_NAMES]
    args[4].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        step.make_step(*tables)(*args)


def test_float64_gradient_on_card_matches_cpu(cuda):
    """float64 takes the twins on the card and differentiates: d(TOA LW up
    + surface SW down)/d(t_sfc, mu0) of the step equals the CPU's within
    1e-10 relative."""
    arrs = step.atmos_arrays(8, 20, dtype=np.float64)
    grads = {}
    for dev in ("cpu", cuda):
        tables = step.build_tables(2, dtype=torch.float64, device=dev)
        args = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
        t_sfc, mu0 = args[4].requires_grad_(), args[11].requires_grad_()
        kernels.reset_launch_counts()
        out = step.make_step(*tables)(*args)
        loss = out["lw_flux_up"][:, -1].sum() + out["sw_flux_dn"][:, 0].sum()
        grads[str(dev)] = [g.cpu() for g in
                           torch.autograd.grad(loss, (t_sfc, mu0))]
        assert not any(kernels.launch_counts().values())
    for g_card, g_cpu in zip(grads[str(cuda)], grads["cpu"]):
        assert torch.isfinite(g_cpu).all() and g_cpu.abs().max() > 0
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-10, atol=0)


def test_sharded_step_on_card_matches_unsharded(cuda):
    """The step on a (2, 2) cols x gpt mesh listing the card 4 times, and
    solve(mesh=) on a (4,) mesh, against the unsharded step."""
    from rte_rrtmgp_torch.parallel import make_mesh
    from rte_rrtmgp_torch.parallel.sharded import sharded_step
    tables = step.build_tables(4, dtype=torch.float32, device=cuda)
    arrs = step.atmos_arrays(64, 30)
    args = [torch.as_tensor(arrs[k], device=cuda) for k in step.ARG_NAMES]
    ref = step.make_step(*tables, gpt_chunk=32)(*args)
    kernels.reset_launch_counts()
    out = sharded_step(make_mesh((2, 2), devices=[cuda] * 4), *tables,
                       gpt_chunk=32)(*args)
    # per shard: LW 32 g (1 chunk), SW 28 g (1 chunk); 4 shards
    assert kernels.launch_counts()["gas_optics_interp"] == 8
    assert kernels.launch_counts()["lw_sweep"] == 4
    for k, v in ref.items():
        assert float((out[k] - v).abs().max()) <= 1e-2, k


def test_golden_case_float64_on_card(cuda):
    """The golden case (tests/golden_case.py) through the port in float64
    on the card lies within the reference CI gate of the frozen goldens,
    with every kernel wrapper on its twin (no launch)."""
    import golden_case

    f64 = torch.float64
    gases = golden_case.GOLDEN_GASES
    kd_lw = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=4),
                           gases, dtype=f64, device=cuda)
    kd_sw = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=4),
                           gases, dtype=f64, device=cuda)
    cl_lw = CloudLUT.from_raw(synthetic.make_cloud_raw(True), dtype=f64,
                              device=cuda)
    cl_sw = CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=f64,
                              device=cuda)
    alut = AerosolLUT.from_raw(synthetic.make_aerosol_raw(), dtype=f64,
                               device=cuda)
    atm = make_atmosphere(golden_case.NCOL, golden_case.NLAY, seed=7)
    emis = np.full((golden_case.NCOL, kd_lw.nbnd), 0.98)
    alb = np.full((golden_case.NCOL, kd_sw.nbnd), 0.06)
    common = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
                  p_lev=atm["p_lev"], t_lay=atm["t_lay"])
    kernels.reset_launch_counts()
    lw = RadiationSolverLW(kd_lw, cl_lw)
    got = {}
    clear = lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"], emis_sfc=emis,
                     **common)
    cloudy = lw.solve(t_lev=atm["t_lev"], t_sfc=atm["t_sfc"], emis_sfc=emis,
                      lwp=atm["lwp"], iwp=atm["iwp"], rel=atm["rel"],
                      dei=atm["dei"], **common)
    for k in ("lw_flux_up", "lw_flux_dn"):
        got["clear_" + k], got["cloudy_" + k] = clear[k], cloudy[k]
    swout = RadiationSolverSW(kd_sw, cl_sw, alut).solve(
        mu0=atm["mu0"], sfc_alb_dir=alb, sfc_alb_dif=alb, lwp=atm["lwp"],
        iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"], rh=atm["rh"],
        aermr=atm["aermr"], delta_cloud=True, delta_aerosol=True, **common)
    for k in ("sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir"):
        got["allsky_" + k] = swout[k]
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values())
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens", "fluxes_f64.nc")
    with ncio.NcReader(golden) as nc:
        for name, arr in got.items():
            assert arr.dtype == f64 and arr.device.type == "cuda", name
            err = float(np.abs(arr.cpu().numpy() - nc.read(name)).max())
            assert err <= golden_case.THRESHOLD_WM2, (name, err)


def _tracer_means(device, seed):
    rng = np.random.default_rng(2)
    shape = (6, 4, 5)
    kg = rng.uniform(1e-5, 1e-4, shape)
    cld = np.where(rng.random(shape) < 0.4, rng.uniform(1e-3, 5e-3, shape),
                   0.0)
    f = [kg + cld, 0.5 * kg, 0.99 * cld, np.zeros(shape),
         np.where(cld > 0, 0.85, 0.0), np.zeros(shape)]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    out = raytracer.trace_rays(
        seed, *map(t, f), None, t(rng.uniform(0.05, 0.3, shape[1:])),
        (2, 2, 5), (500.0, 800.0, 700.0), 900.0, 100.0,
        raytracer.sun_direction_from_angles(0.6, 0.3), photons_per_pixel=64)
    return {n: float(getattr(out, n).double().mean()) for n in out._fields}


def test_tracer_on_card_matches_cpu(cuda):
    """At equal photon counts the card's domain means lie within 4 sigma of
    the CPU's, sigma from the spread of a few seeds on each side."""
    card = [_tracer_means(cuda, s) for s in range(6)]
    cpu = [_tracer_means("cpu", s) for s in range(6)]
    for name in card[0]:
        a = np.array([c[name] for c in card])
        b = np.array([c[name] for c in cpu])
        sigma = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / len(a))
        assert abs(a.mean() - b.mean()) <= 4 * sigma + 1e-6 * abs(b.mean()), \
            (name, a, b)


@pytest.mark.parametrize("longwave", [False, True])
def test_cli_rt_on_card_launches_gas_optics_kernel(cuda, tmp_path,
                                                   monkeypatch, longwave):
    """``cli_rt`` on a small case on the card: one gas-optics launch for
    the SW pass 1 (one chunk, one g-point), plus one LW gas-optics and one
    LW sweep launch with ``--longwave``; the fluxes finite and the
    incident flux exact."""
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "1")
    inputs.make_case_files(str(tmp_path), "allsky", gpt_per_band=2)
    atm = make_atmosphere(4 * 3, 16, seed=3)
    inputs.write_input_nc(str(tmp_path / "rte_rrtmgp_input.nc"), atm, 4, 3,
                          rt_grid={"nz": 8, "sza": 0.4})
    monkeypatch.chdir(tmp_path)
    kernels.reset_launch_counts()
    flags = ["--raytracing", "16", "--two-stream", "--cloud-optics",
             "--single-gpt", "5"] + (["--longwave"] if longwave else [])
    assert cli_rt.main(flags) == 0
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    assert got == ({"gas_optics_interp": 2, "lw_sweep": 1} if longwave
                   else {"gas_optics_interp": 1})
    with ncio.NcReader("rte_rrtmgp_output.nc") as nc:
        for v in nc.variables():
            assert np.isfinite(nc.read(v)).all(), v
        assert nc.read("rt_flux_abs_dir").shape == (9, 3, 4)
        assert (nc.read("rt_flux_tod_dn") > 0).all()


def _camera_mean(device, seed):
    rng = np.random.default_rng(2)
    shape = (6, 6, 6)
    kg = rng.uniform(2e-5, 1e-4, shape)
    cld = np.where(rng.random(shape) < 0.3, rng.uniform(5e-4, 2e-3, shape),
                   0.0)
    f = [kg + cld, 0.7 * kg, 0.99 * cld, np.zeros(shape),
         np.where(cld > 0, 0.85, 0.0), np.zeros(shape)]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    cam = raytracer_bw.Camera(cam_type=0, nx=6, ny=5, fov=170.0,
                              pitch_deg=-40.0, position=(1500.0, 1500.0, 300.0))
    mu = float(np.sqrt(1 - 0.34))
    count, _ = raytracer_bw.trace_rays_bw(
        raytracer_bw._key(seed), cam, *map(t, f), t([2e-6, 1e-6]),
        t([0.8, 0.9]), t(np.tile([1.0, 0.0, 0.0], (2, 1))),
        t([3000.0, 5000.0, 9000.0]), t(np.full(shape[1:], 0.2)),
        t(np.ones(shape[1:])), (2, 2, 2), (500.0, 500.0, 500.0),
        np.array([0.5, 0.3, mu]), mu, photons_per_pixel=16)
    assert bool(torch.isfinite(count).all())
    return float(count.double().mean())


def test_camera_tracer_on_card_matches_cpu(cuda):
    """The camera render's domain-mean count on the card within 4 sigma of
    the CPU's, sigma from the spread of 12 seeds on each side (a render's
    spread is ~18% here; six seeds underestimate it)."""
    a = np.array([_camera_mean(cuda, s) for s in range(12)])
    b = np.array([_camera_mean("cpu", s) for s in range(12)])
    sigma = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / len(a))
    assert a.mean() > 0 and abs(a.mean() - b.mean()) <= 4 * sigma, (a, b)


def _bw_case(tmp_path):
    inputs.make_case_files(str(tmp_path), "allsky", gpt_per_band=1)
    atm = make_atmosphere(4 * 3, 12, seed=3)
    path = str(tmp_path / "rte_rrtmgp_input.nc")
    inputs.write_input_nc(path, atm, 4, 3, rt_grid={"nz": 6, "sza": 0.4})
    set_virtual_camera.main(["--name", path, "--toa", "--nx", "4", "--ny",
                             "3"])
    return atm


@pytest.mark.parametrize("chunk", [None, 5])
def test_cli_bw_on_card_launches_gas_optics_kernel(cuda, tmp_path,
                                                   monkeypatch, chunk):
    """``cli_bw`` on a small case on the card (classic camera group): one
    gas-optics launch a ``gpt_chunk`` chunk (one without), none for the
    cloud camera; the radiance and images finite.  Without a chunk in
    ``lanes`` with the walk NEE; with chunks in the CLI's default scan
    with the field NEE."""
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "1")
    _bw_case(tmp_path)
    monkeypatch.chdir(tmp_path)
    kernels.reset_launch_counts()
    flags = ["--broadband", "--bw-raytracing", "4", "--cloud-optics",
             "--cloud-cam"]
    if chunk:
        flags += ["--gpt-chunk", str(chunk), "--nee-mode", "field"]
    else:
        flags += ["--spectral-mode", "lanes"]
    assert cli_bw.main(flags) == 0
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    assert got == {"gas_optics_interp": 1 if chunk is None else 3}
    with ncio.NcReader("rte_rrtmgp_output.nc") as nc:
        for v in nc.variables():
            assert np.isfinite(nc.read(v)).all(), v
        assert nc.read("radiance").shape == (3, 4)
        assert nc.read("radiance").mean() > 0


def test_camera_solver_float64_on_card_takes_twins(cuda, tmp_path):
    """The camera solver in float64 on the card runs the plain twins (the
    JAX package's rule: kernels for float32 only): no launch, finite
    radiance."""
    atm = _bw_case(tmp_path)
    kd = KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=1),
                        atm["gas_concs"].names(), dtype=torch.float64,
                        device=cuda)
    kernels.reset_launch_counts()
    out = RadiationSolverBW(kd).solve(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(12, 0.8), azi=np.zeros(12),
        sfc_alb=np.full((12, kd.nbnd), 0.2), land_use_map=np.ones(12),
        camera=raytracer_bw.Camera(cam_type=2, nx=4, ny=3),
        grid_cells=(6, 3, 4), grid_d=(2500.0, 1000.0, 1000.0),
        kn_grid=(2, 2, 2), z_lev=np.asarray(atm["z_lev"]),
        photons_per_pixel=4, mode="broadband", spectral_mode="lanes",
        dtype=torch.float64)
    assert not any(kernels.launch_counts().values())
    rad = out["radiance"]
    assert rad.dtype == torch.float64 and rad.is_cuda
    assert bool(torch.isfinite(rad).all()) and float(rad.mean()) > 0


CLI_RUNS = {
    "allsky_broadband": ("allsky", ["--cloud-optics", "--delta-cloud"],
                         {"gas_optics_interp": 2, "lw_sweep": 1,
                          "sw_2stream": 1}),
    "aerosky_bybnd": ("aerosky", ["--cloud-optics", "--aerosol-optics",
                                  "--delta-cloud", "--delta-aerosol",
                                  "--output-bnd-fluxes"],
                      {"gas_optics_interp": 2}),
    "aerosky_optical": ("aerosky", ["--cloud-optics", "--aerosol-optics",
                                    "--output-optical"],
                        {"gas_optics_interp": 2, "lw_sweep": 1,
                         "sw_2stream": 1}),
}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_on_card_launches_kernels_and_matches_cpu(cuda, tmp_path,
                                                      monkeypatch, run):
    """The CLI on a small generated case (gpt_per_band=4, default layout;
    broadband, by band with aerosols, optical output) launches the kernels
    of its path on the card, and its output lies within 0.1 W m-2 (fluxes)
    or 1e-5 of each array's largest value (optical properties and
    sources) of the same CLI with ``--device cpu``."""
    case, flags, expected = CLI_RUNS[run]
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "1")
    monkeypatch.setenv("RTE_RRTMGP_LAYERMAJOR", "0")
    inputs.make_case_files(str(tmp_path), case, gpt_per_band=4)
    monkeypatch.chdir(tmp_path)
    kernels.reset_launch_counts()
    assert cli.main(flags + ["--output", "card.nc"]) == 0
    got = {k: v for k, v in kernels.launch_counts().items() if v}
    assert got == expected
    assert cli.main(flags + ["--output", "cpu.nc", "--device", "cpu"]) == 0
    with ncio.NcReader("card.nc") as a, ncio.NcReader("cpu.nc") as b:
        assert sorted(a.variables()) == sorted(b.variables())
        fluxes = [v for v in a.variables() if "_flux_" in v]
        assert len(fluxes) == (14 if "bybnd" in run else 7)
        for v in a.variables():
            x, y = a.read(v).astype(np.float64), b.read(v)
            err = np.abs(x - y).max()
            tol = 0.1 if v in fluxes else REL * np.abs(y).max()
            assert err <= tol, (v, err, tol)


def test_ncio_round_trip_on_card_machine(cuda, tmp_path):
    """Classic NetCDF written and read on the card's machine (no h5py
    there), from and back onto the card."""
    x = torch.randn(3, 5, device=cuda)
    path = str(tmp_path / "x.nc")
    with ncio.NcWriter(path) as nc:
        nc.write("x", x.cpu().numpy(), ("a", "b"))
        nc.write("n", np.arange(3, dtype=np.int64), ("a",))
        nc.write_strings("names", ["lw", "sw"], "c")
    with ncio.NcReader(path) as nc:
        assert torch.equal(torch.from_numpy(nc.read("x")).to(cuda), x)
        assert nc.read("n").tolist() == [0, 1, 2]
        assert nc.read_strings("names") == ["lw", "sw"]


def test_tuner_measures_on_card_and_persists(cuda, tmp_path, monkeypatch):
    """``autotune`` times two candidates on the card (each call
    synchronized) and persists the faster one under this card's kind."""
    monkeypatch.setenv("RTE_RRTMGP_TUNER_CACHE", str(tmp_path / "t.json"))
    monkeypatch.delenv("RTE_RRTMGP_TUNER_DISABLE", raising=False)
    monkeypatch.setattr(tuner, "_memory_cache", {})
    monkeypatch.setattr(tuner, "_disk_loaded", False)
    x = torch.randn(1024, 1024, device=cuda)
    build = lambda c: (lambda a: [a @ a for _ in range(c["n"])][-1])
    best = tuner.autotune("toy", [{"n": 40}, {"n": 1}], build, (x,), iters=3)
    assert best == {"n": 1}
    table = json.load(open(tmp_path / "t.json"))
    key = tuner.key("toy", None, "cuda:" + torch.cuda.get_device_name(cuda))
    assert table[key]["config"] == {"n": 1} and len(table[key]["all"]) == 2

