"""The fused SW entries on the CPU: ``rte_sw.sw_solver_2stream_fused_broadband``
and its layer-major form, which hand the gas optics (tau_abs, tau_rayleigh)
and up to two per-band increments to the SW kernel.  On the CPU, and in
float64, they take their twin: the plain chain
(``gas_optics.combine_abs_and_rayleigh``, then
``optics_ops.increment_2str_by_2str_bybnd`` for each increment), then the
plane twin.  Here they are held to that chain bit for bit (0, 1 and 2
increments, a whole spectrum and a chunk that starts inside a band, cells
with tau == 0 and tau <= 2 eps, night columns run with the safe mu0), their
checks refuse wrong shapes, dtypes, devices and bands on either path, the
launch geometry counts the band values a block stages, and the solver
class's broadband solve with clouds and aerosols through the fused entry
equals its plain chain (the optical-output path) bit for bit."""

import numpy as np
import pytest
import torch

from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import (AerosolLUT, CloudLUT, KDist,
                                     RadiationSolverSW)
from rte_rrtmgp_torch.models.types import OpticalProps2str
from rte_rrtmgp_torch.ops import gas_optics, kernels, optics_ops, rte_sw
from rte_rrtmgp_torch.ops.kernels import _build, solvers

torch.set_num_threads(2)

NCOL, NLAY, NBND, GPB = 7, 10, 5, 4
FULL = tuple(b for b in range(NBND) for _ in range(GPB))     # G = 20
BANDS = {"spectrum": FULL, "chunk": FULL[3:16]}              # G = 13
EPS32 = float(torch.finfo(torch.float32).eps)


def _inputs(dtype, bands, ninc, seed=3):
    """Gas pair (ncol, nlay, G), ``ninc`` increments (ncol, nlay, NBND) and
    the boundary inputs, from a NumPy seed."""
    rng = np.random.default_rng(seed)
    G = len(bands)
    t = lambda a: torch.tensor(a, dtype=dtype)
    tau_abs = rng.uniform(0.0, 2.0, (NCOL, NLAY, G))
    tau_ray = rng.uniform(0.0, 0.5, (NCOL, NLAY, G))
    tau_abs[0, :, :] = tau_ray[0, :, :] = 0.0                 # tau == 0
    tau_abs[1, :4, :] = 0.5 * EPS32                           # tau <= 2 eps
    tau_ray[1, :4, :] = 0.25 * EPS32
    incs = []
    for i in range(ninc):
        tau = rng.uniform(0.0, 5.0, (NCOL, NLAY, NBND))
        tau[:, ::3] = 0.0                                     # clear cells
        incs.append(OpticalProps2str(
            tau=t(tau), ssa=t(rng.uniform(0.0, 1.0, (NCOL, NLAY, NBND))),
            g=t(rng.uniform(0.0, 0.9, (NCOL, NLAY, NBND)))))
    mu0 = rng.uniform(0.05, 1.0, NCOL)
    mu0[2] = 1.0                                              # a night column
    bc = [t(mu0), t(rng.uniform(0.0, 0.5, (NCOL, G))),
          t(rng.uniform(0.0, 0.5, (NCOL, G))),
          t(rng.uniform(0.0, 100.0, (NCOL, G)))]
    return t(tau_abs), t(tau_ray), incs, bc


def _lm(x):
    """(ncol, nlay, n) -> layer-major (nlay*ncol, n)."""
    return x.transpose(0, 1).reshape(-1, x.shape[-1]).contiguous()


def _chain(tau_abs, tau_ray, incs, bands):
    tau, ssa, g = gas_optics.combine_abs_and_rayleigh(tau_abs, tau_ray)
    op = OpticalProps2str(tau=tau, ssa=ssa, g=g)
    for inc in incs:
        op = optics_ops.increment_2str_by_2str_bybnd(op, inc, bands)
    return op


def _to_lm(tau_abs, tau_ray, incs):
    return (_lm(tau_abs), _lm(tau_ray),
            [OpticalProps2str(tau=_lm(o.tau), ssa=_lm(o.ssa), g=_lm(o.g))
             for o in incs])


@pytest.mark.parametrize("bands", list(BANDS))
@pytest.mark.parametrize("ninc", [0, 1, 2])
@pytest.mark.parametrize("layout", ["cm", "lm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fused_entry_equals_chain_then_plane_twin(dtype, layout, ninc, bands):
    gpt2band = BANDS[bands]
    tau_abs, tau_ray, incs, bc = _inputs(dtype, gpt2band, ninc)
    kernels.reset_launch_counts()
    if layout == "lm":
        tau_abs, tau_ray, incs = _to_lm(tau_abs, tau_ray, incs)
        got = rte_sw.sw_solver_2stream_fused_broadband_lm(
            tau_abs, tau_ray, incs, gpt2band, *bc, ncol=NCOL)
        op = _chain(tau_abs, tau_ray, incs, gpt2band)
        ref = rte_sw.sw_2stream_lm_plain(op.tau, op.ssa, op.g, *bc,
                                         ncol=NCOL)
    else:
        got = rte_sw.sw_solver_2stream_fused_broadband(
            tau_abs, tau_ray, incs, gpt2band, *bc)
        op = _chain(tau_abs, tau_ray, incs, gpt2band)
        ref = rte_sw.sw_2stream_plain(op.tau, op.ssa, op.g, *bc)
    for name, a, b in zip(("up", "dn", "dir"), got, ref):
        assert a.dtype == dtype and torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name
    # The twin launches nothing and forms no g-point on a card.
    assert not any(kernels.launch_counts().values())
    assert kernels.sw_fused_gpts() == 0


def test_sw_optics_plain_is_the_chain():
    tau_abs, tau_ray, incs, _ = _inputs(torch.float32, FULL, 2)
    got = rte_sw.sw_optics_plain(tau_abs, tau_ray, incs, FULL)
    ref = _chain(tau_abs, tau_ray, incs, FULL)
    for q in ("tau", "ssa", "g"):
        assert torch.equal(getattr(got, q), getattr(ref, q)), q
    # The cells with tau <= 2 eps have no single-scattering albedo.
    gas = rte_sw.sw_optics_plain(tau_abs, tau_ray, (), FULL)
    assert float(gas.ssa[:2, :4].abs().max()) == 0.0
    assert float(gas.g.abs().max()) == 0.0


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _swap(op, **change):
    return OpticalProps2str(**{q: change.get(q, getattr(op, q))
                               for q in ("tau", "ssa", "g")})


# name -> (change of (tau_abs, tau_ray, incs, bands), error, match)
BAD = {
    "tau_ray_shape": (lambda a, r, i, b: (a, r[..., :-1], i, b),
                      ValueError, "one .*shape"),
    "tau_abs_dtype": (lambda a, r, i, b: (a.half(), r, i, b), TypeError,
                      "tau_abs is torch.float16"),
    "tau_abs_integer": (lambda a, r, i, b: (a.to(torch.int32), r, i, b),
                        TypeError, "tau_abs is torch.int32"),
    "tau_ray_device": (lambda a, r, i, b: (a, _meta(r), i, b), ValueError,
                       "tau_ray on meta"),
    "increment_shape": (lambda a, r, i, b: (a, r, [_swap(
        i[0], ssa=i[0].ssa[..., :-1])], b), ValueError,
        r"increments\[0\].ssa has shape"),
    "increment_dtype": (lambda a, r, i, b: (a, r, [_swap(
        i[0], g=i[0].g.half())], b), TypeError, r"increments\[0\].g is"),
    "increment_device": (lambda a, r, i, b: (a, r, [_swap(
        i[0], tau=_meta(i[0].tau))], b), ValueError,
        r"increments\[0\].tau on meta"),
    "band_axis": (lambda a, r, i, b: (a, r, [OpticalProps2str(
        *(x[..., :-1] for x in (i[0].tau, i[0].ssa, i[0].g)))], b),
        ValueError, "gpt2band reaches band"),
    "gpt2band_length": (lambda a, r, i, b: (a, r, i, b[:-1]), ValueError,
                        "bands in gpt2band for G"),
    "gpt2band_order": (lambda a, r, i, b: (a, r, i, b[::-1]), ValueError,
                       "nondecreasing"),
    "three_increments": (lambda a, r, i, b: (a, r, i * 3, b), ValueError,
                         "3 increments, at most 2"),
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("layout", ["cm", "lm"])
def test_fused_entry_refuses(layout, case):
    change, err, match = BAD[case]
    tau_abs, tau_ray, incs, bc = _inputs(torch.float32, FULL, 1)
    if layout == "lm":
        tau_abs, tau_ray, incs = _to_lm(tau_abs, tau_ray, incs)
    tau_abs, tau_ray, incs, bands = change(tau_abs, tau_ray, incs, FULL)
    with pytest.raises(err, match=match):
        if layout == "lm":
            solvers.sw_2stream_fused_lm(tau_abs, tau_ray, incs, bands, *bc,
                                        ncol=NCOL)
        else:
            solvers.sw_2stream_fused(tau_abs, tau_ray, incs, bands, *bc)


def _sw_bytes(nlay, gt, tiles, ninc=0, nbt=0):
    extra = gt + 3 * ninc * nbt * nlay if ninc else 0
    return 4 * ((5 * gt + 3 * tiles) * (nlay + 1) + extra)


PUBLISHED = tuple(b for b in range(14) for _ in range(16))   # 224 g-points


@pytest.mark.parametrize("chunk, ninc, nbt", [
    ((0, 128), 0, 0), ((0, 128), 1, 2), ((0, 128), 2, 2),
    ((128, 224), 1, 2), ((0, 224), 1, 2), ((8, 136), 1, 3)])
def test_sw_geometry_counts_band_values(chunk, ninc, nbt):
    """The flagship chunks at 4096 x 256: a 32-g tile of 16-g bands spans
    2 bands (3 where the chunk starts inside a band); each increment adds
    nlay x nbt x 3 floats, and the tile's band offsets, to a block."""
    bands = PUBLISHED[slice(*chunk)]
    G = len(bands)
    geo = solvers.sw_geometry(4096, 256, G, gpt2band=bands, ninc=ninc)
    tiles = -(-G // 32)
    assert (geo.gt, geo.tiles, geo.nbt, geo.branch) == (32, tiles, nbt,
                                                        "shared")
    assert geo.smem_bytes == _sw_bytes(256, 32, tiles, ninc, nbt)
    assert geo.smem_bytes <= _build.SMEM_PER_BLOCK
    if ninc == 0:
        assert geo == solvers.sw_geometry(4096, 256, G)


def test_sw_geometry_band_values_move_the_scratch_branch():
    """At 336 layers a 128-g plane launch still fits in shared memory; the
    fused launch's band values take it to the global-scratch branch, whose
    scratch holds them too."""
    bands = PUBLISHED[:128]
    assert solvers.sw_geometry(3, 336, 128).branch == "shared"
    geo = solvers.sw_geometry(3, 336, 128, gpt2band=bands, ninc=1)
    assert geo.branch == "global" and geo.smem_bytes == 0
    assert 4 * geo.scratch_floats == 3 * geo.tiles * _sw_bytes(
        336, geo.gt, geo.tiles, 1, geo.nbt)


@pytest.mark.parametrize("ncol, nlay, G, threads", [
    (4096, 256, 128, 1024),   # one block an SM: the SM's threads in it
    (4096, 256, 96, 1024),
    (2048, 72, 128, 256),     # four blocks an SM
    (3, 450, 96, 256),        # global-scratch branch
])
def test_sw_geometry_threads(ncol, nlay, G, threads):
    geo = solvers.sw_geometry(ncol, nlay, G)
    assert geo.threads == threads
    assert geo.threads == solvers.sw_geometry(
        ncol, nlay, G, gpt2band=PUBLISHED[:G], ninc=1).threads
    assert solvers.sw_geometry(ncol, nlay, G, threads=64).threads == 64


@pytest.mark.parametrize("bands, gt, nbt", [
    (PUBLISHED[:128], 32, 2), (PUBLISHED[:128], 128, 8),
    (tuple(range(40)), 32, 32), (FULL[3:16], 32, 4), ((5,), 32, 1)])
def test_sw_tile_bands(bands, gt, nbt):
    assert solvers.sw_tile_bands(bands, gt) == nbt


def test_fused_counter_resets():
    _build.SW_FUSED_GPTS["sw_2stream"] = 7
    assert kernels.sw_fused_gpts() == 7
    kernels.reset_launch_counts()
    assert kernels.sw_fused_gpts() == 0


@pytest.fixture(scope="module")
def sw_case():
    atm = make_atmosphere(6, 12, seed=11)
    alb = np.full((6, 14), 0.08)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], mu0=atm["mu0"],
              sfc_alb_dir=alb, sfc_alb_dif=alb, lwp=atm["lwp"],
              iwp=atm["iwp"], rel=atm["rel"], dei=atm["dei"], rh=atm["rh"],
              aermr=atm["aermr"], gpt_chunk=12, delta_cloud=True,
              delta_aerosol=True)
    return atm, kw


@pytest.mark.parametrize("cellw", [True, False], ids=["cellw", "planes"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_solver_clouds_and_aerosols_equal_plain_chain(sw_case, monkeypatch,
                                                      dtype, cellw):
    """The solver class's broadband fluxes with clouds and aerosols: the
    fused entry (one call a chunk, two increments) against the plain chain
    that optical output takes, bit for bit."""
    atm, kw = sw_case
    gases = atm["gas_concs"].names()
    solver = RadiationSolverSW(
        KDist.from_raw(synthetic.make_kdist_raw(False, gpt_per_band=2),
                       gases, dtype=dtype, device="cpu"),
        CloudLUT.from_raw(synthetic.make_cloud_raw(False), dtype=dtype,
                          device="cpu"),
        AerosolLUT.from_raw(synthetic.make_aerosol_raw(), dtype=dtype,
                            device="cpu"))
    calls = []
    fused = rte_sw.sw_solver_2stream_fused_broadband
    monkeypatch.setattr(rte_sw, "sw_solver_2stream_fused_broadband",
                        lambda *a: (calls.append(len(a[2])), fused(*a))[1])
    got = solver.solve(**kw, dtype=dtype, cellw=cellw, layer_major=False)
    assert calls == [2] * -(-solver.kdist.ngpt // kw["gpt_chunk"])
    ref = solver.solve(**kw, dtype=dtype, cellw=cellw, output_optical=True)
    assert len(calls) == -(-solver.kdist.ngpt // kw["gpt_chunk"])
    assert set(got) == {"sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir",
                        "sw_flux_net"}
    for k, v in got.items():
        assert v.dtype == dtype and torch.equal(v, ref[k]), k
