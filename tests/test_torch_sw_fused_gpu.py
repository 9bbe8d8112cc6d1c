"""The fused SW entries on the card (marker ``gpu``; skipped inside the
``cuda`` fixture where there is no card).  Run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sw_fused_gpu.py

B3 and B7 take the gas optics (tau_abs, tau_rayleigh) and up to two
per-band increments and form tau, ssa and g themselves.  Held bit for bit
to what the chain they replace gives on the card: the plain PyTorch
combination and increments (``rte_sw.sw_optics_plain`` on card tensors),
then the plane entry of the same kernel.  The entries with 0, 1 and 2
increments, a 128-g chunk and the ragged 96-g chunk, every g-tile width,
the global-scratch branch and a chunk that starts inside a band, cells with
tau == 0 and tau <= 2 eps and night columns (run with the safe mu0), both
layouts; then the step and the clear-sky step at a small shape and at 4096
x 256 in each layout against the same step with the chain put back, and
``kernels.sw_fused_gpts()`` on each path."""

import numpy as np
import pytest
import torch

from rte_rrtmgp_torch import step
from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
from rte_rrtmgp_torch.models.gas_concs import GasConcs
from rte_rrtmgp_torch.models.kdist import KDist
from rte_rrtmgp_torch.models.radiation import RadiationSolverSW
from rte_rrtmgp_torch.models.types import OpticalProps2str
from rte_rrtmgp_torch.ops import kernels, rte_sw
from rte_rrtmgp_torch.ops.kernels import solvers as b23

pytestmark = pytest.mark.gpu
SEED = 2 ** 31 + 17
PUBLISHED = tuple(b for b in range(14) for _ in range(16))   # 224 g-points
CHUNKS = {"g128": PUBLISHED[:128], "g96": PUBLISHED[128:],
          "g128_mid_band": PUBLISHED[8:136]}
EPS32 = float(torch.finfo(torch.float32).eps)
LAYOUTS = {"default": dict(cellw=True, layer_major=False),
           "cellw_off": dict(cellw=False, layer_major=False),
           "layer_major": dict(cellw=True, layer_major=True)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kernels.build()
    return torch.device("cuda")


def _lm(x):
    """(ncol, nlay, n) -> layer-major (nlay*ncol, n)."""
    return x.transpose(0, 1).reshape(-1, x.shape[-1]).contiguous()


def _inputs(dev, ncol, nlay, bands, ninc, lm, seed):
    rng = np.random.default_rng(seed)
    G = len(bands)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    plane = (lambda a: _lm(t(a))) if lm else t
    tau_abs = rng.lognormal(-2.0, 2.0, (ncol, nlay, G))
    tau_ray = rng.uniform(0.0, 0.3, (ncol, nlay, G))
    tau_abs[0] = tau_ray[0] = 0.0                             # tau == 0
    tau_abs[1, :4] = 0.5 * EPS32                              # tau <= 2 eps
    tau_ray[1, :4] = 0.25 * EPS32
    tau_ray[2, :, ::5] = 0.0                                  # no Rayleigh
    incs = []
    for _ in range(ninc):
        tau = rng.lognormal(0.0, 2.0, (ncol, nlay, 14))
        tau[:, ::3] = 0.0                                     # clear cells
        incs.append(OpticalProps2str(
            tau=plane(tau), ssa=plane(rng.uniform(0.0, 1.0, tau.shape)),
            g=plane(rng.uniform(0.0, 0.9, tau.shape))))
    mu0 = rng.uniform(0.02, 1.0, ncol)
    mu0[3:5] = 1.0                                            # night columns
    bc = [t(mu0), t(rng.uniform(0.0, 0.5, (ncol, G))),
          t(rng.uniform(0.0, 0.5, (ncol, G))),
          t(rng.uniform(0.0, 100.0, (ncol, G)))]
    return plane(tau_abs), plane(tau_ray), incs, bc


def _chain(tau_abs, tau_ray, incs, bands, bc, ncol, lm):
    """The unfused SW path: the plain combination and increments on the
    card, then the plane entry."""
    op = rte_sw.sw_optics_plain(tau_abs, tau_ray, incs, bands)
    if lm:
        return b23.sw_2stream_lm(op.tau, op.ssa, op.g, *bc, ncol=ncol)
    return b23.sw_2stream(op.tau, op.ssa, op.g, *bc)


def _check_entry(dev, ncol, nlay, bands, ninc, lm, seed):
    tau_abs, tau_ray, incs, bc = _inputs(dev, ncol, nlay, bands, ninc, lm,
                                         seed)
    kernels.reset_launch_counts()
    if lm:
        got = b23.sw_2stream_fused_lm(tau_abs, tau_ray, incs, bands, *bc,
                                      ncol=ncol)
    else:
        got = b23.sw_2stream_fused(tau_abs, tau_ray, incs, bands, *bc)
    torch.cuda.synchronize()
    name = "sw_2stream_lm" if lm else "sw_2stream"
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {name: 1} and kernels.sw_fused_gpts() == len(bands)
    ref = _chain(tau_abs, tau_ray, incs, bands, bc, ncol, lm)
    for q, a, b in zip(("up", "dn", "dir"), got, ref):
        assert bool(torch.isfinite(a).all()), q
        assert torch.equal(a, b), (q, float((a - b).abs().max()))


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("ninc", [0, 1, 2])
@pytest.mark.parametrize("chunk", ["g128", "g96"])
def test_fused_entry_bit_equal_to_chain(cuda, chunk, ninc, lm):
    _check_entry(cuda, 37, 72, CHUNKS[chunk], ninc, lm, SEED + ninc)


@pytest.mark.parametrize("lm", [False, True], ids=["cm", "lm"])
@pytest.mark.parametrize("tile, nlay, chunk", [
    (64, 72, "g128"), (128, 72, "g128"), (32, 450, "g96"),
    (32, 72, "g128_mid_band"), (128, 20, "g128_mid_band")])
def test_fused_entry_tiles_depths_bands(cuda, monkeypatch, tile, nlay, chunk,
                                        lm):
    """Wider g-tiles (more bands a tile), the global-scratch branch (450
    layers), a chunk that starts inside a band."""
    monkeypatch.setattr(b23, "SW_TILE", tile)
    bands = CHUNKS[chunk]
    geo = b23.sw_geometry(5, nlay, len(bands), tile, gpt2band=bands, ninc=2)
    assert geo.branch == ("global" if nlay == 450 else "shared")
    _check_entry(cuda, 5, nlay, bands, 2, lm, SEED + nlay + tile)


def _tables(dev, dtype=torch.float32):
    from benchmark.inputs import tables

    gases = tables.GAS_NAMES
    return (*(KDist.from_raw(tables.make_kdist_raw(lw, SEED), gases,
                             dtype=dtype, device=dev) for lw in (True, False)),
            *(CloudLUT.from_raw(tables.make_cloud_raw(lw, SEED), dtype=dtype,
                                device=dev) for lw in (True, False)))


def _atmosphere(ncol, nlay):
    from benchmark.inputs import atmosphere, tables

    atm = atmosphere.make_atmosphere(ncol, nlay, SEED)
    return atm, atmosphere.step_arrays(atm, np.float32, tables.GAS_NAMES)


@pytest.fixture(scope="module")
def cells(cuda):
    out = {}
    for size, (ncol, nlay) in (("small", (96, 40)), ("rcemip", (4096, 256))):
        _, arrs = _atmosphere(ncol, nlay)
        out[size] = [torch.as_tensor(arrs[k], device=cuda)
                     for k in step.ARG_NAMES]
    return _tables(cuda), out


def _put_chain_back(monkeypatch):
    """Route the solver layer's fused calls through the unfused chain."""
    def cm(tau_abs, tau_ray, incs, bands, mu0, *bc):
        return _chain(tau_abs, tau_ray, incs, bands, (mu0, *bc),
                      mu0.shape[0], False)

    def lm(tau_abs, tau_ray, incs, bands, mu0, *bc, ncol):
        return _chain(tau_abs, tau_ray, incs, bands, (mu0, *bc), ncol, True)

    monkeypatch.setattr(rte_sw, "sw_solver_2stream_fused_broadband", cm)
    monkeypatch.setattr(rte_sw, "sw_solver_2stream_fused_broadband_lm", lm)


def _call(run, args):
    run(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = run(*args)
    torch.cuda.synchronize()
    return (out, kernels.sw_fused_gpts(), kernels.launch_counts(),
            torch.cuda.max_memory_allocated())


@pytest.mark.parametrize("clear_sky", [False, True], ids=["allsky", "clrsky"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("size", ["small", "rcemip"])
def test_step_bit_equal_to_chain(cells, monkeypatch, size, layout,
                                 clear_sky):
    """The step (gpt_chunk 128) and the clear-sky step: every output
    bit-equal to the step with the chain put back; the same launches; 224
    g-points formed in the kernel a solve (448 clear-sky), none with the
    chain; the peak no higher."""
    tabs, args = cells
    run = step.make_step(*tabs, gpt_chunk=128, clear_sky=clear_sky,
                         **LAYOUTS[layout])
    out, fused, launches, peak = _call(run, args[size])
    with monkeypatch.context() as m:
        _put_chain_back(m)
        ref, fused_ref, launches_ref, peak_ref = _call(run, args[size])
    assert (fused, fused_ref) == (224 * (2 if clear_sky else 1), 0)
    assert launches == launches_ref
    assert set(out) == set(ref) and len(out) == (14 if clear_sky else 7)
    for k, v in ref.items():
        assert torch.equal(out[k], v), (k, float((out[k] - v).abs().max()))
    print(f"[peak] {size} {layout} clear_sky={clear_sky}: fused {peak} B, "
          f"chain {peak_ref} B")
    assert peak <= peak_ref


def test_fused_gpts_by_path(cuda):
    """224 for the solver class's one-chunk solve (the CLI's and
    ``rcemip.solve``'s path); 0 where the plain chain writes the planes:
    by-band and optical output, float64."""
    atm, _ = _atmosphere(64, 30)
    from benchmark.inputs import tables

    ncol = atm["p_lay"].shape[0]
    gas = GasConcs()
    for g in tables.GAS_NAMES:
        gas.set_vmr(g, atm["vmr"][g])
    alb = np.full((ncol, 14), 0.06, np.float32)
    x = {k: np.asarray(atm[k], np.float32) for k in (
        "p_lay", "p_lev", "t_lay", "mu0", "lwp", "iwp", "rel", "dei")}
    clouds = dict(lwp=x["lwp"], iwp=x["iwp"], rel=x["rel"], dei=x["dei"])
    got = {}
    for name, dtype, kw in (("broadband", torch.float32, {}),
                            ("bybnd", torch.float32,
                             dict(output_bnd_fluxes=True)),
                            ("optical", torch.float32,
                             dict(output_optical=True)),
                            ("float64", torch.float64, {})):
        _, kd_sw, _, cl_sw = _tables(cuda, dtype)
        kernels.reset_launch_counts()
        RadiationSolverSW(kd_sw, cl_sw).solve(
            gas, x["p_lay"], x["p_lev"], x["t_lay"], x["mu0"], alb, alb,
            dtype=dtype, **clouds, **kw)
        torch.cuda.synchronize()
        got[name] = kernels.sw_fused_gpts()
    assert got == {"broadband": 224, "bybnd": 0, "optical": 0, "float64": 0}
