"""Wrappers of the broadband RTE solver kernels (``csrc/lw_sweep.cu``,
``csrc/sw_2stream.cu``).

* :func:`lw_sweep` replaces ``rte_rrtmgp_tpu/ops/pallas/solver_kernels.py:127``
  (``lw_sweep_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_lw.lw_sweep_plain`.
* :func:`sw_2stream` replaces ``solver_kernels.py:272``
  (``sw_2stream_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_plain`.
* :func:`lw_sweep_lm` and :func:`sw_2stream_lm` replace
  ``solver_layergrid.py:151`` (``lw_sweep_broadband_lm``) and ``:399``
  (``sw_2stream_broadband_lm``): the same functions on layer-major
  (nlay*ncol, G) planes with cell (c, l) at row l*ncol + c, read in place
  by the same kernel sources; their twins are
  :func:`rte_rrtmgp_torch.ops.rte_lw.lw_sweep_lm_plain` and
  :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_lm_plain`.
* :func:`sw_2stream_fused` and :func:`sw_2stream_fused_lm`: the same SW
  kernel on the gas optics as the gas-optics kernel writes them (tau_abs,
  tau_rayleigh) and up to two per-band increments (clouds, aerosols),
  from which it forms tau, ssa and g itself; their twins are the plain
  chain (:func:`rte_rrtmgp_torch.ops.rte_sw.sw_optics_plain`) followed by
  the plane twins.  A launch counts as one of ``sw_2stream`` /
  ``sw_2stream_lm`` and adds its G to :data:`_build.SW_FUSED_GPTS`.

None needs G to be a multiple of 32 or 128, nor ncol a multiple of 8.  An
LW column is one cluster of blocks, each a slice of consecutive g-points,
one a thread, its staged (trans, src_up) working set in shared memory;
:func:`lw_geometry` chooses the slice and whether the working set must live
in a device scratch instead (from 223 layers at 128 g-points a block).
An SW block is one column and one tile of g-points, its working set in
shared memory; :func:`sw_geometry` chooses the tile and whether the
working set must live in a device scratch instead (only past ~340 layers).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ... import config
from . import _build
from ._checks import takes_twin, refuse_grad, require, stream_handle

MAX_G = 1024   # one thread per g-point in a block
SW_SLOTS = 5   # (nlay+1) x gt slots of a block's working set (sw_2stream.cu)
SW_TILE = 32   # g-points an SW block (measured: PERF.md §6, PR 3)
SW_THREADS = 256
# Threads an SW block whose working set leaves no room for a second block
# on its SM (256 layers): the SM's 1024 threads a block hide the latency of
# step 1's coefficients (measured: PERF.md §6).
SW_THREADS_ALONE = 1024
SM_SMEM = 228 * 1024   # shared memory of an SM; each block takes 1 KB more
SW_TILES = (32, 64, 128)
SW_INCREMENTS = 2  # per-band increments a fused launch adds (sw_2stream.cu)
MAX_CLUSTER = 8   # blocks of a portable thread block cluster
LW_STAGED = 2     # floats staged a (layer, g): trans, src_up (lw_sweep.cu)
LW_BLOCK_G = 128  # g-points an LW block (measured: PERF.md §6, PR 4)


@dataclasses.dataclass(frozen=True)
class SwGeometry:
    """Launch geometry of one SW solve: ``gt`` g-points and ``threads``
    threads a block, ``tiles`` blocks (one cluster) a column,
    ``smem_bytes`` of shared memory a block, and ``scratch_floats`` of
    device scratch for the whole launch (0 unless the working set does not
    fit in shared memory: the global-scratch branch)."""

    gt: int
    threads: int
    tiles: int
    smem_bytes: int
    scratch_floats: int
    nbt: int = 0   # the most bands a tile spans (fused, with increments)

    @property
    def branch(self) -> str:
        return "global" if self.scratch_floats else "shared"

    def describe(self) -> str:
        return (f"gt {self.gt} x {self.tiles} tiles, {self.threads} threads, "
                f"{self.branch} branch, {self.smem_bytes} B smem, "
                f"{4 * self.scratch_floats} B scratch")


def sw_block_floats(nlay: int, gt: int, tiles: int, extra: int = 0) -> int:
    """Floats of an SW block's working set (``block_floats`` of the CUDA
    source): SW_SLOTS slots of (nlay+1) x gt, then the level partials of
    up, dn and dir of each of the column's ``tiles`` tiles, then ``extra``
    (a fused launch's band values, :func:`sw_band_floats`)."""
    return (SW_SLOTS * gt + 3 * tiles) * (nlay + 1) + extra


def sw_band_floats(nlay: int, gt: int, ninc: int, nbt: int) -> int:
    """Floats of a fused block's band values (``band_floats`` of the CUDA
    source): the tile's gt band offsets, then three values a layer of each
    of the ``nbt`` bands it spans, for each of ``ninc`` increments."""
    return gt + 3 * ninc * nbt * nlay if ninc else 0


def sw_tile_bands(gpt2band, gt: int) -> int:
    """The most bands one tile of ``gt`` consecutive g-points spans, for a
    nondecreasing ``gpt2band``."""
    G = len(gpt2band)
    return max(gpt2band[min(G, g0 + gt) - 1] - gpt2band[g0] + 1
               for g0 in range(0, G, gt))


def sw_geometry(ncol: int, nlay: int, G: int, gt: int = SW_TILE,
                threads=None, gpt2band=None, ninc: int = 0) -> SwGeometry:
    """The preferred tile ``gt``, widened until a column takes at most
    :data:`MAX_CLUSTER` tiles, then narrowed (not below that) until the
    working set fits in shared memory.  Where it fits at no width, the
    narrowest allowed tile keeps it in a device scratch: with tile 32, from
    nlay = 337 at G = 97..128 and from nlay = 356 at G <= 32.  A fused
    launch with ``ninc`` increments adds each tile's band values (the
    bands of ``gpt2band`` it spans) to the working set.  ``threads``
    (None: :data:`SW_THREADS_ALONE` where the working set leaves room for
    one block an SM, else :data:`SW_THREADS`) is raised to the tile."""
    if not 0 < G <= MAX_G:
        raise ValueError(f"sw_2stream: G={G} outside 1..{MAX_G}")
    narrowest = next(t for t in SW_TILES if -(-G // t) <= MAX_CLUSTER)
    gt = max(gt, narrowest)
    nbt = lambda t: sw_tile_bands(gpt2band, t) if ninc else 0
    floats = lambda t: sw_block_floats(
        nlay, t, -(-G // t), sw_band_floats(nlay, t, ninc, nbt(t)))
    fits = [t for t in SW_TILES if narrowest <= t <= gt
            and 4 * floats(t) <= _build.SMEM_PER_BLOCK]
    tile = fits[-1] if fits else narrowest
    tiles = -(-G // tile)
    if threads is None:
        alone = bool(fits) and 2 * (4 * floats(tile) + 1024) > SM_SMEM
        threads = SW_THREADS_ALONE if alone else SW_THREADS
    threads = max(threads, tile)
    if fits:
        return SwGeometry(tile, threads, tiles, 4 * floats(tile), 0,
                          nbt(tile))
    return SwGeometry(tile, threads, tiles, 0, ncol * tiles * floats(tile),
                      nbt(tile))


@dataclasses.dataclass(frozen=True)
class LwGeometry:
    """Launch geometry of one LW sweep: ``gb`` g-points a block (one a
    thread, ``threads`` threads), ``blocks`` blocks a column (one cluster),
    ``smem_bytes`` of shared memory a block, and ``scratch_floats`` of
    device scratch for the whole launch (0 unless the working set does not
    fit in shared memory: the device-scratch branch)."""

    gb: int
    blocks: int
    threads: int
    smem_bytes: int
    scratch_floats: int

    @property
    def branch(self) -> str:
        return "global" if self.scratch_floats else "shared"

    def describe(self) -> str:
        return (f"{self.gb} g a block x {self.blocks} blocks a column, "
                f"{self.threads} threads, {self.branch} branch, "
                f"{self.smem_bytes} B smem, {4 * self.scratch_floats} B "
                "scratch")


def lw_block_floats(nlay: int, gb: int) -> int:
    """Floats of one LW block's working set (``block_floats`` of the CUDA
    source): a run of LW_STAGED*nlay + 3 floats for each of its ``gb``
    g-points, then each warp's nlay+1 dn partials, rounded up to a multiple
    of 4."""
    f = gb * (LW_STAGED * nlay + 3) + _ceil(gb, 32) * (nlay + 1)
    return 4 * _ceil(f, 4)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lw_geometry(ncol: int, nlay: int, G: int,
                gb: int = LW_BLOCK_G) -> LwGeometry:
    """A column is one cluster of blocks of at most ``gb`` g-points (``gb``
    widened where G would take more than :data:`MAX_CLUSTER` blocks), the
    g-points shared out evenly between them.  Where a block's working set
    exceeds the shared memory a block may use, the same kernel keeps it in
    a device scratch: from nlay = 223 at 128 g-points a block."""
    if not 0 < G <= MAX_G:
        raise ValueError(f"lw_sweep: G={G} outside 1..{MAX_G}")
    if nlay < 1:
        raise ValueError(f"lw_sweep: nlay={nlay}, needs at least one layer")
    gb = _ceil(G, _ceil(G, max(gb, _ceil(G, MAX_CLUSTER))))
    blocks = _ceil(G, gb)
    threads = 32 * _ceil(gb, 32)
    floats = lw_block_floats(nlay, gb)
    if 4 * floats > _build.SMEM_PER_BLOCK:
        return LwGeometry(gb, blocks, threads, 0, ncol * blocks * floats)
    return LwGeometry(gb, blocks, threads, 4 * floats, 0)


def _lw_launch(name, ncol, nlay, G, planes, sfc, D, w):
    """Launch ``rrtmgp_<name>_f32`` on checked inputs: ``planes`` the
    layer and level planes (three column-major, five layer-major), ``sfc``
    the four (ncol, G) surface and boundary inputs."""
    dev, f32 = planes[0].device, torch.float32
    refuse_grad(name, *planes, *sfc)
    geo = lw_geometry(ncol, nlay, G, LW_BLOCK_G)
    up, dn, jac = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    scratch = (torch.empty(geo.scratch_floats, dtype=f32, device=dev)
               if geo.scratch_floats else None)
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), f"rrtmgp_{name}_f32")(
            *(t.data_ptr() for t in planes), *(t.data_ptr() for t in sfc),
            up.data_ptr(), dn.data_ptr(), jac.data_ptr(),
            None if scratch is None else scratch.data_ptr(), ncol, nlay, G,
            geo.gb, *_lw_constants(D, w), stream_handle(dev))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return up, dn, jac


def lw_sweep(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
             inc_flux, *, D: float, w: float):
    """One Gauss angle of the LW no-scattering solve, summed over g.
    tau/lay_src (ncol, nlay, G), lev_src (ncol, nlay+1, G), the rest
    (ncol, G).  Returns up, dn, jac each (ncol, nlay+1)."""
    if takes_twin(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                  inc_flux):
        from ..rte_lw import lw_sweep_plain
        return lw_sweep_plain(tau, lay_src, lev_src, sfc_emis, sfc_src,
                              sfc_src_jac, inc_flux, D, w)
    dev, f32 = tau.device, torch.float32
    ncol, nlay, G = tau.shape
    if G > MAX_G:
        raise ValueError(f"lw_sweep: G={G} exceeds {MAX_G} g-points per chunk")
    require("tau", tau, dev, f32, (ncol, nlay, G))
    require("lay_src", lay_src, dev, f32, (ncol, nlay, G))
    require("lev_src", lev_src, dev, f32, (ncol, nlay + 1, G))
    sfc = (sfc_emis, sfc_src, sfc_src_jac, inc_flux)
    _require_lw_sfc(dev, ncol, G, *sfc)
    return _lw_launch("lw_sweep", ncol, nlay, G, (tau, lay_src, lev_src),
                      sfc, D, w)


def _require_lw_sfc(dev, ncol, G, *planes):
    for name, t in zip(("sfc_emis", "sfc_src", "sfc_src_jac", "inc_flux"),
                       planes):
        require(name, t, dev, torch.float32, (ncol, G))


def _lw_constants(D: float, w: float):
    """D, 2*pi*w, pi*w and tau_thres rounded to float32 as the twin rounds
    them."""
    f32 = torch.float32
    D32 = torch.tensor(D, dtype=f32).item()
    w32 = torch.tensor(w, dtype=f32).item()
    pi32 = torch.tensor(math.pi, dtype=f32)
    return (D32, 2.0 * pi32.item() * w32, (pi32 * w32).item(),
            config.tau_thres(f32))


def _nlay_lm(name, tau, ncol):
    rows, G = tau.shape
    if ncol <= 0 or rows % ncol or rows == 0:
        raise ValueError(f"{name}: {rows} layer-major rows are not a "
                         f"multiple of ncol={ncol}")
    if G > MAX_G:
        raise ValueError(f"{name}: G={G} exceeds {MAX_G} g-points per chunk")
    return rows // ncol, G


def lw_sweep_lm(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                inc_flux, *, ncol: int, D: float, w: float):
    """:func:`lw_sweep` on layer-major planes: tau/lay_src (nlay*ncol, G),
    lev_src the pieces (lev0 (ncol, G), inner ((nlay-1)*ncol, G), lev_last
    (ncol, G)), the rest (ncol, G).  Returns up, dn, jac each
    (ncol, nlay+1)."""
    if takes_twin(tau, lay_src, *lev_src, sfc_emis, sfc_src, sfc_src_jac,
                  inc_flux):
        from ..rte_lw import lw_sweep_lm_plain
        return lw_sweep_lm_plain(tau, lay_src, lev_src, sfc_emis, sfc_src,
                                 sfc_src_jac, inc_flux, ncol, D, w)
    dev, f32 = tau.device, torch.float32
    nlay, G = _nlay_lm("lw_sweep_lm", tau, ncol)
    require("tau", tau, dev, f32, (nlay * ncol, G))
    require("lay_src", lay_src, dev, f32, (nlay * ncol, G))
    lev0, inner, last = lev_src
    require("lev_src[0]", lev0, dev, f32, (ncol, G))
    require("lev_src[1]", inner, dev, f32, ((nlay - 1) * ncol, G))
    require("lev_src[2]", last, dev, f32, (ncol, G))
    sfc = (sfc_emis, sfc_src, sfc_src_jac, inc_flux)
    _require_lw_sfc(dev, ncol, G, *sfc)
    return _lw_launch("lw_sweep_lm", ncol, nlay, G,
                      (tau, lay_src, lev0, inner, last), sfc, D, w)


def sw_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
               inc_flux_dif=None):
    """Two-stream + adding, summed over g.  tau/ssa/g (ncol, nlay, G), mu0
    (ncol,), albedos and incident fluxes (ncol, G).  Returns up, dn
    (diffuse + direct) and dir, each (ncol, nlay+1)."""
    if takes_twin(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                  inc_flux_dif):
        from ..rte_sw import sw_2stream_plain
        return sw_2stream_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                inc_flux_dir, inc_flux_dif)
    ncol, nlay, G = tau.shape
    return _sw_launch("sw_2stream", (ncol, nlay, G), ncol, nlay, G,
                      (tau, ssa, g), mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, inc_flux_dif)


def sw_2stream_lm(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                  inc_flux_dif=None, *, ncol: int):
    """:func:`sw_2stream` on layer-major planes: tau/ssa/g
    (nlay*ncol, G), mu0 (ncol,), albedos and incident fluxes (ncol, G).
    Returns up, dn (diffuse + direct) and dir, each (ncol, nlay+1)."""
    if takes_twin(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                  inc_flux_dif):
        from ..rte_sw import sw_2stream_lm_plain
        return sw_2stream_lm_plain(tau, ssa, g, mu0, sfc_alb_dir,
                                   sfc_alb_dif, inc_flux_dir, inc_flux_dif,
                                   ncol=ncol)
    nlay, G = _nlay_lm("sw_2stream_lm", tau, ncol)
    return _sw_launch("sw_2stream_lm", (nlay * ncol, G), ncol, nlay, G,
                      (tau, ssa, g), mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, inc_flux_dif)


def sw_2stream_fused(tau_abs, tau_ray, increments, gpt2band, mu0,
                     sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                     inc_flux_dif=None):
    """:func:`sw_2stream` on the gas optics as the gas-optics kernel writes
    them: tau_abs and tau_ray (ncol, nlay, G), and ``increments``, at most
    two per-band optical properties (``.tau``, ``.ssa``, ``.g`` each
    (ncol, nlay, nbnd): clouds, then aerosols) added in turn at each
    g-point's band ``gpt2band`` (G global band indices, nondecreasing).
    The kernel forms tau, ssa and g itself; the twin runs the plain chain
    (:func:`rte_rrtmgp_torch.ops.rte_sw.sw_optics_plain`) and
    :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_plain`.  The shapes,
    dtypes, devices and bands are checked on either path.  Returns up, dn
    (diffuse + direct) and dir, each (ncol, nlay+1)."""
    incs, bands = _check_fused("sw_2stream_fused", tau_abs, tau_ray,
                               increments, gpt2band, 3)
    if _fused_takes_twin(tau_abs, tau_ray, incs, mu0, sfc_alb_dir,
                         sfc_alb_dif, inc_flux_dir, inc_flux_dif):
        from ..rte_sw import sw_2stream_fused_plain
        return sw_2stream_fused_plain(tau_abs, tau_ray, incs, bands, mu0,
                                      sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                                      inc_flux_dif)
    ncol, nlay, G = tau_abs.shape
    return _sw_launch("sw_2stream", (ncol, nlay, G), ncol, nlay, G,
                      (tau_abs, tau_ray), mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, inc_flux_dif, (incs, bands))


def sw_2stream_fused_lm(tau_abs, tau_ray, increments, gpt2band, mu0,
                        sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                        inc_flux_dif=None, *, ncol: int):
    """:func:`sw_2stream_fused` on layer-major planes: tau_abs and tau_ray
    (nlay*ncol, G), each increment's tau, ssa, g (nlay*ncol, nbnd) in the
    same cell order; its twin ends in
    :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_lm_plain`."""
    incs, bands = _check_fused("sw_2stream_fused_lm", tau_abs, tau_ray,
                               increments, gpt2band, 2)
    if _fused_takes_twin(tau_abs, tau_ray, incs, mu0, sfc_alb_dir,
                         sfc_alb_dif, inc_flux_dir, inc_flux_dif):
        from ..rte_sw import sw_2stream_fused_lm_plain
        return sw_2stream_fused_lm_plain(tau_abs, tau_ray, incs, bands, mu0,
                                         sfc_alb_dir, sfc_alb_dif,
                                         inc_flux_dir, inc_flux_dif,
                                         ncol=ncol)
    nlay, G = _nlay_lm("sw_2stream_fused_lm", tau_abs, ncol)
    return _sw_launch("sw_2stream_lm", (nlay * ncol, G), ncol, nlay, G,
                      (tau_abs, tau_ray), mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, inc_flux_dif, (incs, bands))


_FLOATS = (torch.float32, torch.float64)


def _check_fused(name, tau_abs, tau_ray, increments, gpt2band, ndim):
    """The checks of the fused entries, on the card and off it: tau_abs
    and tau_ray of one ``ndim``-D shape (cells..., G) on one device, each
    increment's tau, ssa, g (cells..., nbnd) on that device with one nbnd,
    float32 or float64 throughout, and ``gpt2band`` G nondecreasing bands
    below nbnd.  Returns the increments and the bands as tuples."""
    incs = tuple(increments)
    if len(incs) > SW_INCREMENTS:
        raise ValueError(f"{name}: {len(incs)} increments, at most "
                         f"{SW_INCREMENTS}")
    shape, dev = tuple(tau_abs.shape), tau_abs.device
    named = [("tau_abs", tau_abs), ("tau_ray", tau_ray)] + [
        (f"increments[{i}].{q}", getattr(op, q))
        for i, op in enumerate(incs) for q in ("tau", "ssa", "g")]
    for pname, t in named:
        if t.dtype not in _FLOATS:
            raise TypeError(f"{name}: {pname} is {t.dtype}, expected "
                            "float32 or float64")
        if t.device != dev:
            raise ValueError(f"{name}: {pname} on {t.device}, tau_abs on "
                             f"{dev}")
    if len(shape) != ndim or tuple(tau_ray.shape) != shape:
        raise ValueError(f"{name}: tau_abs {shape} and tau_ray "
                         f"{tuple(tau_ray.shape)} must be one {ndim}-D shape")
    bands = tuple(int(b) for b in gpt2band)
    if len(bands) != shape[-1]:
        raise ValueError(f"{name}: {len(bands)} bands in gpt2band for "
                         f"G={shape[-1]}")
    if not bands or bands[0] < 0 or any(
            b1 < b0 for b0, b1 in zip(bands, bands[1:])):
        raise ValueError(f"{name}: gpt2band must be nondecreasing band "
                         "indices from 0")
    nbnd = incs[0].tau.shape[-1] if incs else None
    for pname, t in named[2:]:
        if tuple(t.shape) != shape[:-1] + (nbnd,):
            raise ValueError(f"{name}: {pname} has shape {tuple(t.shape)}, "
                             f"expected {shape[:-1] + (nbnd,)}")
    if incs and bands[-1] >= nbnd:
        raise ValueError(f"{name}: the increments have {nbnd} bands, "
                         f"gpt2band reaches band {bands[-1]}")
    return incs, bands


def _fused_takes_twin(tau_abs, tau_ray, incs, *rest):
    return takes_twin(tau_abs, tau_ray, *rest, *(
        getattr(op, q) for op in incs for q in ("tau", "ssa", "g")))


@functools.lru_cache(maxsize=64)
def _band_index(bands: tuple, device: torch.device) -> torch.Tensor:
    """A chunk's g-point bands as an int32 tensor on ``device`` (cached so
    the chunk loop does not copy it to the card on every call)."""
    return torch.tensor(bands, dtype=torch.int32, device=device)


def _sw_launch(name, plane, ncol, nlay, G, planes, mu0, sfc_alb_dir,
               sfc_alb_dif, inc_flux_dir, inc_flux_dif, fused=None):
    """Launch the SW kernel ``name`` (``sw_2stream`` or ``sw_2stream_lm``)
    on ``planes``: tau, ssa and g, or with ``fused`` = (increments, bands)
    its fused entry on tau_abs and tau_ray; counts a launch of ``name``."""
    dev, f32 = planes[0].device, torch.float32
    names = ("tau_abs", "tau_ray") if fused else ("tau", "ssa", "g")
    for pname, t in zip(names, planes):
        require(pname, t, dev, f32, plane)
    require("mu0", mu0, dev, f32, (ncol,))
    for pname, t in (("sfc_alb_dir", sfc_alb_dir),
                     ("sfc_alb_dif", sfc_alb_dif),
                     ("inc_flux_dir", inc_flux_dir)):
        require(pname, t, dev, f32, (ncol, G))
    if inc_flux_dif is not None:
        require("inc_flux_dif", inc_flux_dif, dev, f32, (ncol, G))
    bc = (mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir, inc_flux_dif)
    entry, band_args, incs = f"rrtmgp_{name}_f32", (), ()
    if fused is None:
        geo = sw_geometry(ncol, nlay, G, SW_TILE)
    else:
        incs, bands = fused
        cells = plane[:-1]
        ptrs = []
        for i, op in enumerate(incs):
            for q in ("tau", "ssa", "g"):
                t = getattr(op, q)
                require(f"increments[{i}].{q}", t, dev, f32,
                        cells + (t.shape[-1],))
                ptrs.append(t.data_ptr())
        geo = sw_geometry(ncol, nlay, G, SW_TILE, gpt2band=bands,
                          ninc=len(incs))
        entry = entry.replace("sw_2stream", "sw_2stream_fused")
        band_args = (*ptrs, *[None] * (3 * SW_INCREMENTS - len(ptrs)),
                     _band_index(bands, dev).data_ptr() if incs else None,
                     len(incs), incs[0].tau.shape[-1] if incs else 0,
                     geo.nbt)
    refuse_grad(name, *planes, *bc, *(getattr(op, q) for op in incs
                                      for q in ("tau", "ssa", "g")))
    up, dn, fdir = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    scratch = (torch.empty(geo.scratch_floats, dtype=f32, device=dev)
               if geo.scratch_floats else None)
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), entry)(
            *(t.data_ptr() for t in planes), *band_args,
            *(None if t is None else t.data_ptr() for t in bc),
            up.data_ptr(), dn.data_ptr(), fdir.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            ncol, nlay, G, geo.gt, geo.threads, config.k_min(f32),
            config.eps(f32), stream_handle(dev))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    if fused is not None:
        _build.SW_FUSED_GPTS["sw_2stream"] += G
    return up, dn + fdir, fdir
