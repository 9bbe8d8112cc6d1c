"""Wrapper of the gas-optics interpolation kernel (``csrc/gas_optics_interp.cu``).

Replaces ``rte_rrtmgp_tpu/ops/pallas/interp_kernel.py:725``
(``interp_cellw_multi``).  One launch per spectral chunk writes tau (major
gases times col_mix, minor intervals added) and either the Planck fraction
(LW) or the Rayleigh k before its column-amount factor (SW).  Its plain
twin is :func:`rte_rrtmgp_torch.ops.gas_optics.majmin_plain`.

A block takes a tile of cells of one layer across neighbouring columns,
times the chunk's G; :func:`interp_geometry` chooses the tile.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build
from ._checks import takes_twin, refuse_grad, require, stream_handle

TILE_CELLS = 32     # cells a block (measured: PERF.md §6, PR 3)
THREADS = 256       # threads a block


@dataclasses.dataclass(frozen=True)
class InterpGeometry:
    """Launch geometry of one call: the cell tile runs along ``axis`` of
    the (C, L) inputs (0: cells c*L + l at fixed l; 1: consecutive cells),
    ``tc`` cells and ``threads`` threads a block, ``smem_bytes`` of shared
    memory a block, ``blocks`` blocks."""

    axis: int
    tc: int
    threads: int
    smem_bytes: int
    blocks: int

    def describe(self) -> str:
        return (f"tile {self.tc} cells along axis {self.axis}, "
                f"{self.threads} threads, {self.smem_bytes} B smem")


def smem_words(tc: int, G: int, F: int, nspec: int, nent: int) -> int:
    """32-bit words of shared memory a block holds (``smem_words`` of the
    CUDA source): per cell itropo/jtemp/jpress, jeta and col_mix (2F
    each), fmajor (8F), fminor (4F) and the minor scalings (nspec); the
    chunk's g-point flavors (2G), quad flavors (2*ceil(G/4)), quad minor
    marks (ceil(G/4)), entry offsets (G+1) and entries (4 each)."""
    return tc * (3 + 16 * F + nspec) + 2 * G + 3 * ((G + 3) // 4) + G + 1 \
        + 4 * nent


def interp_geometry(C: int, L: int, G: int, F: int, nspec: int, nent: int,
                    tc: int = TILE_CELLS,
                    threads: int = THREADS) -> InterpGeometry:
    """The tile runs along the longer axis of the (C, L) inputs: the column
    axis in the default (ncol, nlay) call and in the layer-major
    (nlay, ncol) one at any batch wider than it is deep.  ``tc`` is halved
    until the block's shared memory fits."""
    axis = 1 if L > C else 0
    n_a, n_b = (L, C) if axis else (C, L)
    tc = max(1, min(tc, n_a))
    while tc > 1 and 4 * smem_words(tc, G, F, nspec, nent) > \
            _build.SMEM_PER_BLOCK:
        tc //= 2
    smem = 4 * smem_words(tc, G, F, nspec, nent)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"gas_optics_interp: {nent} minor entries and G={G} "
                         f"need {smem} B of shared memory a block")
    return InterpGeometry(axis, tc, threads, smem, -(-n_a // tc) * n_b)


def _same_intervals(lists) -> bool:
    """Four per-g entry lists with the same intervals and contributor
    columns c..c+3 from a multiple of 4."""
    if len(lists) != 4 or not lists[0]:
        return False
    if any(len(x) != len(lists[0]) for x in lists):
        return False
    return all(col % 4 == 0 and all(x[i] == (k, atm, col + v, f)
                                    for v, x in enumerate(lists))
               for i, (k, atm, col, f) in enumerate(lists[0]))


@functools.lru_cache(maxsize=64)
def _minor_entries(specs: tuple, G: int, device: torch.device):
    """Per-g lists of the minor intervals covering each g-point of a chunk:
    ``off`` (G+1,) int32 and ``ent`` (max(nent, 1), 4) int32 rows (interval
    index in ``specs`` order, atmosphere 0/1, contributor column, flavor),
    ordered by g and, within one g, by interval; ``nent`` the number of
    rows; ``quad`` (ceil(G/4),) int32, 1 where the four g-points 4q..4q+3
    have the same intervals with contributor columns c..c+3 from a multiple
    of 4 (the kernel then reads them four at a time)."""
    per_g = [[] for _ in range(G)]
    for k, (atm, s) in enumerate(specs):
        for gg in range(s.gpt_start, s.gpt_end):
            per_g[gg].append((k, atm, s.kminor_start + gg - s.gpt_start,
                              s.flavor))
    off = [0]
    rows = []
    for lst in per_g:
        rows.extend(lst)
        off.append(len(rows))
    quad = [int(_same_intervals(per_g[g:g + 4])) for g in range(0, G, 4)]
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return (as_i32(off), as_i32(rows or [(0, 0, 0, 0)]), len(rows),
            as_i32(quad))


def _check_extent(name: str, t: torch.Tensor) -> None:
    """The kernel indexes tables with 32-bit offsets."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    if last >= 2 ** 31:
        raise ValueError(f"{name}: {last + 1} elements exceed 32-bit offsets")


def gas_optics_interp(kd, interp, sc, rayleigh: bool):
    """tau and pfrac (LW) or tau_abs and krayl (SW, ``rayleigh``) for one
    spectral chunk ``kd`` (a :meth:`KDist.slice_gpt` view), each
    (ncol, nlay, G).  ``sc`` (ncol, nlay, nspec) is the per-interval minor
    scaling in :func:`gas_optics.minor_specs` order."""
    from .. import gas_optics

    tab_b = kd.krayl_rows if rayleigh else kd.planck_rows
    if takes_twin(kd.kmajor_rows, tab_b, kd.kminor_lower_trows,
                  kd.kminor_upper_trows, interp.col_mix, interp.fminor,
                  interp.fmajor, sc):
        return gas_optics.majmin_plain(kd, interp, sc, rayleigh)

    dev = kd.kmajor_rows.device
    f32, i32 = torch.float32, torch.int32
    C, L = interp.tropo.shape
    F = kd.nflav
    R, E, G = kd.kmajor_rows.shape
    specs = tuple(gas_optics.minor_specs(kd))
    for name, t in (("kmajor_rows", kd.kmajor_rows), ("table_b", tab_b)):
        require(name, t, dev, f32, contiguous=False)
        if t.stride(2) != 1 or t.shape[1:] != (E, G):
            raise ValueError(f"{name}: expected a g-contiguous (R, {E}, {G}) "
                             f"table, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
        _check_extent(name, t)
    kmin_lo, kmin_up = kd.kminor_lower_trows, kd.kminor_upper_trows
    require("kminor_lower_trows", kmin_lo, dev, f32)
    require("kminor_upper_trows", kmin_up, dev, f32)
    for name, t in (("jtemp0", interp.jtemp0), ("jpress0", interp.jpress0),
                    ("itropo01", interp.itropo01)):
        require(name, t, dev, i32, (C, L))
    require("jeta0", interp.jeta0, dev, i32, (C, L, 2 * F))
    require("col_mix", interp.col_mix, dev, f32, (C, L, 2 * F))
    require("fminor", interp.fminor, dev, f32, (C, L, 4 * F))
    require("fmajor", interp.fmajor, dev, f32, (C, L, 8 * F))
    require("sc", sc, dev, f32, (C, L, len(specs)))

    refuse_grad("gas_optics_interp", kd.kmajor_rows, tab_b, kmin_lo, kmin_up,
                interp.col_mix, interp.fminor, interp.fmajor, sc)
    gflav = gas_optics.gpoint_flavor_tensor(kd.gpoint_flavor, dev)
    ent_off, ent, nent, quad = _minor_entries(specs, G, dev)
    geo = interp_geometry(C, L, G, F, len(specs), nent, TILE_CELLS, THREADS)
    out_a = torch.empty((C, L, G), dtype=f32, device=dev)
    out_b = torch.empty((C, L, G), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().rrtmgp_gas_optics_interp_f32(
            kd.kmajor_rows.data_ptr(), kd.kmajor_rows.stride(0),
            kd.kmajor_rows.stride(1),
            tab_b.data_ptr(), tab_b.stride(0), tab_b.stride(1),
            int(rayleigh),
            kmin_lo.data_ptr(), kmin_lo.shape[2], kmin_up.data_ptr(),
            kmin_up.shape[2],
            interp.jtemp0.data_ptr(), interp.jpress0.data_ptr(),
            interp.itropo01.data_ptr(), interp.jeta0.data_ptr(),
            interp.col_mix.data_ptr(), interp.fminor.data_ptr(),
            interp.fmajor.data_ptr(), gflav.data_ptr(), sc.data_ptr(),
            len(specs), ent_off.data_ptr(), ent.data_ptr(), nent,
            quad.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), C, L, G, F,
            kd.ntemp, kd.neta, geo.axis, geo.tc, geo.threads,
            stream_handle(dev))
    _build.check(rc, "gas_optics_interp")
    _build.LAUNCHES["gas_optics_interp"] += 1
    return out_a, out_b
