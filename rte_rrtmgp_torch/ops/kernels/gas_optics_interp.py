"""Wrapper of the gas-optics interpolation kernel (``csrc/gas_optics_interp.cu``).

Replaces ``rte_rrtmgp_tpu/ops/pallas/interp_kernel.py:725``
(``interp_cellw_multi``).  One launch per spectral chunk writes tau (major
gases times col_mix, minor intervals added) and either the Planck fraction
(LW) or the Rayleigh k before its column-amount factor (SW).  Its plain
twin is :func:`rte_rrtmgp_torch.ops.gas_optics.majmin_plain`.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from ._checks import on_cpu, require, stream_handle


@functools.lru_cache(maxsize=64)
def _minor_entries(specs: tuple, G: int, device: torch.device):
    """Per-g lists of the minor intervals covering each g-point of a chunk:
    ``off`` (G+1,) int32 and ``ent`` (nent, 4) int32 rows (interval index in
    ``specs`` order, atmosphere 0/1, contributor column, flavor), ordered by
    g and, within one g, by interval."""
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
    ent = torch.tensor(rows or [(0, 0, 0, 0)], dtype=torch.int32,
                       device=device)
    return torch.tensor(off, dtype=torch.int32, device=device), ent


def gas_optics_interp(kd, interp, sc, rayleigh: bool):
    """tau and pfrac (LW) or tau_abs and krayl (SW, ``rayleigh``) for one
    spectral chunk ``kd`` (a :meth:`KDist.slice_gpt` view), each
    (ncol, nlay, G).  ``sc`` (ncol, nlay, nspec) is the per-interval minor
    scaling in :func:`gas_optics.minor_specs` order."""
    from .. import gas_optics

    if on_cpu(kd.kmajor_rows):
        return gas_optics.majmin_plain(kd, interp, sc, rayleigh)

    dev = kd.kmajor_rows.device
    f32, i32 = torch.float32, torch.int32
    C, L = interp.tropo.shape
    N = C * L
    F = kd.nflav
    R, E, G = kd.kmajor_rows.shape
    specs = tuple(gas_optics.minor_specs(kd))
    tab_b = kd.krayl_rows if rayleigh else kd.planck_rows
    for name, t in (("kmajor_rows", kd.kmajor_rows), ("table_b", tab_b)):
        require(name, t, dev, f32, contiguous=False)
        if t.stride(2) != 1 or t.shape[1:] != (E, G):
            raise ValueError(f"{name}: expected a g-contiguous (R, {E}, {G}) "
                             f"table, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
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

    gflav = gas_optics.gpoint_flavor_tensor(kd.gpoint_flavor, dev)
    ent_off, ent = _minor_entries(specs, G, dev)
    out_a = torch.empty((C, L, G), dtype=f32, device=dev)
    out_b = torch.empty((C, L, G), dtype=f32, device=dev)
    rc = _build.library().rrtmgp_gas_optics_interp_f32(
        kd.kmajor_rows.data_ptr(), kd.kmajor_rows.stride(0),
        kd.kmajor_rows.stride(1),
        tab_b.data_ptr(), tab_b.stride(0), tab_b.stride(1), int(rayleigh),
        kmin_lo.data_ptr(), kmin_lo.shape[2], kmin_up.data_ptr(),
        kmin_up.shape[2],
        interp.jtemp0.data_ptr(), interp.jpress0.data_ptr(),
        interp.itropo01.data_ptr(), interp.jeta0.data_ptr(),
        interp.col_mix.data_ptr(), interp.fminor.data_ptr(),
        interp.fmajor.data_ptr(), gflav.data_ptr(), sc.data_ptr(), len(specs),
        ent_off.data_ptr(), ent.data_ptr(), out_a.data_ptr(),
        out_b.data_ptr(), N, G, F, kd.ntemp, kd.neta, stream_handle(dev))
    _build.check(rc, "gas_optics_interp")
    _build.LAUNCHES["gas_optics_interp"] += 1
    return out_a, out_b
