"""Wrappers of the weight-plane interpolation kernel (``csrc/interp_rows.cu``).

* :func:`interp_rows_multi` replaces
  ``rte_rrtmgp_tpu/ops/pallas/interp_kernel.py:862`` (``interp_rows_multi``):
  two tables (kmajor + planck_frac, or kmajor + krayl) over the same
  precomputed per-g weight planes in one launch;
* :func:`interp_rows` replaces ``interp_kernel.py:977``
  (``interp_rows_pallas``): one table, including the minor pass whose "g"
  axis is the contributor axis.

Both launch the same kernel (a one-op multi, as the TPU's single-op entry
hands off to the multi kernel).  Their plain twin is
:func:`rte_rrtmgp_torch.ops.gas_optics.interp_rows_plain`.

Operands: ``tables`` (R, neta, G) with g contiguous (chunk views of the full
tables are read in place); per op ``rows`` (N, 4) for the 4-corner form
(rows i0p0, i0p1, i1p0, i1p1, blended by ``fp``) or (N, 2) for the 2-corner
form; shared ``jes`` = 2 int32 eta-index planes and ``fms`` = 4 fminor
planes (itemp*2 + deta order), each (N, G); ``fp`` (N,); per op ``cms`` =
the 2 col_mix planes or None.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import takes_twin, refuse_grad, require, stream_handle


def _launch(name, tables, rows_list, jes, fms, fp, cms_list):
    dev, f32, i32 = jes[0].device, torch.float32, torch.int32
    N, G = jes[0].shape
    for k, t in enumerate(jes):
        require(f"jes[{k}]", t, dev, i32, (N, G))
    for k, t in enumerate(fms):
        require(f"fms[{k}]", t, dev, f32, (N, G))
    if any(r.shape[1] == 4 for r in rows_list):
        if fp is None:
            raise ValueError(f"{name}: the 4-corner form needs fp")
        require("fp", fp, dev, f32, (N,))
    ops = []
    for k, (tab, rows, cms) in enumerate(zip(tables, rows_list, cms_list)):
        require(f"tables[{k}]", tab, dev, f32, contiguous=False)
        if tab.dim() != 3 or tab.shape[2] != G or tab.stride(2) != 1:
            raise ValueError(f"{name}: tables[{k}] must be a g-contiguous "
                             f"(R, neta, {G}) table, got shape "
                             f"{tuple(tab.shape)} strides {tab.stride()}")
        if rows.dim() != 2 or rows.shape[1] not in (2, 4):
            raise ValueError(f"{name}: rows[{k}] must be (N, 2) or (N, 4), "
                             f"got {tuple(rows.shape)}")
        require(f"rows[{k}]", rows, dev, i32, (N, rows.shape[1]))
        if cms is not None:
            for i, t in enumerate(cms):
                require(f"cms[{k}][{i}]", t, dev, f32, (N, G))
        out = torch.empty((N, G), dtype=f32, device=dev)
        ops.append((tab, rows, cms, out))
    refuse_grad(name, *fms, fp, *tables,
                *(t for cms in cms_list if cms is not None for t in cms))
    args = []
    for tab, rows, cms, out in ops + [(None, None, None, None)] * (2 - len(ops)):
        if tab is None:
            args += [None, 0, 0, None, 0, None, None, None]
            continue
        args += [tab.data_ptr(), tab.stride(0), tab.stride(1),
                 rows.data_ptr(), rows.shape[1],
                 None if cms is None else cms[0].data_ptr(),
                 None if cms is None else cms[1].data_ptr(), out.data_ptr()]
    with torch.cuda.device(dev):
        rc = _build.library().rrtmgp_interp_rows_f32(
            len(ops), *args, *(t.data_ptr() for t in jes),
            *(t.data_ptr() for t in fms),
            None if fp is None else fp.data_ptr(), N, G, stream_handle(dev))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return [out for _, _, _, out in ops]


def interp_rows_multi(tables, rows_list, jes, fms, fp, cms_list):
    """Two (or one) tables interpolated over shared weight planes in one
    launch.  Returns a list of (N, G) outputs, one per table."""
    if len(tables) not in (1, 2) or not (len(tables) == len(rows_list)
                                         == len(cms_list)):
        raise ValueError("interp_rows_multi: one or two tables, each with "
                         "its rows and col_mix planes (or None)")
    if takes_twin(*fms, fp, *tables,
                  *(c for cms in cms_list if cms is not None for c in cms)):
        from ..gas_optics import interp_rows_plain
        return interp_rows_plain(tables, rows_list, jes, fms, fp, cms_list)
    return _launch("interp_rows_multi", tables, rows_list, jes, fms, fp,
                   cms_list)


def interp_rows(table, rows, jes, fms, fp=None, cms=None):
    """One table interpolated over precomputed weight planes: (N, G)."""
    if takes_twin(*fms, fp, table, *(cms or ())):
        from ..gas_optics import interp_rows_plain
        return interp_rows_plain([table], [rows], jes, fms, fp, [cms])[0]
    return _launch("interp_rows", [table], [rows], jes, fms, fp, [cms])[0]
