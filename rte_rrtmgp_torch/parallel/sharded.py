"""Sharded execution of the radiation solve and of the flagship step.

Counterpart of the JAX package's ``parallel/sharded.py`` (the
``shard_map`` column path) and of its annotation path (``parallel/mesh.py``
with ``__graft_entry__.dryrun_multichip``), split by hand:

* :func:`sharded_columns_call` runs the full single-device
  ``_solve_*_impl`` on each column slab of a cols-only mesh, each under its
  own device, and concatenates the outputs on the column axis: no
  communication inside the solve.  It backs ``RadiationSolverLW/SW.solve(
  mesh=...)``.
* :func:`sharded_step` runs the flagship step on a (cols, gpt) mesh:
  position (c, g) takes column slab c with the g-th g-slice of the tables,
  the partial broadband fluxes are summed over the ``gpt`` axis (a sum on
  the output device in one process, ``torch.distributed.all_reduce`` over
  the ``gpt`` group across processes), then concatenated over ``cols``.

Kernels: :func:`sharded_columns_call` matches JAX's ``shard_map`` path,
which turns its Pallas kernels back on inside each shard.  The g-sharded
step differs: JAX's annotation path turns Pallas off on a multi-device
mesh (``config.py:145-163``), because XLA's partitioner cannot split a
custom call, where the port splits by hand and runs the CUDA kernels on
every shard.  A shard's launch count comes from its own column slab and
g-slice (its chunks are counted from its own ``ngpt``).

A g-split sums the g-points in another order, so float32 fluxes agree with
the unsharded step to rounding, not bit for bit.
"""

from __future__ import annotations

import contextlib

import torch

from .mesh import Mesh, Placed, replicate, shard_atmosphere, shard_kdist

def cols_only(mesh: Mesh) -> bool:
    """True when the mesh shards nothing but the column axis."""
    return mesh.size("gpt") == 1


def on_device(device: torch.device):
    """Make ``device`` current for the block (the kernels also select
    their tensors' device themselves)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _gather_cols(per_col: dict, device: torch.device) -> dict:
    """{c: outputs} -> outputs concatenated over c on ``device``."""
    outs = [per_col[c] for c in sorted(per_col)]
    return {k: torch.cat([o[k].to(device) for o in outs], dim=0)
            for k in outs[0]}


def sharded_columns_call(mesh: Mesh, impl, n_replicated: int, args,
                         static_kw: dict) -> dict:
    """``impl(*args, **static_kw)`` on each column slab of ``mesh``.

    The first ``n_replicated`` positional args (tables, LUTs) replicate
    (copied once a device, cached on the mesh); every later arg splits on
    its leading (column) axis, which must divide over ``cols``.  The
    outputs are column-leading and come back concatenated on the mesh's
    first device."""
    if not cols_only(mesh):
        raise ValueError("sharded_columns_call needs a cols-only mesh; "
                         "shard the gpt axis via sharded_step instead")
    if mesh.ranks is not None and mesh.ranks.size > 1:
        raise ValueError("sharded_columns_call takes a mesh of this "
                         "process's devices; across processes use "
                         "sharded_step")
    reps = replicate(mesh, tuple(args[:n_replicated]))
    cols = shard_atmosphere(mesh, tuple(args[n_replicated:]))
    per_col = {}
    for pos, dev in mesh.local_positions():
        with on_device(dev):
            per_col[pos[0]] = impl(*reps.parts[pos], *cols.parts[pos],
                                   **static_kw)
    return _gather_cols(per_col, mesh.first_device)


def sharded_step(mesh: Mesh, kd_lw, kd_sw, clut_lw, clut_sw, gpt_chunk=None,
                 cellw=None, layer_major=None):
    """The flagship step (``step.make_step``) on a (cols, gpt) mesh.

    The returned ``step(*args)`` takes the step's 16 arrays (global ones,
    split here over ``cols``) or one :class:`Placed` tuple of them (from
    :func:`shard_atmosphere` or ``distributed.host_shard_columns``) and
    returns the step's dict of fluxes for this process's column slabs,
    concatenated on the mesh's first local device: every column in one
    process, the process's own slab across processes (as JAX's
    process-local arrays are)."""
    from ..step import make_step

    kdl, kds = shard_kdist(kd_lw, mesh), shard_kdist(kd_sw, mesh)
    luts = replicate(mesh, (clut_lw, clut_sw))
    steps = {pos: make_step(kdl.parts[pos], kds.parts[pos],
                            *luts.parts[pos], gpt_chunk=gpt_chunk,
                            cellw=cellw, layer_major=layer_major)
             for pos, _ in mesh.local_positions()}
    gpt_group = mesh.groups.get("gpt")

    def step(*args):
        placed = (args[0] if len(args) == 1 and isinstance(args[0], Placed)
                  else shard_atmosphere(mesh, tuple(args)))
        per_col = {}
        for pos, dev in mesh.local_positions():
            with on_device(dev):
                out = steps[pos](*placed.parts[pos])
            c = pos[0]
            if c in per_col:   # another g-slice of slab c: add it there
                acc = per_col[c]
                per_col[c] = {k: acc[k] + v.to(acc[k].device)
                              for k, v in out.items()}
            else:
                per_col[c] = out
        if gpt_group is not None:
            (c, out), = per_col.items()
            names = sorted(out)
            dev = out[names[0]].device
            with on_device(dev):
                stacked = torch.stack([out[k] for k in names])
                torch.distributed.all_reduce(stacked, group=gpt_group)
            per_col[c] = dict(zip(names, stacked.unbind(0)))
        return _gather_cols(per_col, mesh.first_device)

    return step
