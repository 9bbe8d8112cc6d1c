"""Multi-process smoke run: the flagship LW + SW step across N processes.

Counterpart of the JAX package's ``tools/multihost_smoke.py``.  Every
process runs this same program, e.g. two processes on the CPU:

    for i in 0 1; do
      python -m rte_rrtmgp_torch.tools.multihost_smoke --device cpu \\
          --coordinator 127.0.0.1:12421 --num-processes 2 --process-id $i &
    done; wait

or two processes sharing one card, the ``gpt`` axis across them:

    ... --device cuda:0 --gpt-shards 2 ...

Each process loads only its own column slab of the same seeded global
atmosphere (``step.atmos_arrays``, ``--ncol-per-process`` columns a
process), the processes form one (cols, gpt) mesh (``--gpt-shards``
processes on ``gpt``), and ``parallel.sharded.sharded_step`` runs the step.
The global means are reduced by all-reduce, and each process prints one
line ``RESULT <process_id> <lw_flux_up mean> <sw_flux_dn mean> <order
check>`` (repr digits), the same in every process.  The order check is the
mean of ``lw_flux_up + sw_flux_dn`` with column i weighted by i + 1 (global
column index): it moves when columns land in the wrong place, where the
plain means do not.  With no coordinator (and none in the
``RTE_RRTMGP_*`` environment) it runs one process.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coordinator", default=None, help="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--ncol-per-process", type=int, default=32)
    p.add_argument("--nlay", type=int, default=24)
    p.add_argument("--gpt-per-band", type=int, default=2)
    p.add_argument("--gpt-chunk", type=int, default=None)
    p.add_argument("--gpt-shards", type=int, default=1,
                   help="processes on the mesh's gpt axis")
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:<local rank>), cuda:N or cpu")
    p.add_argument("--precision", default="float32",
                   choices=("float32", "float64"))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import step
    from ..parallel import distributed as dist
    from ..parallel.sharded import on_device, sharded_step

    dev = dist.initialize(args.coordinator, args.num_processes,
                          args.process_id, device=args.device)
    pid, nproc = dist.process_index(), dist.process_count()
    k = args.gpt_shards
    if nproc % k:
        raise SystemExit(f"--gpt-shards {k} does not divide {nproc} "
                         "processes")
    mesh = dist.make_global_mesh(None if k == 1 else (nproc // k, k))
    dtype = getattr(torch, args.precision)

    tables = step.build_tables(args.gpt_per_band, dtype=dtype, device=dev)
    n = args.ncol_per_process
    ncol = n * nproc
    arrs = step.atmos_arrays(ncol, args.nlay,
                             dtype=np.dtype(args.precision))
    local = tuple(arrs[name][pid * n:(pid + 1) * n]
                  for name in step.ARG_NAMES)
    placed = dist.host_shard_columns(mesh, local)
    out = sharded_step(mesh, *tables, gpt_chunk=args.gpt_chunk)(placed)

    # This process's output is its cols slab; the processes of one gpt
    # group hold the same slab, so the global sums run over a cols group.
    ((c, _), _), = mesh.local_positions()
    with on_device(dev):
        sums = slab_sums(out, c * out["lw_flux_up"].shape[0])
        group = mesh.groups.get("cols")
        if group is not None:
            torch.distributed.all_reduce(sums, group=group)
    values = result_values(sums, ncol, args.nlay + 1)
    dist.shutdown()
    print(f"RESULT {pid} " + " ".join(repr(v) for v in values), flush=True)
    return 0


def slab_sums(out, col0: int):
    """float64 sums over a slab of columns [col0, col0 + n): of
    ``lw_flux_up``, of ``sw_flux_dn``, and of their sum with column i
    weighted by i + 1."""
    import torch

    lw, sw = out["lw_flux_up"].double(), out["sw_flux_dn"].double()
    w = torch.arange(col0 + 1, col0 + 1 + lw.shape[0], dtype=torch.float64,
                     device=lw.device)
    return torch.stack([lw.sum(), sw.sum(), (w[:, None] * (lw + sw)).sum()])


def result_values(sums, ncol: int, nlev: int) -> list:
    """The ``RESULT`` numbers from the global :func:`slab_sums`: the means
    of ``lw_flux_up`` and ``sw_flux_dn``, and the order check."""
    lw, sw, weighted = sums.tolist()
    n = ncol * nlev
    return [lw / n, sw / n, weighted / (n * (ncol + 1) / 2)]


if __name__ == "__main__":
    sys.exit(main())
