"""Readings that the limits of ``benchmark/limits/`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ...
        [--control-seeds 1 2 3] [--calls 3]

For each seed: the cell's inputs, its entry run ``--calls`` times at the
cell's own size (as a run's set-up and a short window would), the
outputs of the last call held to the float64 reference: each compared
number of the cell (the lower reading is the largest over sound seeds).
For each control seed the control takes the program's place: the
reference computed in the nearest precision below the configuration's
(bfloat16 below float32: no step of the call multiplies matrices, so TF32
does not apply; float32 below float64), held to the float64 reference
(the upper reading is the smallest).  One JSON line a reading; the benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402

CONTROL = {torch.float32: torch.bfloat16, torch.float64: torch.float32}


def reading(bench, cell_name, seed, side, calls, dev) -> dict:
    """One reading of every compared number of a cell: ``side`` "program"
    (the entry's last of ``calls`` calls) or "control" (the reference one
    precision below the configuration's), each held to the float64
    reference."""
    t0 = time.perf_counter()
    cell = run.Cell(bench, cell_name, seed)
    refmod = importlib.import_module(cell.config["reference"])
    entry = run.make_entry(cell, dev)
    ref_inputs = entry.reference_inputs()
    options = {"delta_cloud": entry.delta_cloud, "guard_dtype": cell.dtype}
    if side == "program":
        for _ in range(calls):
            out = entry.call()
        got = run._host(out)
        del out
    entry.close()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    expected = refmod.outputs(cell.raws, ref_inputs, options, dev)
    if side == "control":
        got = refmod.outputs(cell.raws, ref_inputs, options, dev,
                             dtype=CONTROL[cell.dtype])
    checks = run._check({0: got}, expected, cell.limits)
    return {"workload": cell_name, "seed": seed, "side": side,
            "checks": {k: v["value"] for k, v in checks.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    bench = run._json(ROOT / "BENCHMARK.json")
    for w in a.workload:
        for seed in a.seeds:
            print(json.dumps(reading(bench, w, seed, "program", a.calls,
                                  torch.device(a.device))), flush=True)
        for seed in a.control_seeds:
            print(json.dumps(reading(bench, w, seed, "control", a.calls,
                                  torch.device(a.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
