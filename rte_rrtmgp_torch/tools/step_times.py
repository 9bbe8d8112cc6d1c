"""ms per flagship step (2048 columns x 72 layers, 256 LW + 224 SW
g-points, gpt_chunk 128, float32) of each of the three layouts, timed in
turns over many rounds, on one NVIDIA card.

    python3 -m rte_rrtmgp_torch.tools.step_times [--rounds R] [--steps N]

A round runs N synchronized steps of each layout in turn (host clock
around the N steps, after one warm-up step each); the last line is one
JSON object with every round's ms per step.  It uses only
``step.make_step`` and its inputs, so the same file times an older
checkout of the package (run it from that checkout's root) in the same
call, in alternation, when the card's host is too noisy for one run each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

NCOL, NLAY = 2048, 72
GPT_PER_BAND, GPT_CHUNK = 16, 128
LAYOUTS = {"default": dict(cellw=True, layer_major=False),
           "cellw_off": dict(cellw=False, layer_major=False),
           "layer_major": dict(cellw=True, layer_major=True)}


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_times: no CUDA device is available", file=sys.stderr)
        return 2
    from rte_rrtmgp_torch import step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    dev = torch.device("cuda")
    tables = step.build_tables(GPT_PER_BAND, dtype=torch.float32, device=dev)
    arrs = step.atmos_arrays(NCOL, NLAY, seed=0)
    inputs = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
    steps = {name: step.make_step(*tables, gpt_chunk=GPT_CHUNK, **kw)
             for name, kw in LAYOUTS.items()}
    for run_step in steps.values():
        run_step(*inputs)
    torch.cuda.synchronize()
    ms = {name: [] for name in steps}
    for _ in range(args.rounds):
        for name, run_step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                run_step(*inputs)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / args.steps * 1e3)
    for name, v in ms.items():
        s = sorted(v)
        print(f"[step_times] {name}: median {s[len(s) // 2]:.3f} ms/step, "
              f"min {s[0]:.3f}, max {s[-1]:.3f} ({args.rounds} rounds of "
              f"{args.steps} steps)")
    print(json.dumps({"card": card, "ms_per_step": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
