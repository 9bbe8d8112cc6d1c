"""Tune the radiation step's spectral chunk and layout on the card.

Counterpart of the JAX package's ``tuning/tune_radiation.py``.  Times the
flagship step (``step.make_step``: 2048 columns x 72 layers, 256 LW + 224 SW
g-points, float32, clouds on) for ``gpt_chunk`` in {None, 128, 64} x layout
in {default, ``cellw=False``, ``layer_major=True``}.  The candidates run in
turns, ROUNDS rounds of STEPS synchronized steps each, because the host's
enqueue spreads the step times widely; the candidate with the fastest
median round wins, as in the JAX package.  Every candidate's median and
quartiles are kept under ``"all"``.

The winner goes to the tuner cache (``utils/tuner.py``) and to the
checked-in table ``rte_rrtmgp_torch/tuning/tuned_defaults.json`` (or
``--defaults PATH``), keyed by the card's device kind, with the card's name
and power limit.  It is a record: no solver reads it, the layout is the
caller's ``cellw`` / ``layer_major`` (``step.make_step``).

Usage (on a machine with a card):
    python -m rte_rrtmgp_torch.tuning.tune_radiation [--rounds 15] [--steps 5]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import config, step
from ..utils import tuner

CANDIDATES = [dict(gpt_chunk=chunk, cellw=cellw, layermajor=lm)
              for chunk in (None, 128, 64)
              for cellw, lm in ((1, 0), (0, 0), (1, 1))]


def sweep(tables, args, candidates, rounds: int, steps: int) -> list:
    """ms/step of each candidate: ``rounds`` rounds, the candidates in turns,
    ``steps`` synchronized steps a round.  Returns [(candidate, [ms, ...])]."""
    dev = tables[0].device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    fns = [step.make_step(*tables, gpt_chunk=c["gpt_chunk"],
                          cellw=bool(c["cellw"]),
                          layer_major=bool(c["layermajor"]))
           for c in candidates]
    for fn in fns:           # first calls: allocations, kernel build
        fn(*args)
    sync()
    times = [[] for _ in candidates]
    for _ in range(rounds):
        for fn, ts in zip(fns, times):
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(*args)
            sync()
            ts.append((time.perf_counter() - t0) / steps * 1e3)
    return list(zip(candidates, times))


def summarize(results) -> dict:
    """The tuner entry: the fastest median, every candidate's median and
    quartiles."""
    rows = []
    for cand, ts in results:
        q1, med, q3 = (float(x) for x in np.percentile(ts, [25, 50, 75]))
        rows.append({"config": cand, "ms": med, "q1": q1, "q3": q3})
    rows.sort(key=lambda r: r["ms"])
    return {"config": rows[0]["config"], "ms": rows[0]["ms"], "all": rows}


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ncol", type=int, default=2048)
    p.add_argument("--nlay", type=int, default=72)
    p.add_argument("--rounds", type=int, default=15)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--defaults", default=tuner.defaults_path(),
                   help="checked-in winners table to update")
    a = p.parse_args(argv)
    if a.rounds < 10:
        p.error("--rounds must be at least 10 (the host's spread is wide)")

    dev = config.resolve_device("cuda")
    card = _card()
    tables = step.build_tables(16, dtype=torch.float32, device=dev)
    arrs = step.atmos_arrays(a.ncol, a.nlay)
    args = [torch.as_tensor(arrs[k], device=dev) for k in step.ARG_NAMES]
    entry = summarize(sweep(tables, args, CANDIDATES, a.rounds, a.steps))
    entry.update(card=card, rounds=a.rounds, steps=a.steps)

    print(f"[tune] {card}; {a.ncol}x{a.nlay}, {a.rounds} rounds of {a.steps} "
          "steps, candidates in turns; ms/step median (quartiles)")
    for row in entry["all"]:
        print(f"[tune] {json.dumps(row['config'], sort_keys=True)}: "
              f"{row['ms']:.3f} ({row['q1']:.3f}-{row['q3']:.3f})")
    print(f"[tune] winner: {json.dumps(entry['config'], sort_keys=True)} "
          f"({entry['ms']:.3f} ms/step)")

    k = tuner.key("radiation_step", {"ncol": a.ncol, "nlay": a.nlay},
                  tuner.device_kind(dev))
    tuner.persist(k, entry)
    try:
        with open(a.defaults) as f:
            defaults = json.load(f)
    except FileNotFoundError:
        defaults = {}
    defaults[k] = entry
    with open(a.defaults, "w") as f:
        json.dump(defaults, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"[tune] persisted to {tuner._cache_path()} and {a.defaults}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
