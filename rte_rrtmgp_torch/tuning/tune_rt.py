"""Tune the forward MC tracer's loop knobs on the card.

Counterpart of the JAX package's ``tuning/tune_rt.py``: times the tracer
(``models/raytracer.trace_rays``) at the bench workload
(``tools/bench_rt.make_fields``: 64x64 columns x NZ layers, PPP photons a
pixel, one g-point, knull (4, 4, 4)) for the candidates (respawn_mode,
compact_floor, photons_per_lane) below, in turns, ROUNDS rounds of one
synchronized trace each; the candidate with the fastest median wins.
Every candidate's median and quartiles are kept under ``"all"``.

The winner goes to the tuner cache (``utils/tuner.py``) and to the
checked-in table ``rte_rrtmgp_torch/tuning/tuned_defaults.json`` (or
``--defaults PATH``) under the ``rt_trace`` key of the card's device kind,
with the card's name and power limit.  ``trace_rays(respawn_mode="auto")``
— what ``RadiationSolverRT`` asks for — then resolves
``RTE_RRTMGP_RT_RESPAWN`` > this winner > ``fifo``.

All in one process: the tracer reads its knobs at call time.

Usage (on a machine with a card):
    python -m rte_rrtmgp_torch.tuning.tune_rt [--nx 64] [--nz 256] [--ppp 32]
        [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import config
from ..models import raytracer as rt
from ..tools import bench_rt
from ..utils import tuner
from .tune_radiation import _card

CANDIDATES = ([dict(respawn_mode=mode, compact_floor=floor)
               for mode in ("fifo", "arith") for floor in (128, 512)]
              + [dict(respawn_mode="fifo", compact_floor=128,
                      photons_per_lane=1)])


def sweep(nx: int, nz: int, ppp: int, candidates, rounds: int, device):
    """ms of one trace for each candidate: ``rounds`` rounds, the
    candidates in turns, one synchronized trace (a new seed) each.
    Returns [(candidate, [ms, ...])]."""
    fields = [torch.as_tensor(f, device=device)
              for f in bench_rt.make_fields(nz, nx, nx)]
    alb = torch.full((nx, nx), bench_rt.ALBEDO, device=device)
    sun = rt.sun_direction_from_angles(bench_rt.SZA, 0.0)

    def trace(cand, seed):
        return rt.trace_rays(seed, *fields, None, alb, (4, 4, 4),
                             bench_rt.GRID_D, bench_rt.TOD_FLUX, 0.0, sun,
                             photons_per_pixel=ppp, **cand)

    sync = lambda: torch.cuda.synchronize(device) \
        if device.type == "cuda" else None
    for cand in candidates:      # first calls: allocations
        trace(cand, 0)
    sync()
    times = [[] for _ in candidates]
    for r in range(rounds):
        for i, cand in enumerate(candidates):
            sync()
            t0 = time.perf_counter()
            trace(cand, 1 + r)
            sync()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return list(zip(candidates, times))


def summarize(results) -> dict:
    rows = []
    for cand, ts in results:
        q1, med, q3 = (float(x) for x in np.percentile(ts, [25, 50, 75]))
        rows.append({"config": cand, "ms": med, "q1": q1, "q3": q3})
    rows.sort(key=lambda r: r["ms"])
    return {"config": rows[0]["config"], "ms": rows[0]["ms"], "all": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nz", type=int, default=256)
    p.add_argument("--ppp", type=int, default=32)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--defaults", default=tuner.defaults_path(),
                   help="checked-in winners table to update")
    a = p.parse_args(argv)

    dev = config.resolve_device("cuda")
    card = _card()
    entry = summarize(sweep(a.nx, a.nz, a.ppp, CANDIDATES, a.rounds, dev))
    entry.update(card=card, rounds=a.rounds)
    photons = a.nx * a.nx * a.ppp
    print(f"[tune_rt] {card}; {a.nx}x{a.nx}x{a.nz}, {a.ppp} ppp, knull "
          f"(4,4,4), {a.rounds} rounds, candidates in turns; ms a trace "
          "median (quartiles)")
    for row in entry["all"]:
        print(f"[tune_rt] {json.dumps(row['config'], sort_keys=True)}: "
              f"{row['ms']:.3f} ({row['q1']:.3f}-{row['q3']:.3f}) = "
              f"{photons / row['ms'] * 1e3:.1f} photons/s")
    print(f"[tune_rt] winner: {json.dumps(entry['config'], sort_keys=True)} "
          f"({entry['ms']:.3f} ms)")

    k = tuner.key("rt_trace", {"nx": a.nx, "nz": a.nz, "ppp": a.ppp},
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
    print(f"[tune_rt] persisted to {tuner._cache_path()} and {a.defaults}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
