"""Tune the backward (camera) renderer's knobs on the card.

The port's copy of the JAX package's ``tuning/tune_bw.py``: the same sweep
(respawn mode: pool launch table vs fifo ray queue, x spectral steps a
window) at the flagship frame (``tools/bench_bw``: a CAM x CAM broadband
fisheye frame, PPP photons a pixel, 14 spectral steps), the candidates in
turns, ROUNDS rounds of one synchronized frame each; the fastest median
wins and every candidate's median and quartiles are kept under ``"all"``.

The winner goes to the tuner cache (``utils/tuner.py``) and to the
checked-in table ``rte_rrtmgp_torch/tuning/tuned_defaults.json`` (or
``--defaults PATH``) under the ``bw_render`` key of the card's device kind,
with the card's name and power limit.  ``trace_rays_bw(respawn_mode=
"auto")`` — what ``RadiationSolverBW`` asks for — then resolves
``RTE_RRTMGP_BW_RESPAWN`` > this winner's respawn mode > ``pool``.

The sweep must be one where the modes differ: below 65,536 camera rays
(64x64 px at 8 photons a pixel and less) every lane traces one ray, no
lane respawns, and pool and fifo run the same loop, so the tuner refuses
such a frame; it refuses fewer than 3 rounds too.  Check a winner in only
where it beats pool by more than the quartile spread: ``auto`` reads it
for every render on the card.

All in one process: the renderer takes its knobs as arguments.

Usage (on a machine with a card):
    python -m rte_rrtmgp_torch.tuning.tune_bw [--cam 64] [--ppp 16] [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import config
from ..models import raytracer_bw
from ..tools import bench_bw
from ..utils import tuner
from .tune_radiation import _card
from .tune_rt import summarize

CANDIDATES = [
    {"respawn_mode": "pool", "steps_per_dispatch": 4},
    {"respawn_mode": "fifo", "steps_per_dispatch": 4},
    {"respawn_mode": "fifo", "steps_per_dispatch": 14},
]


def sweep(cam: int, ppp: int, candidates, rounds: int, device):
    """ms of one frame for each candidate: ``rounds`` rounds, the
    candidates in turns, one synchronized frame (a new seed) each.
    Returns [(candidate, [ms, ...])]."""
    renders = [bench_bw.make_render(cam, ppp, device=device, **cand)[0]
               for cand in candidates]
    sync = lambda: torch.cuda.synchronize(device) \
        if device.type == "cuda" else None
    times = [[] for _ in candidates]
    for r in range(rounds):
        for i, render in enumerate(renders):
            sync()
            t0 = time.perf_counter()
            render(1 + r)
            sync()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return list(zip(candidates, times))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cam", type=int, default=64)
    p.add_argument("--ppp", type=int, default=16)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--defaults", default=tuner.defaults_path(),
                   help="checked-in winners table to update")
    a = p.parse_args(argv)
    n_rays = a.cam * a.cam * a.ppp
    if raytracer_bw.default_rays_per_lane(n_rays, a.ppp) < 2:
        p.error(f"{a.cam}x{a.cam} px at {a.ppp} ppp: {n_rays} camera rays, "
                "one a lane, so no lane respawns and the modes cannot differ")
    if a.rounds < 3:
        p.error("--rounds: at least 3 (a median and its quartiles)")

    dev = config.resolve_device("cuda")
    card = _card()
    entry = summarize(sweep(a.cam, a.ppp, CANDIDATES, a.rounds, dev))
    entry.update(card=card, rounds=a.rounds)
    print(f"[tune_bw] {card}; {a.cam}x{a.cam} px broadband fisheye, {a.ppp} "
          f"ppp, 14 spectral steps, {a.rounds} rounds, candidates in turns; "
          "ms a frame median (quartiles)")
    for row in entry["all"]:
        print(f"[tune_bw] {json.dumps(row['config'], sort_keys=True)}: "
              f"{row['ms']:.1f} ({row['q1']:.1f}-{row['q3']:.1f})")
    print(f"[tune_bw] winner: {json.dumps(entry['config'], sort_keys=True)} "
          f"({entry['ms']:.1f} ms)")

    k = tuner.key("bw_render", {"cam": a.cam, "ppp": a.ppp},
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
    print(f"[tune_bw] persisted to {tuner._cache_path()} and {a.defaults}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
