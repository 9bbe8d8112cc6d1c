"""Runtime autotuner with a persisted winner cache.

Counterpart of the JAX package's ``utils/tuner.py`` (itself the analog of
the reference's CUDA block-size ``Tuner``, ``include/tuner.h:79-182``):
benchmarks candidate configurations of a workload on the device it runs on
and persists the winners to a JSON cache keyed by (workload, static
config, device kind).

Usage::

    cfg = autotune("radiation_step", candidates=[{"gpt_chunk": 128}, ...],
                   build=lambda cand: make_step(..., **cand), args=args)

The device kind is ``"cuda:" + torch.cuda.get_device_name(dev)`` for a
CUDA device and ``"cpu"`` for the CPU, taken from the device a solve runs
on: a CPU solve never reads a card's winner.  Winners come from the
checked-in table ``rte_rrtmgp_torch/tuning/tuned_defaults.json`` (measured
on the card it names), then the user cache ``RTE_RRTMGP_TUNER_CACHE``
(default ``~/.cache/rte_rrtmgp_torch/tuning.json``) on top.  Set
``RTE_RRTMGP_TUNER_DISABLE=1`` to always take the first candidate.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

_lock = threading.Lock()
_memory_cache: Dict[str, dict] = {}
_disk_loaded = False


def _cache_path() -> str:
    return os.environ.get(
        "RTE_RRTMGP_TUNER_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "rte_rrtmgp_torch",
                     "tuning.json"))


def defaults_path() -> str:
    """The checked-in winners table (package data)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tuning", "tuned_defaults.json")


def _load_disk() -> None:
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    for path in (defaults_path(), _cache_path()):
        try:
            with open(path) as f:
                _memory_cache.update(json.load(f))
        except (OSError, ValueError):
            pass


def _save_disk() -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_memory_cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def device_kind(device=None) -> str:
    """``"cuda:<card name>"`` or ``"cpu"``; ``None``: the default device
    (the card when there is one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def key(name: str, static_key: Any, kind: str) -> str:
    return json.dumps([name, static_key, kind], sort_keys=True, default=str)


def best_workload_opts(workload: str, device=None) -> Optional[dict]:
    """The persisted winner's knobs for ``workload`` on ``device``'s kind
    (any shape; the fastest entry wins), or None."""
    kind = device_kind(device)
    best = None
    with _lock:
        _load_disk()
        for k, entry in _memory_cache.items():
            try:
                name, _, dev = json.loads(k)
            except (ValueError, TypeError):
                continue
            if name != workload or dev != kind:
                continue
            if not isinstance(entry, dict) or "config" not in entry:
                continue
            if best is None or entry.get("ms", 1e30) < best.get("ms", 1e30):
                best = entry
    return None if best is None else dict(best["config"])


def best_kernel_opts(device=None) -> Optional[dict]:
    """Persisted winner for the radiation step (``cellw``, ``layermajor``,
    ``gpt_chunk``) on ``device``'s kind."""
    return best_workload_opts("radiation_step", device)


def _sync(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor."""
    leaves = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else (out,))
    for leaf in leaves:
        if torch.is_tensor(leaf) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def measure(fn: Callable, args: Sequence, iters: int = 8, warmup: int = 2,
            perturb: Optional[Callable[[Sequence, int], Sequence]] = None
            ) -> float:
    """Median wall time of ``fn(*args)`` in seconds, each call synchronized
    with the card (the reference's 8-sample loop, ``include/tuner.h:127-140``).
    ``perturb(args, i) -> args`` varies the inputs per iteration."""
    times = []
    for i in range(warmup + iters):
        if perturb is not None:
            args = perturb(args, i)
        t0 = time.perf_counter()
        _sync(fn(*args))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _args_device(args: Sequence):
    return next((a.device for a in args if torch.is_tensor(a)), None)


def autotune(name: str, candidates: List[dict], build: Callable[[dict], Callable],
             args: Sequence, static_key: Any = None, iters: int = 8) -> dict:
    """Return the fastest candidate config (cached per device kind of the
    first tensor in ``args``, else the default device).

    ``build(candidate) -> fn``; a candidate whose build or run raises is
    skipped (the reference does the same for invalid block dims,
    ``include/tuner.h:120-125``)."""
    if not candidates:
        raise ValueError("autotune needs at least one candidate")
    if os.environ.get("RTE_RRTMGP_TUNER_DISABLE"):
        return candidates[0]

    k = key(name, static_key, device_kind(_args_device(args)))
    with _lock:
        _load_disk()
        hit = _memory_cache.get(k)
        if hit is not None and hit.get("config") in candidates:
            return hit["config"]

    results = []
    for cand in candidates:
        try:
            dt = measure(build(cand), args, iters=iters)
        except Exception:  # a candidate that cannot build or run is skipped
            continue
        results.append((dt, cand))
    if not results:
        raise RuntimeError(f"autotune({name!r}): every candidate failed")
    results.sort(key=lambda r: r[0])
    best_dt, best = results[0]
    persist(k, {"config": best, "ms": best_dt * 1e3,
                "all": [{"config": c, "ms": d * 1e3} for d, c in results]})
    return best


def persist(k: str, entry: dict) -> None:
    """Store ``entry`` under key ``k`` and write the user cache."""
    with _lock:
        _load_disk()
        _memory_cache[k] = entry
        _save_disk()


def cached_winners() -> Dict[str, dict]:
    """Snapshot of the tuning table (for inspection / tests)."""
    with _lock:
        _load_disk()
        return dict(_memory_cache)
