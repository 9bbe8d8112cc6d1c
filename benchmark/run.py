"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` joins a configuration
(``benchmark/configs/<config>.json``: sizes, the reference module) to a
traffic mix (``benchmark/traffic/<traffic>.json``: the entry driver
``benchmark/entries/<entry>.py`` and its parameters); the numbers a run
compares and their limits are in ``benchmark/limits/<cell>.json`` and each
per-layer metric has its reader ``benchmark/metrics/<metric>.py``.  A
metric ``<quantity>.<group>`` reports the quantity for a group of cells
under a name and bound of its own (``call_ms.solve``); it is read as the
quantity is, unless a reader of its full name exists.

Set-up makes the tables and the atmosphere from ``--seed`` (the frozen
generators of ``benchmark/inputs``), builds the entry on the card and
warms it up; ``setup_s`` runs from the start of the process to the first
timed call.  ``--trace 0`` then runs back-to-back calls (each ending in a
synchronize with the card) for ``--seconds`` and reports the cell's
end-to-end metrics; ``--trace 1`` captures a few calls under
``torch.profiler`` and reports its per-layer metrics.  Afterwards the
program's state is dropped and the plain reference works out the same
call again in float64 from the same inputs; the outputs of two calls of
the window (one drawn from the seed, and the last) are held to it.  The
last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error too.

The run fails, printing no result, where there is no card (or fewer than
the cell asks for) and where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Build and kernel caches at fixed places inside the checkout (the
# program's own CUDA library builds under build/torch_kernels there).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import trace as tracing  # noqa: E402
from benchmark.counts.stages import PEAKS  # noqa: E402
from benchmark.inputs import atmosphere, tables  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rte_rrtmgp_tpu")


class Fail(Exception):
    """A run that prints no result."""


# Configuration keys: what only documents the deployment; what the run
# reads (sizes, gases, precision) or checks against the tables it makes;
# and what the entry has to run as stated (each entry module gives its
# values in ``RUNS``).
DOC_KEYS = {"name", "source", "deployment", "one_chip_holds", "reference",
            "assumed", "reduced"}
SIZE_KEYS = ("ntemp", "npress", "neta", "gpt_per_band")
READ_KEYS = {"ncol", "nlay", "gases", "minor_intervals", "dtype", "nbnd_lw",
             "nbnd_sw", "ngpt_lw", "ngpt_sw", *SIZE_KEYS}
ENTRY_KEYS = ("clouds", "aerosols", "n_gauss_angles")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Cell:
    """One cell's configuration, traffic mix, limits and inputs.  Every
    key of the configuration is read here or by the entry
    (:func:`make_entry`); a key or a value that the run cannot honour
    fails the run."""

    def __init__(self, bench: dict, name: str, seed: int):
        cells = {w["name"]: w for w in bench["workloads"]}
        self.name, self.seed = name, seed
        conf = {c["name"]: c for c in bench["configs"]}[cells[name]["config"]]
        c = self.config = _json(ROOT / conf["file"])
        self.traffic = _json(HERE / "traffic" / f"{cells[name]['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        unread = set(c) - DOC_KEYS - READ_KEYS - set(ENTRY_KEYS)
        if unread:
            raise Fail(f"configuration keys the run does not read: "
                       f"{sorted(unread)}")
        if c["dtype"] not in DTYPES:
            raise Fail(f"dtype {c['dtype']!r}: the run honours "
                       f"{sorted(DTYPES)}")
        self.dtype = DTYPES[c["dtype"]]
        unknown = set(c["gases"]) - set(tables.GAS_NAMES)
        if unknown or "h2o" not in c["gases"]:
            raise Fail(f"gases {sorted(unknown)} not in the tables, or no h2o")
        # The tables' order, which the program's vmr axis follows.
        self.gases = tuple(g for g in tables.GAS_NAMES if g in c["gases"])
        self.ncol, self.nlay = c["ncol"], c["nlay"]
        sizes = {k: c[k] for k in SIZE_KEYS}
        mi = c["minor_intervals"]
        self.raws = {
            "kd_lw": tables.make_kdist_raw(True, seed, **sizes,
                                           minor_intervals=mi["lw"]),
            "kd_sw": tables.make_kdist_raw(False, seed, **sizes,
                                           minor_intervals=mi["sw"]),
            "cloud_lw": tables.make_cloud_raw(True, seed),
            "cloud_sw": tables.make_cloud_raw(False, seed)}
        for sw, kd in (("lw", "kd_lw"), ("sw", "kd_sw")):
            lims = self.raws[kd]["bnd_limits_gpt"]
            got = {f"nbnd_{sw}": lims.shape[0],
                   f"ngpt_{sw}": int(lims[:, 1].max())}
            for k, v in got.items():
                if c[k] != v:
                    raise Fail(f"{k} {c[k]} stated, the tables have {v}")
        self.atm = atmosphere.make_atmosphere(self.ncol, self.nlay, seed)


def make_entry(cell: Cell, device):
    """The cell's entry (``benchmark/entries/<entry>.py``), after holding
    the configuration to what the entry runs."""
    mod = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    for k in ENTRY_KEYS:
        if cell.config[k] != mod.RUNS[k]:
            raise Fail(f"{k} {cell.config[k]!r}: the entry "
                       f"{cell.traffic['entry']!r} runs {mod.RUNS[k]!r}")
    return mod.Entry(cell, device)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _base(name: str) -> str:
    """A metric ``<quantity>.<group>`` (as ``call_ms.solve``) is the
    quantity ``<quantity>`` reported under its own name and bound for a
    group of cells."""
    return name.split(".")[0]


def _metric_reader(name: str):
    """``metrics/<name>.py``, else the quantity's ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{_base(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _card_line(device) -> str:
    """The card's name and power limit, with the roofline peaks."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return (f"card: {out}; roofline peaks {PEAKS['bytes_per_s']:.4g} B/s, "
            f"{PEAKS['flops_per_s']:.4g} float32 FLOP/s")


def _window(entry, seconds: float, keep: int):
    """Back-to-back calls for ``seconds``: (per-call seconds, window
    seconds, {call index: outputs} of call ``keep`` and the last)."""
    times, kept = [], {}
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = entry.call()
        b = time.perf_counter()
        times.append(b - a)
        if len(times) - 1 == keep:
            kept[keep] = out
        if b - t0 >= seconds:
            kept[len(times) - 1] = out
            return times, b - t0, kept


def _host(out: dict) -> dict:
    return {k: (v.detach().to("cpu", torch.float64).numpy()
                if torch.is_tensor(v) else np.asarray(v, np.float64))
            for k, v in out.items()}


def _check(kept: dict, expected: dict, limits: dict) -> dict:
    """Each compared number beside its limit: the widest gap, over the
    kept calls and the outputs the number names, between the program's
    finite outputs and the reference's; and ``nonfinite_outputs``, the
    count of outputs that are not finite, held to 0."""
    res, bad = {}, 0
    for name, spec in limits.items():
        gap = 0.0
        for out in kept.values():
            for k in spec["outputs"]:
                d = np.abs(out[k] - expected[k])
                fin = np.isfinite(d)
                bad += int(d.size - fin.sum())
                if fin.any():
                    gap = max(gap, float(d[fin].max()))
        res[name] = {"value": gap, "limit": spec["limit"]}
    res["nonfinite_outputs"] = {"value": bad, "limit": 0}
    return res


def run(argv=None, device=None) -> dict:
    """One run; returns the result line's object.  ``device``: None looks
    for the card the cell asks for; a test passes ``"cpu"``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = _json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if a.workload not in chips:
        raise Fail(f"no workload {a.workload!r} in BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device: the benchmark measures the card "
                       "and never falls back to the CPU")
        if torch.cuda.device_count() < chips[a.workload]:
            raise Fail(f"{a.workload} needs {chips[a.workload]} cards, "
                       f"{torch.cuda.device_count()} present")
        device = "cuda:0"
    seed = abs(a.seed)
    cell = Cell(bench, a.workload, seed)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    traffic = cell.traffic
    entry = make_entry(cell, device)
    for _ in range(traffic["warmup_calls"]):
        entry.call()
    setup_s = time.perf_counter() - T_START
    keep = int(np.random.default_rng([seed, 1]).integers(0, 8))

    if a.trace:
        for _ in range(traffic["trace_warm_calls"]):
            entry.call()
        from rte_rrtmgp_torch.models.radiation import STAGES

        out, tr = tracing.capture(entry.call, traffic["trace_calls"],
                                  STAGES, cuda)
        attempted, kept = tr.calls, {tr.calls - 1: out}
        del out
    else:
        times, window_s, kept = _window(entry, a.seconds, keep)
        attempted = len(times)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept = {i: _host(o) for i, o in kept.items()}
    ref_inputs = entry.reference_inputs()
    options = {"delta_cloud": entry.delta_cloud, "guard_dtype": cell.dtype}
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        print(_card_line(device), flush=True)
    refmod = importlib.import_module(cell.config["reference"])
    expected = refmod.outputs(cell.raws, ref_inputs, options, device)
    checks = _check(kept, expected, cell.limits)
    failed = sum(any(c["value"] > c["limit"] for c in _check(
        {i: o}, expected, cell.limits).values()) for i, o in kept.items())

    metrics = {}
    if a.trace:
        for m in bench["per_layer"]:
            if _applies(m, a.workload):
                v = _metric_reader(m["name"])(tr, cell)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        p90 = (statistics.quantiles(times, n=10, method="inclusive")[-1]
               if len(times) > 1 else times[0])
        e2e = {"call_ms": window_s / attempted * 1e3,
               "call_ms_p90": p90 * 1e3,
               "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if _applies(m, a.workload) and _base(m["name"]) in e2e:
                metrics[m["name"]] = {"value": e2e[_base(m["name"])],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if a.trace:
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = (tr.window[1] - tr.window[0]) * 1e-6
        result["breakdown"] = tr.breakdown()
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        raise Fail("the run loaded " + ", ".join(loaded))
    result["checks"] = checks
    return result


def main(argv=None, device=None) -> int:
    try:
        result = run(argv, device)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
