"""A copy of the benchmark in a temporary directory with a tiny cell of
each traffic mix added as new files, for the CPU tests."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY = {"ncol": 8, "nlay": 12, "gpt_per_band": 2, "nbnd_lw": 16,
        "nbnd_sw": 14, "ngpt_lw": 32, "ngpt_sw": 28}
# What a tiny run holds the program to: the same names as the cells, with
# limits from CPU readings of the float32 program against the reference
# (LW ~1e-4, SW ~4e-3 W m-2) and far below the bfloat16 control's (LW
# ~4, SW ~7 W m-2).
TINY_LIMITS = {"lw_flux_err_wm2": 0.01, "sw_flux_err_wm2": 0.1}


def make_copy(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and benchmark/, with a configuration
    ``tiny``, its cells ``tiny.step`` and ``tiny.solve`` and their limits
    added as new files (and entries of the JSON: each cell joins the
    metrics of the benchmark's cells of its traffic mix); returns
    ``tmp``."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "rcemip.json").read_text())
    conf.update(TINY, name="tiny")
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["ncol", "nlay", "gpt_per_band"],
                             "why": "CPU test"})
    limits = json.loads((BENCH / "limits" / "rcemip.step.json").read_text())
    for k, v in TINY_LIMITS.items():
        limits[k]["limit"] = v
    mix_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    for mix in ("step", "solve"):
        name = f"tiny.{mix}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "test"})
        (tmp / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps(limits))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(mix_of.get(w) == mix for w in m.get("workloads", [])):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_copy(tmp: Path, args, device="cpu", prelude="", timeout=300):
    """``benchmark.run.main(args, device)`` of the copy in ``tmp``, in a
    fresh interpreter (the program imported from the repository) after
    ``prelude``; returns the CompletedProcess."""
    code = (f"import sys; sys.path[:0] = [{str(tmp)!r}, {str(REPO)!r}]\n"
            f"{prelude}\n"
            "from benchmark import run\n"
            f"sys.exit(run.main({list(args)!r}, device={device!r}))\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=str(tmp))
