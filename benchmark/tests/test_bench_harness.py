"""The harness on the CPU at a tiny size, in a temporary copy of the
benchmark to which a configuration, traffic mixes, limits and a metric are
added as new files: the result line's format, the faults that must come
out not correct, the refusals, and what the run imports."""

import json
from pathlib import Path

import pytest

from benchmark.tests import tiny

ARGS = ["--seed", str(2 ** 31 + 7), "--seconds", "0.5"]
FAULTS = {
    # One answer altered where it is produced.
    "altered": "out['lw_flux_up'][3, 5] += 1.0",
    # Half of the columns left out.
    "half": "n = out['sw_flux_dn'].shape[0] // 2\n"
            "    for v in out.values(): v[n:] = 0",
}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tiny.make_copy(tmp_path_factory.mktemp("bench"))
    b = tmp / "benchmark"
    # A traffic mix and a metric of their own, as new files only.
    (b / "traffic" / "step_chunk8.json").write_text(json.dumps(
        dict(json.loads((b / "traffic" / "step.json").read_text()),
             gpt_chunk=8)))
    (b / "metrics" / "calls_traced.py").write_text(
        "def read(trace, cell):\n    return float(trace.calls)\n")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.step_chunk8", "config": "tiny",
                               "traffic": "step_chunk8", "chips": 1,
                               "why": "test"})
    (b / "limits" / "tiny.step_chunk8.json").write_text(
        (b / "limits" / "tiny.step.json").read_text())
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "call_ms",
                               "workloads": ["tiny.step_chunk8"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


E2E = {"tiny.step": {"call_ms", "call_ms_p90", "peak_mem_gib", "setup_s"},
       "tiny.solve": {"call_ms.solve", "call_ms_p90.solve", "peak_mem_gib",
                      "setup_s"}}


@pytest.mark.parametrize("workload", ["tiny.step", "tiny.solve"])
def test_result_line(copy, workload):
    proc = tiny.run_copy(copy, ["--workload", workload, *ARGS,
                                "--trace", "0"])
    res = _result(proc)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == E2E[workload]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = proc.stderr.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == f"check {name}: {c['value']!r} (limit {c['limit']!r})"
        assert 0 <= c["value"] <= c["limit"]


def test_new_files_are_found_by_name(copy):
    """A configuration, a traffic mix, its limits and a metric added as
    new files run with no existing file edited."""
    res = _result(tiny.run_copy(copy, ["--workload", "tiny.step_chunk8",
                                       *ARGS, "--trace", "1"]))
    assert res["correct"] is True
    assert res["metrics"]["calls_traced"] == {"value": 5.0, "unit": "calls"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_traced_solve_reads_the_host_prep(copy):
    res = _result(tiny.run_copy(copy, ["--workload", "tiny.solve", *ARGS,
                                       "--trace", "1"]))
    assert res["correct"] is True
    assert res["metrics"]["host_prep_ms"]["value"] > 0
    # No card: the device readers find nothing and are left out.
    assert set(res["metrics"]) == {"host_prep_ms"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,entry", [("tiny.step", "step"),
                                            ("tiny.solve", "solve")])
def test_broken_path_is_not_correct(copy, fault, workload, entry):
    prelude = (f"import benchmark.entries.{entry} as E\n"
               "_call = E.Entry.call\n"
               "def call(self):\n"
               "    out = _call(self)\n"
               f"    {FAULTS[fault]}\n"
               "    return out\n"
               "E.Entry.call = call\n")
    res = _result(tiny.run_copy(copy, ["--workload", workload, *ARGS,
                                       "--trace", "0"], prelude=prelude))
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("change,said", [
    ({"clouds": False}, "clouds False"),
    ({"n_gauss_angles": 3}, "n_gauss_angles 3"),
    ({"dtype": "bfloat16"}, "dtype 'bfloat16'"),
    ({"nbnd_lw": 15}, "nbnd_lw 15"),
    ({"gases": ["co2", "o3"]}, "no h2o"),
    ({"layers_per_block": 8}, "layers_per_block"),
])
def test_config_that_the_run_cannot_honour_fails(tmp_path, change, said):
    """Every key of a configuration is read or held to what the entry
    runs: a value the run cannot honour, or a key it does not read, fails
    the run with no result."""
    tmp = tiny.make_copy(tmp_path)
    conf = tmp / "benchmark" / "configs" / "tiny.json"
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()), **change)))
    proc = tiny.run_copy(tmp, ["--workload", "tiny.step", *ARGS,
                               "--trace", "0"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert said in proc.stderr


def test_config_dtype_is_honoured(tmp_path):
    """A float64 configuration runs the program in float64 (the reference
    with float64 guards) and comes out correct."""
    tmp = tiny.make_copy(tmp_path)
    conf = tmp / "benchmark" / "configs" / "tiny.json"
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()),
                                    dtype="float64")))
    prelude = ("import benchmark.entries.step as E\n"
               "_call = E.Entry.call\n"
               "def call(self):\n"
               "    out = _call(self)\n"
               "    assert out['lw_flux_up'].dtype == torch.float64\n"
               "    return out\n"
               "E.Entry.call = call\n"
               "import torch")
    res = _result(tiny.run_copy(tmp, ["--workload", "tiny.step", *ARGS,
                                      "--trace", "0"], prelude=prelude))
    assert res["correct"] is True
    assert max(c["value"] for c in res["checks"].values()) < 1e-6


def test_no_card_no_result(copy):
    proc = tiny.run_copy(copy, ["--workload", "tiny.step", *ARGS,
                                "--trace", "0"], device=None)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_jax_loaded_no_result(copy):
    prelude = "import types; sys.modules['jax'] = types.ModuleType('jax')"
    proc = tiny.run_copy(copy, ["--workload", "tiny.step", *ARGS,
                                "--trace", "0"], prelude=prelude)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "loaded jax" in proc.stderr


def test_no_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark fails."""
    import shutil
    import subprocess
    import sys

    shutil.copytree(tiny.BENCH, tmp_path / "benchmark")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rcemip.step",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_imports_leave_out_jax_and_the_root_tools(copy):
    """Every module a run imports (harness, entries, reference, metrics,
    calibration): none whose top-level name is jax, jaxlib, flax,
    rte_rrtmgp_tpu, the root tools, bench or chip_smoke."""
    prelude = ("import atexit, json\n"
               "import benchmark.calibrate\n"
               "atexit.register(lambda: print(json.dumps(sorted("
               "{m.split('.')[0] for m in sys.modules})), file=sys.stderr))")
    proc = tiny.run_copy(copy, ["--workload", "tiny.solve", *ARGS,
                                "--trace", "1"], prelude=prelude)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stderr.strip().splitlines()[-1]))
    assert "rte_rrtmgp_torch" in tops and "benchmark" in tops
    assert not tops & {"jax", "jaxlib", "flax", "rte_rrtmgp_tpu", "tools",
                       "bench", "chip_smoke"}
    files = [p for p in Path(tiny.BENCH).rglob("*.py")
             if "tests" not in p.relative_to(tiny.BENCH).parts]
    for f in files:
        text = f.read_text()
        for word in ("BENCH_r", "BASELINE.json", "MULTICHIP_"):
            assert word not in text, (f, word)
