"""The clear-sky cell's harness on the CPU at a tiny size: a configuration
``tiny_clrsky`` (``configs/rcemip_clrsky.json`` at the sizes of
:mod:`benchmark.tests.tiny`) and its cell ``tiny_clrsky.step_clrsky`` added
to a temporary copy of the benchmark as new files.  The result line holds
the four flux checks, the faults a clear-sky call can make come out not
correct, the configuration is held to what the entry runs, a program
without ``clear_sky`` fails at set-up, and the per-layer reader reads only
the clear-sky ranges."""

import json

import pytest

from benchmark.tests import tiny
from benchmark.trace import Trace

ARGS = ["--seed", str(2 ** 31 + 16), "--seconds", "0.5"]
CELL = "tiny_clrsky.step_clrsky"
CHECKS = {"lw_flux_err_wm2", "sw_flux_err_wm2", "lw_clrsky_flux_err_wm2",
          "sw_clrsky_flux_err_wm2", "nonfinite_outputs"}
FAULTS = {
    # The clear-sky and all-sky outputs handed back under each other's names.
    "swapped": "for k in [k for k in out if '_clrsky_' in k]:\n"
               "        a = k.replace('_clrsky_', '_')\n"
               "        out[k], out[a] = out[a], out[k]",
    # Half of the columns of every clear-sky output left at zero.
    "half_clrsky": "n = out['sw_clrsky_flux_dn'].shape[0] // 2\n"
                   "    for k in [k for k in out if '_clrsky_' in k]:\n"
                   "        out[k] = out[k].clone()\n"
                   "        out[k][n:] = 0",
}


def _add_cell(tmp):
    """The tiny clear-sky configuration, its cell and limits as new files
    (and entries of the JSON) in the copy ``tmp``."""
    b = tmp / "benchmark"
    conf = json.loads((b / "configs" / "rcemip_clrsky.json").read_text())
    conf.update(tiny.TINY, name="tiny_clrsky")
    (b / "configs" / "tiny_clrsky.json").write_text(json.dumps(conf))
    limits = json.loads(
        (b / "limits" / "rcemip_clrsky.step_clrsky.json").read_text())
    for k, spec in limits.items():
        spec["limit"] = tiny.TINY_LIMITS[k.replace("_clrsky", "")]
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_clrsky",
                             "source": "https://example.org",
                             "file": "benchmark/configs/tiny_clrsky.json",
                             "reduced": ["ncol", "nlay", "gpt_per_band"],
                             "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_clrsky",
                               "traffic": "step_clrsky", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rcemip_clrsky.step_clrsky" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return _add_cell(tiny.make_copy(tmp_path_factory.mktemp("bench")))


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", ["0", "1"])
def test_result_line_holds_the_four_checks(copy, trace):
    res = _result(tiny.run_copy(copy, ["--workload", CELL, *ARGS,
                                       "--trace", trace]))
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == CHECKS
    for c in res["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    if trace == "0":
        assert set(res["metrics"]) == {"call_ms", "call_ms_p90",
                                       "peak_mem_gib", "setup_s"}
    else:
        # No card: the device readers find nothing and are left out.
        assert res["metrics"] == {}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_clrsky_call_is_not_correct(copy, fault):
    prelude = ("import benchmark.entries.step_clrsky as E\n"
               "_call = E.Entry.call\n"
               "def call(self):\n"
               "    out = _call(self)\n"
               f"    {FAULTS[fault]}\n"
               "    return out\n"
               "E.Entry.call = call\n")
    res = _result(tiny.run_copy(copy, ["--workload", CELL, *ARGS,
                                       "--trace", "0"], prelude=prelude))
    assert res["correct"] is False and res["failed"] >= 1
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert bad >= {"lw_clrsky_flux_err_wm2", "sw_clrsky_flux_err_wm2"}


@pytest.mark.parametrize("workload", ["tiny.step", CELL])
def test_clouds_off_configuration_fails(tmp_path, workload):
    """The step entry and the clear-sky entry both run clouds on: a
    configuration with ``clouds: false`` fails either run, as it does the
    step's."""
    tmp = _add_cell(tiny.make_copy(tmp_path))
    name = workload.split(".")[0]
    conf = tmp / "benchmark" / "configs" / f"{name}.json"
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()),
                                    clouds=False)))
    proc = tiny.run_copy(tmp, ["--workload", workload, *ARGS,
                               "--trace", "0"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "clouds False" in proc.stderr


def test_program_without_clear_sky_fails_at_set_up(copy):
    """A program whose ``make_step`` has no ``clear_sky`` (as before the
    clear-sky call existed) stops the run at set-up, with no result."""
    prelude = ("import rte_rrtmgp_torch.step as S\n"
               "_make = S.make_step\n"
               "def make_step(kd_lw, kd_sw, clut_lw, clut_sw, gpt_chunk=None,\n"
               "              cellw=None, layer_major=None):\n"
               "    return _make(kd_lw, kd_sw, clut_lw, clut_sw, gpt_chunk,\n"
               "                 cellw, layer_major)\n"
               "S.make_step = make_step\n")
    proc = tiny.run_copy(copy, ["--workload", CELL, *ARGS, "--trace", "0"],
                         prelude=prelude, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "clear_sky" in proc.stderr


def test_reader_reads_only_the_clrsky_ranges():
    from benchmark.counts import stages as counts
    from benchmark.metrics import clrsky_solvers_roofline as m

    class Cell:
        ncol, nlay = tiny.TINY["ncol"], tiny.TINY["nlay"]
        raws = {"kd_lw": {"kmajor": _Shape(32)},
                "kd_sw": {"kmajor": _Shape(28)}}

    ops = [("lw_sweep", 0.0, 30.0, "lw_solve_clrsky"),
           ("sw_2stream", 30.0, 50.0, "sw_solve_clrsky"),
           ("lw_sweep", 50.0, 1050.0, "lw_solve"),
           ("gather", 1050.0, 2050.0, None)]
    trace = Trace(calls=2, window=(0.0, 2100.0), ops=ops, host_ranges=[])
    work = counts.solvers(Cell.ncol, Cell.nlay, Cell.raws["kd_lw"],
                          Cell.raws["kd_sw"])
    assert m.read(trace, Cell) == pytest.approx(
        100.0 * counts.least_seconds(work) / (25.0 * 1e-6))
    assert m.read(Trace(calls=2, window=(0.0, 2100.0), ops=ops[2:],
                        host_ranges=[]), Cell) is None


class _Shape:
    """A stand-in for a k table: only its last axis (the g-points) is
    read."""

    def __init__(self, ngpt):
        self.shape = (1, 1, 1, ngpt)
