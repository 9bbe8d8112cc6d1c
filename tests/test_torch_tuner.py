"""The port's autotuner (``rte_rrtmgp_torch/utils/tuner.py``), the layout
switches it feeds (``config.cellw_enabled`` / ``layer_major_enabled``:
environment > persisted winner for the device kind > default) and the
checked-in winners table.  The tuner cases are those of
``tests/test_tuner.py`` without the tracers."""

import json
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu.utils import tuner as jtuner

from rte_rrtmgp_torch import config
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import KDist, RadiationSolverLW, raytracer_bw
from rte_rrtmgp_torch.ops import rte_lw
from rte_rrtmgp_torch.utils import tuner

torch.set_num_threads(2)

H100 = "cuda:NVIDIA H100 80GB HBM3"


def _reset():
    tuner._memory_cache.clear()
    tuner._disk_loaded = False


@pytest.fixture
def isolated_cache(tmp_path, monkeypatch):
    """A temporary user cache; the checked-in table is still read."""
    monkeypatch.setenv("RTE_RRTMGP_TUNER_CACHE", str(tmp_path / "tune.json"))
    for k in ("RTE_RRTMGP_TUNER_DISABLE", "RTE_RRTMGP_PALLAS_CELLW",
              "RTE_RRTMGP_LAYERMAJOR"):
        monkeypatch.delenv(k, raising=False)
    _reset()
    yield tmp_path / "tune.json"
    _reset()


def test_picks_fastest_and_caches(isolated_cache):
    calls = []

    def build(cand):
        def fn(x):
            calls.append(cand["delay"])
            time.sleep(cand["delay"])
            return x
        return fn

    cands = [{"delay": 0.003}, {"delay": 0.0}, {"delay": 0.002}]
    best = tuner.autotune("k", cands, build, (np.zeros(2),), iters=2)
    assert best == {"delay": 0.0}
    n = len(calls)
    assert tuner.autotune("k", cands, build, (np.zeros(2),), iters=2) == best
    assert len(calls) == n


def test_cache_persists_to_disk(isolated_cache):
    cands = [{"m": 1}, {"m": 2}]
    best = tuner.autotune("persist", cands, lambda c: (lambda x: x * c["m"]),
                          (torch.ones(4),), iters=1)
    entry = json.load(open(isolated_cache))[tuner.key("persist", None, "cpu")]
    assert entry["config"] == best and len(entry["all"]) == 2
    _reset()
    again = tuner.autotune(
        "persist", cands, lambda c: (_ for _ in ()).throw(AssertionError),
        (torch.ones(4),))
    assert again == best


def test_failing_candidates_skipped(isolated_cache):
    def build(cand):
        if cand["bad"]:
            raise ValueError("unbuildable")
        return lambda x: x

    best = tuner.autotune("skip", [{"bad": True}, {"bad": False}], build,
                          (np.zeros(1),), iters=1)
    assert best == {"bad": False}


def test_all_fail_raises(isolated_cache):
    with pytest.raises(RuntimeError):
        tuner.autotune("allfail", [{"a": 1}],
                       lambda c: (_ for _ in ()).throw(ValueError),
                       (np.zeros(1),))


def test_disable_env(isolated_cache, monkeypatch):
    monkeypatch.setenv("RTE_RRTMGP_TUNER_DISABLE", "1")
    best = tuner.autotune(
        "disabled", [{"first": True}, {"first": False}],
        lambda c: (_ for _ in ()).throw(AssertionError), (np.zeros(1),))
    assert best == {"first": True}


def _persist_step_winner(cfg, kind, ms=1e-3):
    tuner.persist(tuner.key("radiation_step", {"ncol": 8, "nlay": 4}, kind),
                  {"config": cfg, "ms": ms})


def test_winners_resolve_per_workload_and_device_kind(isolated_cache,
                                                      monkeypatch):
    """The fastest entry of a workload for the device kind asked for; other
    kinds and unknown workloads resolve to None (as JAX's tuner does for
    the same table)."""
    _persist_step_winner({"cellw": 0, "layermajor": 0}, H100, ms=2e-3)
    _persist_step_winner({"cellw": 1, "layermajor": 1}, H100, ms=1e-3)
    real = tuner.device_kind
    monkeypatch.setattr(tuner, "device_kind", lambda device=None: H100)
    assert tuner.best_kernel_opts() == {"cellw": 1, "layermajor": 1}
    assert tuner.best_workload_opts("nonexistent_workload") is None
    monkeypatch.setattr(tuner, "device_kind", real)
    assert tuner.device_kind("cpu") == "cpu"
    assert tuner.best_kernel_opts("cpu") is None
    # JAX's tuner reads the same file format the same way.
    jtuner._memory_cache.clear()
    jtuner._disk_loaded = False
    monkeypatch.setattr(jtuner, "_device_kind", lambda: H100)
    try:
        assert jtuner.best_kernel_opts() == {"cellw": 1, "layermajor": 1}
    finally:
        jtuner._memory_cache.clear()
        jtuner._disk_loaded = False


def test_layout_switches_env_then_winner_then_default(isolated_cache,
                                                      monkeypatch):
    cpu = torch.device("cpu")
    assert config.cellw_enabled(cpu) and not config.layer_major_enabled(cpu)
    _persist_step_winner({"gpt_chunk": None, "cellw": 0, "layermajor": 1},
                         "cpu")
    assert not config.cellw_enabled(cpu) and config.layer_major_enabled(cpu)
    monkeypatch.setenv("RTE_RRTMGP_PALLAS_CELLW", "1")
    monkeypatch.setenv("RTE_RRTMGP_LAYERMAJOR", "off")
    assert config.cellw_enabled(cpu) and not config.layer_major_enabled(cpu)


def test_cpu_solve_never_reads_a_card_winner(isolated_cache, monkeypatch):
    """A card's layer-major winner does not reach a CPU solve; a winner for
    the CPU's own kind does."""
    _persist_step_winner({"cellw": 1, "layermajor": 1}, H100)
    lm_calls = []
    fn = rte_lw.lw_solver_noscat_broadband_lm
    monkeypatch.setattr(rte_lw, "lw_solver_noscat_broadband_lm",
                        lambda *a, **kw: (lm_calls.append(1), fn(*a, **kw))[1])
    kd = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=1),
                        ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"],
                        dtype=torch.float64, device="cpu")
    atm = make_atmosphere(2, 6, seed=1)
    solve = lambda: RadiationSolverLW(kd).solve(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
        emis_sfc=np.full((2, kd.nbnd), 0.98))
    solve()
    assert not lm_calls
    _persist_step_winner({"cellw": 1, "layermajor": 1}, "cpu")
    solve()
    assert len(lm_calls) == 1


def test_checked_in_table_names_only_cards(isolated_cache, monkeypatch):
    """Every entry of the checked-in table is a card's sweep with the card's
    name beside it — the radiation step's (``tune_radiation.py``), the
    forward tracer's (``tune_rt.py``, key ``rt_trace``) or the camera
    renderer's (``tune_bw.py``, key ``bw_render``) — and resolves for its
    device kind."""
    with open(tuner.defaults_path()) as f:
        table = json.load(f)
    real = tuner.device_kind
    for k, entry in table.items():
        name, static, kind = json.loads(k)
        assert kind.startswith("cuda:"), k
        assert name in ("radiation_step", "rt_trace", "bw_render"), k
        if name == "radiation_step":
            assert set(static) == {"ncol", "nlay"}
            assert set(entry["config"]) == {"gpt_chunk", "cellw",
                                            "layermajor"}
            assert entry["rounds"] >= 10
        elif name == "bw_render":
            assert set(static) == {"cam", "ppp"}
            n_rays = static["cam"] ** 2 * static["ppp"]
            assert raytracer_bw.default_rays_per_lane(
                n_rays, static["ppp"]) >= 2, "no lane respawns in the sweep"
            assert entry["config"]["respawn_mode"] in ("fifo", "pool")
            assert set(entry["config"]) == {"respawn_mode",
                                            "steps_per_dispatch"}
            assert entry["rounds"] >= 3
        else:
            assert set(static) == {"nx", "nz", "ppp"}
            assert entry["config"]["respawn_mode"] in ("fifo", "arith", "pool")
            assert set(entry["config"]) <= {"respawn_mode", "compact_floor",
                                            "photons_per_lane"}
            assert entry["rounds"] >= 3
        assert entry["card"].startswith(kind[len("cuda:"):]), entry["card"]
        assert entry["ms"] == min(r["ms"] for r in entry["all"])
        monkeypatch.setattr(tuner, "device_kind", lambda device=None: kind)
        best = min((e for kk, e in table.items()
                    if json.loads(kk)[2] == kind and json.loads(kk)[0] == name),
                   key=lambda e: e["ms"])
        assert tuner.best_workload_opts(name) == best["config"]
    monkeypatch.setattr(tuner, "device_kind", real)
    assert tuner.best_kernel_opts("cpu") is None
    assert tuner.best_workload_opts("rt_trace", "cpu") is None
    assert tuner.best_workload_opts("bw_render", "cpu") is None


@pytest.mark.parametrize("argv", [["--ppp", "8"], ["--cam", "32"],
                                  ["--rounds", "2"]])
def test_camera_tuner_refuses_a_sweep_that_cannot_tell_the_modes(argv):
    """``tune_bw.py`` stops before it renders when no lane respawns (64x64
    px at 8 photons a pixel; 32x32 at 16) — pool and fifo then run the
    same loop — or with fewer than 3 rounds."""
    from rte_rrtmgp_torch.tuning import tune_bw

    assert raytracer_bw.default_rays_per_lane(64 * 64 * 16, 16) == 2
    with pytest.raises(SystemExit) as e:
        tune_bw.main(argv)
    assert e.value.code == 2
