"""The port's walkthroughs (``rte_rrtmgp_torch/examples``) on the CPU at
their own sizes: each passes its own asserts and prints its last line;
``basic_usage``'s float32 gradient of the outgoing longwave matches a
central finite difference of the same function in float64 within 1e-3
relative.  Without a card and without ``--device cpu`` a walkthrough
raises."""

import subprocess
import sys

import jax  # noqa: F401  (both frameworks load in every port test file)
import numpy as np
import pytest
import torch

from rte_rrtmgp_torch.examples import (basic_usage, multichip_sharding,
                                       raytrace_3d)

torch.set_num_threads(2)


def test_basic_usage_gradient_matches_finite_difference(capsys):
    out = basic_usage.main("cpu")
    assert capsys.readouterr().out.splitlines()[-1] == "EXAMPLE OK"
    for k in ("lw_flux_up", "lw_flux_dn"):
        assert out["lw"][k].dtype == torch.float32
        assert bool(torch.isfinite(out["lw"][k]).all()), k
    assert bool(torch.isfinite(out["sw"]["sw_flux_dn"]).all())
    olr = basic_usage.olr_function(out["kd_lw"], out["atm"], out["gas"],
                                   torch.float64)
    h = 1e-3
    with torch.no_grad():
        fd = float(olr(torch.tensor(1.0 + h, dtype=torch.float64))
                   - olr(torch.tensor(1.0 - h, dtype=torch.float64))) / (2 * h)
    assert fd < 0.0
    np.testing.assert_allclose(out["dolr"], fd, rtol=1e-3)


def test_multichip_sharding_matches_single_device(capsys):
    out = multichip_sharding.main("cpu")
    assert out["shards"] == 8
    assert capsys.readouterr().out.splitlines()[-1] == (
        "cols-mesh fluxes match the single-device solve")


def test_raytrace_3d(capsys):
    out = raytrace_3d.main("cpu")
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert out["solve"].rt_flux_abs_dir.shape == (13, 8, 8)


def test_walkthrough_without_card_raises():
    """``python -m rte_rrtmgp_torch.examples.basic_usage`` with no card
    and no ``--device cpu`` stops before any work."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['basic_usage']; "
         "import runpy; runpy.run_module("
         "'rte_rrtmgp_torch.examples.basic_usage', run_name='__main__')"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "LW sfc" not in res.stdout
