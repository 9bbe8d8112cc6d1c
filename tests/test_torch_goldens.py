"""The port's frozen tracer goldens (``tests/goldens_torch/``, written once
by ``python -m rte_rrtmgp_torch.tools.make_goldens --device cpu``): the
port's counterpart of ``tests/test_goldens.py``'s two Monte-Carlo gates.

* The forward tracer's case (``make_goldens.solve_rt_case``: the inputs of
  ``tests/golden_case.py``'s ``solve_rt_case``, the port's random stream)
  solved again on the CPU matches ``rt_f32.nc`` at ``MC_RTOL`` 1e-4 /
  ``MC_ATOL`` 1e-5: red if a tracer constant is perturbed.
* The camera case's cut (one visible spectral step at 1 photon a pixel,
  ``make_goldens.BW_CUT``; the whole render takes ~20 min on a CPU)
  matches the ``*_cut`` arrays of ``bw_f32.nc`` at the same tolerances.
* The frozen whole solves (``rt_f32.nc``; ``bw_f32.nc``'s ``bw_radiance``
  and ``bw_xyz``, the whole render) lie within the Monte-Carlo error of
  the JAX package's frozen ``tests/goldens/rt_f32.nc`` / ``bw_f32.nc``:
  the mean over pixels (cells) of the port-minus-JAX differences within 4
  standard errors, the standard error taken from the spread of those
  differences (the two streams differ, so the goldens cannot match bit
  for bit).
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)

from rte_rrtmgp_torch.tools import make_goldens as mg
from rte_rrtmgp_torch.utils.ncio import NcReader

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = os.path.join(HERE, "goldens_torch")
JAX = os.path.join(HERE, "goldens")
RT_VARS = ("rt_flux_tod_dn", "rt_flux_tod_up", "rt_flux_sfc_dir",
           "rt_flux_sfc_dif", "rt_flux_sfc_up", "rt_flux_abs_dir",
           "rt_flux_abs_dif")
BW_VARS = ("bw_radiance", "bw_xyz")


def _check_against(path, got):
    with NcReader(path) as nc:
        for name, arr in got.items():
            ref = nc.read(name)
            assert ref.shape == arr.shape, name
            np.testing.assert_allclose(arr, ref, rtol=mg.MC_RTOL,
                                       atol=mg.MC_ATOL, err_msg=name)


def test_rt_solve_matches_port_golden():
    got = mg.solve_rt_case()
    assert sorted(got) == sorted(RT_VARS)
    _check_against(os.path.join(PORT, mg.RT_NAME), got)


def test_bw_cut_matches_port_golden():
    got = mg.solve_bw_case(**mg.BW_CUT)
    _check_against(os.path.join(PORT, mg.BW_NAME),
                   {k + "_cut": v for k, v in got.items()})


@pytest.mark.parametrize("name, var", [(mg.RT_NAME, v) for v in RT_VARS]
                         + [(mg.BW_NAME, v) for v in BW_VARS])
def test_port_golden_within_mc_error_of_jax(name, var):
    with NcReader(os.path.join(PORT, name)) as p, \
            NcReader(os.path.join(JAX, name)) as j:
        a, b = (nc.read(var).astype(np.float64) for nc in (p, j))
    assert a.shape == b.shape and np.isfinite(a).all()
    d = (a - b).ravel()
    stderr = d.std(ddof=1) / np.sqrt(d.size)
    assert abs(d.mean()) <= 4.0 * stderr + 1e-6 * abs(b.mean()), (
        var, a.mean(), b.mean(), stderr)
