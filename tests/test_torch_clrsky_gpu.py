"""The clear-sky call on the card (marker ``gpu``; skipped inside the
``cuda`` fixture where there is no card), at the benchmark's cell size:
4096 columns x 256 layers, the published tables' shapes
(``benchmark/inputs``), 128-g chunks.  Run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_clrsky_gpu.py

In each layout ``make_step(..., clear_sky=True)`` launches the gas-optics
kernels as often as ``clear_sky=False`` does and the solver kernels twice
as often, solves 480 g-points clear-sky, returns the all-sky fluxes
bit-equal, and peaks within 0.1 GiB of the all-sky step (no optical plane
is copied)."""

import numpy as np
import pytest
import torch

from rte_rrtmgp_torch import step
from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
from rte_rrtmgp_torch.models import radiation
from rte_rrtmgp_torch.models.kdist import KDist
from rte_rrtmgp_torch.ops import kernels

pytestmark = pytest.mark.gpu
NCOL, NLAY, SEED = 4096, 256, 2 ** 31 + 16
# (cellw, layer_major) -> (gas-optics kernels, solver kernels)
LAYOUTS = {"default": ((True, False), ("gas_optics_interp",),
                       ("lw_sweep", "sw_2stream")),
           "cellw_off": ((False, False), ("interp_rows_multi", "interp_rows"),
                         ("lw_sweep", "sw_2stream")),
           "layer_major": ((True, True), ("gas_optics_interp",),
                           ("lw_sweep_lm", "sw_2stream_lm"))}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kernels.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cell(cuda):
    from benchmark.inputs import atmosphere, tables

    gases = tables.GAS_NAMES
    tabs = (*(KDist.from_raw(tables.make_kdist_raw(lw, SEED), gases,
                             device=cuda) for lw in (True, False)),
            *(CloudLUT.from_raw(tables.make_cloud_raw(lw, SEED), device=cuda)
              for lw in (True, False)))
    arrs = atmosphere.step_arrays(
        atmosphere.make_atmosphere(NCOL, NLAY, SEED), np.float32, gases)
    args = [torch.as_tensor(arrs[k], device=cuda) for k in step.ARG_NAMES]
    return tabs, args


def _call(cell, layout, clear_sky):
    """(outputs, launch counts, clear-sky g-points, peak bytes) of one
    call."""
    tabs, args = cell
    (cellw, lm), _, _ = LAYOUTS[layout]
    run = step.make_step(*tabs, gpt_chunk=128, cellw=cellw, layer_major=lm,
                         clear_sky=clear_sky)
    run(*args)     # warm-up: cached interval rows, allocator
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    radiation.clrsky_gpts(reset=True)
    out = run(*args)
    torch.cuda.synchronize()
    return (out, kernels.launch_counts(), radiation.clrsky_gpts(),
            torch.cuda.max_memory_allocated())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_clear_sky_shares_gas_optics_and_doubles_solves(cell, layout):
    _, gas, solvers = LAYOUTS[layout]
    off, n_off, g_off, peak_off = _call(cell, layout, False)
    on, n_on, g_on, peak_on = _call(cell, layout, True)
    assert (g_off, g_on) == (0, 480)
    for k in gas:
        assert n_on[k] == n_off[k] > 0, (k, n_off, n_on)
    for k in solvers:
        assert n_on[k] == 2 * n_off[k] > 0, (k, n_off, n_on)
    assert len(on) == 2 * len(off) == 14
    for k, v in off.items():
        assert torch.equal(on[k], v), k
        c = on[k.replace("_flux", "_clrsky_flux")]
        assert bool(torch.isfinite(c).all()), k
    # Clear sky lets more sunlight reach the surface than cloudy sky.
    assert float(on["sw_clrsky_flux_dn"][:, 0].mean()) > float(
        on["sw_flux_dn"][:, 0].mean())
    assert peak_on - peak_off < 0.1 * 2 ** 30, (peak_off, peak_on)
