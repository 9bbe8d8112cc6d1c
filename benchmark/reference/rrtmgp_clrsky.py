"""Plain reference of the CMIP radiation call: all-sky and clear-sky LW +
SW broadband fluxes.

The all-sky keys are :func:`benchmark.reference.rrtmgp.outputs` as they
are.  The clear-sky keys (``lw_clrsky_flux_*``, ``sw_clrsky_flux_*``) are
the same call with the liquid and ice water paths set to zero: with no
water the cloud optical depth is exactly 0, so the LW cloud add, the SW
cloud increment and the delta scaling leave the gas optics as they were,
and the call solves the gas-only optics, as a clear-sky solve does.  One
departure from the program: the reference runs the cloud stages on zero
clouds where the program skips them and solves its gas-only optics
directly (the SW single-scattering albedo then passes once through
``tau * ssa / max(tau, eps)``, which differs from ``ssa`` only where the
gas optical depth is below eps).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rrtmgp


def outputs(raws: dict, inputs: dict, options: dict, device,
            dtype=torch.float64) -> dict:
    """The fourteen outputs of one call, each (ncol, nlev) float64 NumPy;
    arguments as :func:`benchmark.reference.rrtmgp.outputs`."""
    out = rrtmgp.outputs(raws, inputs, options, device, dtype)
    clear = dict(inputs, lwp=np.zeros_like(inputs["lwp"]),
                 iwp=np.zeros_like(inputs["iwp"]))
    for k, v in rrtmgp.outputs(raws, clear, options, device, dtype).items():
        out[k.replace("_flux", "_clrsky_flux", 1)] = v
    return out
