"""Precision guards, physical constants and device selection.

The dtype guards are those of the reference's FP64/FP32 builds
(``include/types.h:13-28``):

* ``k_min`` floors the two-stream diffusion eigenvalue k**2
  (``src_kernels_cuda/rte_solver_kernels.cu:11-13``: 1e-12 FP64 / 1e-4 FP32);
* ``eps`` / ``tiny`` are machine epsilon / the smallest normal number;
* ``tau_thres`` switches the LW linear-in-tau source to its series.

Kernel dispatch is by tensor device and dtype: a float32 CUDA tensor goes
through the hand-written kernels of ``ops/kernels``, a CPU or float64
tensor through their plain PyTorch twins (the JAX package's rule: Pallas
for float32, XLA for float64).  There is no switch that turns the kernels off on the card.
The two layout switches below choose WHICH kernels a step runs
(:func:`cellw_enabled`, :func:`layer_major_enabled`): the environment, else
the winner the tuner persisted for the device kind, else the default.
"""

from __future__ import annotations

import math
import os

import torch

FLOAT = torch.float32


def eps(dtype=None) -> float:
    return float(torch.finfo(dtype or FLOAT).eps)


def tiny(dtype=None) -> float:
    return float(torch.finfo(dtype or FLOAT).tiny)


def k_min(dtype=None) -> float:
    """Floor for (gamma1-gamma2)*(gamma1+gamma2) in the SW two-stream solver."""
    return 1.0e-12 if (dtype or FLOAT) == torch.float64 else 1.0e-4


def tau_thres(dtype=None) -> float:
    """Small-tau switch point of the LW linear-in-tau source: eps**(1/4)."""
    return float(math.sqrt(math.sqrt(eps(dtype))))


# Physical constants (match the reference, src/Gas_optics_rrtmgp.cpp:764-792).
GRAV = 9.80665          # m s-2
AVOGADRO = 6.02214076e23
M_DRY = 0.028964        # kg mol-1
M_H2O = 0.018016        # kg mol-1

# Solar variability composition offsets (src/Gas_optics_rrtmgp.cpp:748-749).
SOLAR_A_OFFSET = 0.1495954
SOLAR_B_OFFSET = 0.00066696

# Surface Planck-source Jacobian temperature perturbation
# (src_kernels_cuda/gas_optics_rrtmgp_kernels_launchers.cu:474).
DELTA_TSURF = 1.0


def _layout_flag(env_name: str, tuned_key: str, default: bool,
                 device) -> bool:
    """Environment > persisted tuner winner for ``device``'s kind >
    ``default`` (the JAX package's order, ``ops/gas_optics.py:355-373``)."""
    env = os.environ.get(env_name)
    if env is not None:
        return env not in ("0", "false", "off")
    from .utils import tuner

    tuned = (tuner.best_kernel_opts(device) or {}).get(tuned_key)
    return default if tuned is None else bool(tuned)


def cellw_enabled(device=None) -> bool:
    """Gas optics from per-cell weights resolved in-kernel (the default
    kernel, ``csrc/gas_optics_interp.cu``) rather than from precomputed
    per-g weight planes (``csrc/interp_rows.cu``).
    ``RTE_RRTMGP_PALLAS_CELLW``, else the tuned winner's ``cellw`` for
    ``device`` (``None``: the default device), else on."""
    return _layout_flag("RTE_RRTMGP_PALLAS_CELLW", "cellw", True, device)


def layer_major_enabled(device=None) -> bool:
    """Layer-major (nlay*ncol, G) planes from the gas optics into the
    layer-major solver kernels.  ``RTE_RRTMGP_LAYERMAJOR``, else the tuned
    winner's ``layermajor`` for ``device``, else off."""
    return _layout_flag("RTE_RRTMGP_LAYERMAJOR", "layermajor", False, device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    card is present — the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rte_rrtmgp_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
