"""Optical-property combination ops: increments, delta scaling.

Reference: ``src_kernels_cuda/optical_props_kernels.cu`` (increment /
inc_bybnd / delta_scale kernels) and the ``add_to`` free functions in
``src/Optical_props.cpp:219-268``.  All elementwise.
"""

from __future__ import annotations

import torch

from .. import config
from ..models.types import OpticalProps1scl, OpticalProps2str
from .fluxes import expand_bands_to_gpt


def increment_1scl_by_1scl(op1: OpticalProps1scl, op2: OpticalProps1scl):
    return OpticalProps1scl(tau=op1.tau + op2.tau)


def increment_2str_by_2str(op1: OpticalProps2str, op2: OpticalProps2str):
    eps = config.eps(op1.tau.dtype)
    tau12 = op1.tau + op2.tau
    tauscat12 = op1.tau * op1.ssa + op2.tau * op2.ssa
    g = ((op1.tau * op1.ssa * op1.g + op2.tau * op2.ssa * op2.g)
         / torch.clamp(tauscat12, min=eps))
    ssa = tauscat12 / torch.clamp(tau12, min=eps)
    return OpticalProps2str(tau=tau12, ssa=ssa, g=g)


def increment_1scl_by_1scl_bybnd(op1: OpticalProps1scl,
                                 op2_bnd: OpticalProps1scl, gpt2band):
    """op2 has one value per band; expand to g-points then add
    (inc_1scalar_by_1scalar_bybnd_kernel)."""
    tau2 = expand_bands_to_gpt(op2_bnd.tau, gpt2band)
    return OpticalProps1scl(tau=op1.tau + tau2)


def increment_2str_by_2str_bybnd(op1: OpticalProps2str,
                                 op2_bnd: OpticalProps2str, gpt2band):
    op2 = OpticalProps2str(
        tau=expand_bands_to_gpt(op2_bnd.tau, gpt2band),
        ssa=expand_bands_to_gpt(op2_bnd.ssa, gpt2band),
        g=expand_bands_to_gpt(op2_bnd.g, gpt2band),
    )
    return increment_2str_by_2str(op1, op2)


def delta_scale(op: OpticalProps2str) -> OpticalProps2str:
    """Delta-Eddington scaling with f = g**2 (delta_scale_2str_k_kernel)."""
    eps = config.eps(op.tau.dtype)
    f = op.g * op.g
    wf = op.ssa * f
    tau = op.tau * (1.0 - wf)
    ssa = (op.ssa - wf) / torch.clamp(1.0 - wf, min=eps)
    g = (op.g - f) / torch.clamp(1.0 - f, min=eps)
    return OpticalProps2str(tau=tau, ssa=ssa, g=g)
