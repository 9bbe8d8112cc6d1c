"""Optical-property and source-function containers.

The reference's ``Optical_props_1scl`` / ``Optical_props_2str`` /
``Source_func_lw`` (``include/Optical_props.h:94-162``,
``include/Source_functions.h:35-93``) as dataclasses of tensors.  All
tensors are 0-based C-order:

* ``tau/ssa/g``:   (ncol, nlay, ngpt)
* ``sfc_src``:     (ncol, ngpt)
* ``lay_src``:     (ncol, nlay, ngpt)
* ``lev_src``:     (ncol, nlay+1, ngpt)
"""

from __future__ import annotations

import dataclasses

import torch


class _Sizes:
    """(ncol, nlay, ngpt) read off ``tau``."""

    @property
    def ncol(self) -> int:
        return self.tau.shape[0]

    @property
    def nlay(self) -> int:
        return self.tau.shape[1]

    @property
    def ngpt(self) -> int:
        return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalProps1scl(_Sizes):
    """Absorption-only optical depth (longwave no-scattering path)."""

    tau: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OpticalProps2str(_Sizes):
    """Two-stream optical properties: optical depth, single-scattering
    albedo, asymmetry parameter."""

    tau: torch.Tensor
    ssa: torch.Tensor
    g: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SourceFuncLW:
    """Planck source functions for the longwave solver."""

    sfc_src: torch.Tensor      # (ncol, ngpt)
    sfc_src_jac: torch.Tensor  # (ncol, ngpt)
    lay_src: torch.Tensor      # (ncol, nlay, ngpt)
    lev_src: torch.Tensor      # (ncol, nlay+1, ngpt)
