"""Cloud optics lookup tables (reference ``Cloud_optics``,
``include/Cloud_optics.h`` + ``src/Cloud_optics.cpp``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import config
from .kdist import read_raw, to_tensor


@dataclasses.dataclass(frozen=True)
class CloudLUT:
    # (nsize, nbnd) tables; ice tables already sliced at roughness icergh=2
    # (src/Cloud_optics.cpp:56-68).
    lut_extliq: torch.Tensor
    lut_ssaliq: torch.Tensor
    lut_asyliq: torch.Tensor
    lut_extice: torch.Tensor
    lut_ssaice: torch.Tensor
    lut_asyice: torch.Tensor

    radliq_lwr: float
    radliq_upr: float
    diamice_lwr: float
    diamice_upr: float
    liq_nsteps: int
    ice_nsteps: int
    liq_step_size: float
    ice_step_size: float
    band_lims_wvn: Tuple[Tuple[float, float], ...]

    @property
    def nbnd(self) -> int:
        return self.lut_extliq.shape[1]

    @staticmethod
    def from_netcdf(path: str, dtype=None, device=None) -> "CloudLUT":
        """Load a cloud-optics file through :meth:`from_raw`.  ``device``
        defaults to ``cuda``."""
        return CloudLUT.from_raw(read_raw(path), dtype=dtype, device=device)

    @staticmethod
    def from_raw(raw: dict, dtype=None, device=None) -> "CloudLUT":
        """Build the LUT from the raw variables of a cloud-optics file
        (C-order, as a NetCDF reader returns them).  ``device`` defaults to
        ``cuda``."""
        device = config.resolve_device(device)
        dtype = dtype or config.FLOAT
        scalar = lambda k: float(np.asarray(raw[k]).reshape(-1)[0])
        radliq_lwr, radliq_upr = scalar("radliq_lwr"), scalar("radliq_upr")
        diamice_lwr, diamice_upr = scalar("diamice_lwr"), scalar("diamice_upr")
        # File layout (C-order): liquid (nbnd, nsize) -> (nsize, nbnd);
        # ice (nrghice, nbnd, nsize) -> roughness category 2 (index 1).
        liq = {k: np.asarray(raw[k]).T for k in
               ("lut_extliq", "lut_ssaliq", "lut_asyliq")}
        ice = {k: np.asarray(raw[k])[1].T for k in
               ("lut_extice", "lut_ssaice", "lut_asyice")}
        blw = np.asarray(raw["bnd_limits_wavenumber"])
        nliq = liq["lut_extliq"].shape[0]
        nice = ice["lut_extice"].shape[0]
        t = lambda a: to_tensor(a, device, dtype)
        return CloudLUT(
            **{k: t(v) for k, v in {**liq, **ice}.items()},
            radliq_lwr=radliq_lwr, radliq_upr=radliq_upr,
            diamice_lwr=diamice_lwr, diamice_upr=diamice_upr,
            liq_nsteps=nliq, ice_nsteps=nice,
            liq_step_size=float((radliq_upr - radliq_lwr) / (nliq - 1)),
            ice_step_size=float((diamice_upr - diamice_lwr) / (nice - 1)),
            band_lims_wvn=tuple((float(a), float(b)) for a, b in blw),
        )
