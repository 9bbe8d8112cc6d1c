"""Aerosol optics lookup tables (reference ``Aerosol_optics``,
``include/Aerosol_optics.h`` + ``src/Aerosol_optics.cpp``).

The 11 CAMS/ECMWF aerosol species (SS1-3, DU1-3, OM1-2, BC1-2, SU) with their
hydrophobic-table column or hydrophilic-table species index are a static
spec, so the species loop is a plain Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import config
from .kdist import read_raw, to_tensor


class AerosolSpecies(NamedTuple):
    mmr_name: str     # aermr01 .. aermr11
    philic: bool
    table_idx: int    # 0-based column in phobic/philic table


# Mapping from src/Aerosol_optics.cpp:64-144 (1-based table indices there).
AEROSOL_SPECIES: Tuple[AerosolSpecies, ...] = (
    AerosolSpecies("aermr01", True, 0),    # SS1
    AerosolSpecies("aermr02", True, 1),    # SS2
    AerosolSpecies("aermr03", True, 2),    # SS3
    AerosolSpecies("aermr04", False, 0),   # DU1
    AerosolSpecies("aermr05", False, 7),   # DU2
    AerosolSpecies("aermr06", False, 5),   # DU3
    AerosolSpecies("aermr07", True, 3),    # OM2 (hydrophilic organic)
    AerosolSpecies("aermr08", False, 9),   # OM1 (hydrophobic organic)
    AerosolSpecies("aermr09", False, 10),  # BC1
    AerosolSpecies("aermr10", False, 10),  # BC2
    AerosolSpecies("aermr11", True, 4),    # SU
)


@dataclasses.dataclass(frozen=True)
class AerosolLUT:
    # (nbnd, nphobic) and (nbnd, nhum, nphilic) tables.
    mext_phobic: torch.Tensor
    ssa_phobic: torch.Tensor
    g_phobic: torch.Tensor
    mext_philic: torch.Tensor
    ssa_philic: torch.Tensor
    g_philic: torch.Tensor
    rh_upper: torch.Tensor  # (nhum,) upper bounds of relative-humidity classes
    nhum: int

    @property
    def nbnd(self) -> int:
        return self.mext_phobic.shape[0]

    @staticmethod
    def from_netcdf(path: str, dtype=None, device=None) -> "AerosolLUT":
        """Load an aerosol-optics file through :meth:`from_raw`.  ``device``
        defaults to ``cuda``."""
        return AerosolLUT.from_raw(read_raw(path), dtype=dtype, device=device)

    @staticmethod
    def from_raw(raw: dict, dtype=None, device=None) -> "AerosolLUT":
        """Build the LUT from the raw variables of an aerosol-optics file
        (C-order: (nphobic, nband) / (nphilic, nhum, nband)).  ``device``
        defaults to ``cuda``."""
        device = config.resolve_device(device)
        dtype = dtype or config.FLOAT
        t = lambda a: to_tensor(a, device, dtype)
        phobic = lambda k: t(np.asarray(raw[k]).T)
        philic = lambda k: t(np.transpose(np.asarray(raw[k]), (2, 1, 0)))
        rh_upper = t(raw["relative_humidity2"])
        return AerosolLUT(
            mext_phobic=phobic("mass_ext_sw_hydrophobic"),
            ssa_phobic=phobic("ssa_sw_hydrophobic"),
            g_phobic=phobic("asymmetry_sw_hydrophobic"),
            mext_philic=philic("mass_ext_sw_hydrophilic"),
            ssa_philic=philic("ssa_sw_hydrophilic"),
            g_philic=philic("asymmetry_sw_hydrophilic"),
            rh_upper=rh_upper, nhum=int(rh_upper.shape[0]),
        )
