"""Carry tables across from another implementation's NumPy arrays.

Each function takes a table dataclass's float fields as NumPy arrays (a
mapping of field name -> array or None) plus its static metadata (a
mapping of field name -> value), and returns the port's dataclass on
``device`` in ``dtype``.  Fields the port does not keep are ignored, so the
fields of a dataclass with the same field names (such as the JAX package's
``KDist``) can be handed over whole, and both implementations then compute
with the same tables.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from . import config
from .models.aerosol_lut import AerosolLUT
from .models.cloud_lut import CloudLUT
from .models.kdist import META_FIELDS, TABLE_FIELDS, KDist, MinorSpec, to_tensor


def _tables(arrays, names, device, dtype):
    return {k: to_tensor(arrays.get(k), device, dtype) for k in names}


def _tuples(x):
    """Nested lists/arrays of metadata -> nested tuples (hashable)."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def kdist_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                     meta: Mapping[str, Any], *, device=None,
                     dtype=None) -> KDist:
    device = config.resolve_device(device)
    dtype = dtype or config.FLOAT
    m = {k: meta[k] for k in META_FIELDS}
    for k in ("minor_lower", "minor_upper"):
        m[k] = tuple(MinorSpec(*(_tuples(v) for v in s)) for s in m[k])
    for k in ("gas_names", "flavor", "gpoint_flavor", "gpt2band",
              "band_lims_gpt", "band_lims_wvn"):
        m[k] = _tuples(m[k])
    return KDist(**_tables(arrays, TABLE_FIELDS, device, dtype), **m)


def cloud_lut_from_numpy(arrays: Mapping[str, np.ndarray],
                         meta: Mapping[str, Any], *, device=None,
                         dtype=None) -> CloudLUT:
    device = config.resolve_device(device)
    dtype = dtype or config.FLOAT
    names = ("lut_extliq", "lut_ssaliq", "lut_asyliq",
             "lut_extice", "lut_ssaice", "lut_asyice")
    m = {k: meta[k] for k in (
        "radliq_lwr", "radliq_upr", "diamice_lwr", "diamice_upr",
        "liq_nsteps", "ice_nsteps", "liq_step_size", "ice_step_size")}
    return CloudLUT(**_tables(arrays, names, device, dtype), **m,
                    band_lims_wvn=_tuples(meta["band_lims_wvn"]))


def aerosol_lut_from_numpy(arrays: Mapping[str, np.ndarray],
                           meta: Mapping[str, Any], *, device=None,
                           dtype=None) -> AerosolLUT:
    device = config.resolve_device(device)
    dtype = dtype or config.FLOAT
    names = ("mext_phobic", "ssa_phobic", "g_phobic", "mext_philic",
             "ssa_philic", "g_philic", "rh_upper")
    return AerosolLUT(**_tables(arrays, names, device, dtype),
                      nhum=int(meta["nhum"]))
