"""Gas volume-mixing-ratio container.

Counterpart of the reference ``Gas_concs`` (``include/Gas_concs.h:40-66``):
a mapping gas-name -> vmr that accepts a scalar, a profile ``(nlay,)`` or a
full field ``(ncol, nlay)`` and broadcasts on demand.  Values stay NumPy on
the host until ``materialize`` packs the gases a k-distribution needs into
one dense ``(ncol, nlay, ngas)`` array (replaces the reference's per-gas
``vmr`` fill loop in ``src/Gas_optics_rrtmgp.cpp:1121-1150``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class GasConcs:
    def __init__(self):
        self._vmr: Dict[str, np.ndarray] = {}

    def set_vmr(self, name: str, vmr) -> None:
        arr = np.asarray(vmr, dtype=np.float64)
        if arr.ndim > 2:
            raise ValueError(f"vmr for {name} has ndim {arr.ndim} > 2")
        self._vmr[name.lower()] = arr

    def get_vmr(self, name: str) -> np.ndarray:
        return self._vmr[name.lower()]

    def exists(self, name: str) -> bool:
        return name.lower() in self._vmr

    def names(self):
        return list(self._vmr)

    def subset_cols(self, col_s: int, n: int) -> "GasConcs":
        """Column-range subset (reference ``Gas_concs(gas_concs, col_s, n)``)."""
        out = GasConcs()
        for k, v in self._vmr.items():
            out._vmr[k] = v[col_s : col_s + n] if v.ndim == 2 else v
        return out

    def expand(self, name: str, ncol: int, nlay: int) -> np.ndarray:
        """Broadcast a gas's vmr to a full (ncol, nlay) field."""
        v = self._vmr[name.lower()]
        if v.ndim == 0:
            return np.full((ncol, nlay), float(v))
        if v.ndim == 1:
            if v.shape[0] != nlay:
                raise ValueError(f"{name}: profile length {v.shape[0]} != nlay {nlay}")
            return np.broadcast_to(v[None, :], (ncol, nlay)).copy()
        if v.shape != (ncol, nlay):
            raise ValueError(f"{name}: shape {v.shape} != ({ncol}, {nlay})")
        return v

    def materialize(self, gas_names: Sequence[str], ncol: int, nlay: int,
                    dtype=np.float64) -> np.ndarray:
        """Pack vmrs for ``gas_names`` into (ncol, nlay, ngas)."""
        out = np.zeros((ncol, nlay, len(gas_names)), dtype=dtype)
        for i, g in enumerate(gas_names):
            out[:, :, i] = self.expand(g, ncol, nlay)
        return out


# The reference aliases Aerosol_concs = Gas_concs (include/Aerosol_optics.h:19).
AerosolConcs = GasConcs
