"""Bytes and float32 operations that a radiation call's stages need.

Counted from the configuration's shapes and the raw tables' sizes, never
from the program, for the roofline shares of ``metrics/``: the least time
of a stage is the larger of its bytes over the card's memory bandwidth and
its operations over its float32 rate (:data:`PEAKS`).  Each input is
counted read once and each output written once a call, whatever the
program reads again; where a count is not certain it is left low, so that
the least time stays a lower bound.

* ``gas_optics`` (the driver's ``lw_gas_optics`` and ``sw_gas_optics``
  ranges): reads each cell's pressure, temperature, dry-air and gas
  columns (3 + ngas float32 values a cell a spectrum) and the k tables,
  the minor ones with them, once; writes the LW
  absorption depth and Planck fraction, and the SW absorption and
  Rayleigh depths, one float32 plane (ncol x nlay x ngpt) each.
  Operations: the major-gas interpolation (8 products, 7 sums and 2
  scalings by the mixed column a g-point and cell) and the Planck-fraction
  (15) or Rayleigh (4 products, 3 sums, 1 scaling) interpolation; the
  minor gases are not counted.
* ``solvers`` (``lw_solve`` and ``sw_solve``): reads the LW optical depth,
  layer and level sources, and the SW optical depth, single-scattering
  albedo and asymmetry planes, plus a (ncol x ngpt) plane of each surface
  and top-of-atmosphere value; writes the broadband up and down fluxes
  (and the SW direct beam), (ncol x nlev) each.  Operations: 20 a cell and
  g-point in the LW (optical depth, transmittance, linear-in-tau sources,
  two sweeps), 80 in the SW (two-stream coefficients, direct beam, the
  adding sweeps), each transcendental counted as one.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3
# bandwidth and float32 outside the tensor cores.
PEAKS = {"bytes_per_s": 3.35e12, "flops_per_s": 67.0e12}
F32 = 4


def _k_table_elems(raw: dict) -> int:
    """Elements of the tables a gas-optics pass reads: the major table,
    the Planck-fraction or both Rayleigh tables, the minor tables."""
    n = raw["kmajor"].size + raw["kminor_lower"].size + raw["kminor_upper"].size
    if "plank_fraction" in raw:
        n += raw["plank_fraction"].size
    else:
        n += raw["rayl_lower"].size + raw["rayl_upper"].size
    return int(n)


def _ngpt(raw: dict) -> int:
    return int(raw["kmajor"].shape[-1])


def gas_optics(ncol: int, nlay: int, kd_lw: dict, kd_sw: dict,
               ngas: int) -> dict:
    """{"bytes", "flops"} of the LW and SW gas-optics stages of one call
    with ``ngas`` gases."""
    n = ncol * nlay
    g_lw, g_sw = _ngpt(kd_lw), _ngpt(kd_sw)
    cells_in = 2 * n * (3 + ngas) * F32
    tables = (_k_table_elems(kd_lw) + _k_table_elems(kd_sw)) * F32
    planes = 2 * n * (g_lw + g_sw) * F32
    flops = n * g_lw * (17 + 15) + n * g_sw * (17 + 8)
    return {"bytes": cells_in + tables + planes, "flops": flops}


def solvers(ncol: int, nlay: int, kd_lw: dict, kd_sw: dict) -> dict:
    """{"bytes", "flops"} of the LW and SW solve stages of one call."""
    n, nlev = ncol * nlay, nlay + 1
    g_lw, g_sw = _ngpt(kd_lw), _ngpt(kd_sw)
    lw_in = (2 * n + ncol * nlev) * g_lw + 2 * ncol * g_lw
    sw_in = 3 * n * g_sw + 3 * ncol * g_sw + ncol
    out = (2 + 3) * ncol * nlev
    flops = 20 * n * g_lw + 80 * n * g_sw
    return {"bytes": (lw_in + sw_in + out) * F32, "flops": flops}


def least_seconds(work: dict) -> float:
    """The least time the card needs for ``work``: the larger of its bytes
    over the memory bandwidth and its operations over the float32 rate."""
    return max(work["bytes"] / PEAKS["bytes_per_s"],
               work["flops"] / PEAKS["flops_per_s"])
