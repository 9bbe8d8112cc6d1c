"""RRTMGP k-distribution tables as a dataclass of tensors.

Counterpart of the reference ``Gas_optics_rrtmgp`` class
(``include/Gas_optics_rrtmgp.h`` + ``src/Gas_optics_rrtmgp.cpp``).  The
init-time logic of ``init_abs_coeffs`` (``src/Gas_optics_rrtmgp.cpp:539-742``)
runs once at load time in NumPy:

* gas-union reduction to the gases available in the host model,
* minor-absorber array reduction (``reduce_minor_arrays``, `:54-162`),
* flavor / g-point-flavor construction (`:247-363`),
* kmajor / krayl / planck_frac memory-layout normalization (`:657-677`),
* solar-variability composition (`:745-760`).

Float tables are tensors on one device; index metadata (flavors, g-point
maps, minor-interval specs) is static Python tuples.

Array layouts (0-based, C-order):

* ``kmajor``      (ngpt, npress+1, neta, ntemp)
* ``kminor_*``    (ncontrib, neta, ntemp)
* ``krayl``       (2, ngpt, neta, ntemp)   [0]=troposphere, [1]=upper
* ``planck_frac`` (ngpt, npress+1, neta, ntemp)
* ``totplnk``     (nPlanckTemp, nbnd)
* ``vmr_ref``     (2, ngas+1, ntemp)       gas 0 = dry air

and the g-contiguous interpolation tables the gas-optics kernel reads (the
last axis is g, so neighbouring threads read neighbouring addresses):

* ``kmajor_rows`` / ``planck_rows``  ((npress+1)*ntemp, neta, ngpt)
* ``krayl_rows``                     (2*ntemp, neta, ngpt)
* ``kminor_*_trows``                 (ntemp, neta, ncontrib)
* ``ratio_rows``                     (2*ntemp, nflav)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..utils.ncio import NcReader, decode_strings


class MinorSpec(NamedTuple):
    """Static description of one minor-absorber interval (one atmosphere).

    Replaces the reference's parallel arrays ``minor_limits_gpt``,
    ``idx_minor``, ``idx_minor_scaling``, ``minor_scales_with_density``,
    ``scale_by_complement``, ``kminor_start``
    (``src/Gas_optics_rrtmgp.cpp:607-698``).
    """

    gpt_start: int            # 0-based inclusive
    gpt_end: int              # 0-based exclusive
    idx_minor: int            # col_gas axis index (1-based gas; 0 = dry air)
    idx_scaling: int          # col_gas axis index of scaling gas, 0 = none
    scales_with_density: bool
    scale_by_complement: bool
    kminor_start: int         # 0-based start column in the reduced kminor table
    flavor: int               # 0-based flavor index for this interval's gpts


TABLE_FIELDS = (
    "kmajor", "kminor_lower", "kminor_upper", "krayl", "planck_frac",
    "totplnk", "solar_source", "solar_source_quiet", "solar_source_facular",
    "solar_source_sunspot", "press_ref_log", "temp_ref", "vmr_ref",
    "kmajor_rows", "planck_rows", "krayl_rows", "kminor_lower_trows",
    "kminor_upper_trows", "ratio_rows",
)
META_FIELDS = (
    "gas_names", "idx_h2o", "flavor", "gpoint_flavor", "gpt2band",
    "band_lims_gpt", "minor_lower", "minor_upper",
    "press_ref_trop_log", "press_ref_log_delta",
    "temp_ref_min", "temp_ref_max", "temp_ref_delta",
    "press_ref_min", "press_ref_max", "totplnk_delta",
    "band_lims_wvn",
)


def read_raw(path: str) -> dict:
    """Every variable of a NetCDF file, as the raw dict ``from_raw`` takes."""
    with NcReader(path) as nc:
        return {name: nc.read(name) for name in nc.variables()}


def numpy_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def to_tensor(a, device, dtype):
    """NumPy array (or None) -> tensor of ``dtype`` on ``device``, cast in
    NumPy first so the values equal a NumPy ``astype`` bit for bit."""
    if a is None:
        return None
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=numpy_dtype(dtype)))
    ).to(device)


@dataclasses.dataclass(frozen=True)
class KDist:
    # ---- float tables ----
    kmajor: torch.Tensor
    kminor_lower: torch.Tensor
    kminor_upper: torch.Tensor
    krayl: Optional[torch.Tensor]         # None for pure-absorption (LW)
    planck_frac: Optional[torch.Tensor]   # LW only
    totplnk: Optional[torch.Tensor]       # LW only
    solar_source: Optional[torch.Tensor]  # SW only
    solar_source_quiet: Optional[torch.Tensor]
    solar_source_facular: Optional[torch.Tensor]
    solar_source_sunspot: Optional[torch.Tensor]
    press_ref_log: torch.Tensor           # (npress,)
    temp_ref: torch.Tensor                # (ntemp,)
    vmr_ref: torch.Tensor                 # (2, ngas+1, ntemp)
    kmajor_rows: torch.Tensor
    planck_rows: Optional[torch.Tensor]
    krayl_rows: Optional[torch.Tensor]
    kminor_lower_trows: torch.Tensor
    kminor_upper_trows: torch.Tensor
    ratio_rows: torch.Tensor

    # ---- static metadata ----
    gas_names: Tuple[str, ...]
    idx_h2o: int                          # col_gas axis index of h2o
    flavor: Tuple[Tuple[int, int], ...]   # (nflav, 2) col_gas axis indices
    gpoint_flavor: Tuple[Tuple[int, ...], Tuple[int, ...]]  # (2, ngpt) 0-based
    gpt2band: Tuple[int, ...]             # (ngpt,) 0-based band index
    band_lims_gpt: Tuple[Tuple[int, int], ...]  # (nbnd, 2) 0-based half-open
    minor_lower: Tuple[MinorSpec, ...]
    minor_upper: Tuple[MinorSpec, ...]
    press_ref_trop_log: float
    press_ref_log_delta: float
    temp_ref_min: float
    temp_ref_max: float
    temp_ref_delta: float
    press_ref_min: float
    press_ref_max: float
    totplnk_delta: Optional[float]
    band_lims_wvn: Tuple[Tuple[float, float], ...]

    # ---- derived sizes ----
    @property
    def ngas(self) -> int:
        return len(self.gas_names)

    @property
    def nflav(self) -> int:
        return len(self.flavor)

    @property
    def ngpt(self) -> int:
        return self.kmajor.shape[0]

    @property
    def neta(self) -> int:
        return self.kmajor.shape[2]

    @property
    def npress(self) -> int:
        return self.kmajor.shape[1] - 1

    @property
    def ntemp(self) -> int:
        return self.kmajor.shape[3]

    @property
    def nbnd(self) -> int:
        return len(self.band_lims_gpt)

    @property
    def source_is_internal(self) -> bool:
        """True for longwave (Planck) k-distributions."""
        return self.totplnk is not None

    @property
    def has_rayleigh(self) -> bool:
        return self.krayl is not None

    @property
    def device(self) -> torch.device:
        return self.kmajor.device

    @property
    def dtype(self) -> torch.dtype:
        return self.kmajor.dtype

    def slice_gpt(self, g0: int, g1: int) -> "KDist":
        """Restrict the k-distribution to g-points [g0, g1).

        Spectral chunks are k-distributions of their own, so the pipeline
        runs chunk by chunk with O(ncol*nlay*chunk) memory (the reference's
        per-g-point streaming, ``src_cuda_rt/Gas_optics_rrtmgp_rt.cu:405-415``).
        The g-indexed tables become views (no copy); the row tables keep
        g as their unit-stride axis.  Band metadata keeps *global* band
        indices (``gpt2band``) so by-band sums land in the global band axis.
        """
        def slc(a, axis=0):
            return None if a is None else a.narrow(axis, g0, g1 - g0)

        new_minor = {"minor_lower": [], "minor_upper": []}
        for key in ("minor_lower", "minor_upper"):
            for s in getattr(self, key):
                lo = max(s.gpt_start, g0)
                hi = min(s.gpt_end, g1)
                if lo >= hi:
                    continue
                new_minor[key].append(s._replace(
                    gpt_start=lo - g0,
                    gpt_end=hi - g0,
                    kminor_start=s.kminor_start + (lo - s.gpt_start),
                ))

        return dataclasses.replace(
            self,
            kmajor=slc(self.kmajor),
            krayl=slc(self.krayl, axis=1),
            planck_frac=slc(self.planck_frac),
            kmajor_rows=slc(self.kmajor_rows, axis=2),
            planck_rows=slc(self.planck_rows, axis=2),
            krayl_rows=slc(self.krayl_rows, axis=2),
            # kminor_* / ratio_rows are not g-indexed: the minor tables are
            # addressed by per-spec column ranges (kminor_start stays a
            # full-table offset) and the ratio table is per flavor.
            solar_source=slc(self.solar_source),
            solar_source_quiet=slc(self.solar_source_quiet),
            solar_source_facular=slc(self.solar_source_facular),
            solar_source_sunspot=slc(self.solar_source_sunspot),
            gpoint_flavor=(self.gpoint_flavor[0][g0:g1],
                           self.gpoint_flavor[1][g0:g1]),
            gpt2band=self.gpt2band[g0:g1],
            band_lims_gpt=tuple(
                (max(b0, g0) - g0, min(b1, g1) - g0)
                for (b0, b1) in self.band_lims_gpt if max(b0, g0) < min(b1, g1)),
            minor_lower=tuple(new_minor["minor_lower"]),
            minor_upper=tuple(new_minor["minor_upper"]),
        )

    def with_solar_variability(self, mg_index: float, sb_index: float) -> "KDist":
        """Recompose the solar source (reference ``set_solar_variability``,
        ``src/Gas_optics_rrtmgp.cpp:745-760``)."""
        solar = (self.solar_source_quiet
                 + (mg_index - config.SOLAR_A_OFFSET) * self.solar_source_facular
                 + (sb_index - config.SOLAR_B_OFFSET) * self.solar_source_sunspot)
        return dataclasses.replace(self, solar_source=solar)

    def total_solar_irradiance(self) -> float:
        return float(np.sum(self.solar_source.cpu().numpy()))

    # ------------------------------------------------------------------
    @staticmethod
    def from_netcdf(path: str, available_gases: Sequence[str], dtype=None,
                    device=None) -> "KDist":
        """Load a k-distribution coefficient file (the variable names of
        the files ``src_test/Radiation_solver.cpp:70-284`` reads) through
        :meth:`from_raw`.  ``device`` defaults to ``cuda``."""
        return KDist.from_raw(read_raw(path), available_gases, dtype=dtype,
                              device=device)

    @staticmethod
    def from_raw(raw: dict, available_gases: Sequence[str], dtype=None,
                 device=None) -> "KDist":
        """Build a KDist from raw file-layout arrays (C-order, as a NetCDF
        reader returns the coefficient files).  Implements
        ``init_abs_coeffs``.  ``device`` defaults to ``cuda``."""
        device = config.resolve_device(device)
        dtype = dtype or config.FLOAT
        available = {g.lower() for g in available_gases}

        def strings(name):
            return [s.lower() for s in decode_strings(raw[name]).reshape(-1)]

        file_gas_names = strings("gas_names")
        gas_minor = strings("gas_minor")
        identifier_minor = strings("identifier_minor")

        # --- gas union reduction (src/Gas_optics_rrtmgp.cpp:571-605) ---
        gas_names = tuple(g for g in file_gas_names if g in available)
        if not gas_names:
            raise ValueError("no requested gas is known to this k-distribution")
        ngas = len(gas_names)

        # vmr_ref: file C-order (ntemp, n_ext, 2) -> (2, ngas+1, ntemp).
        vmr_file = np.asarray(raw["vmr_ref"], dtype=np.float64)
        ntemp = vmr_file.shape[0]
        v = np.transpose(vmr_file, (2, 1, 0))  # (2, n_ext, ntemp)
        vmr_ref = np.zeros((2, ngas + 1, ntemp))
        vmr_ref[:, 0, :] = v[:, 0, :]  # dry air
        for i, g in enumerate(gas_names):
            idx = file_gas_names.index(g)       # 0-based in file list
            vmr_ref[:, i + 1, :] = v[:, idx + 1, :]

        # --- key species -> flavors (src/Gas_optics_rrtmgp.cpp:198-363) ---
        # key_species file C-order: (nbnd, 2 atm, 2 pair); entries are 1-based
        # indices into the FILE gas list (0 = none).
        ks_file = np.asarray(raw["key_species"], dtype=np.int64)
        nbnd = ks_file.shape[0]
        key_species_red = np.zeros_like(ks_file)
        for ib in range(nbnd):
            for ia in range(2):
                for ip in range(2):
                    kss = ks_file[ib, ia, ip]
                    if kss == 0:
                        key_species_red[ib, ia, ip] = 0
                    else:
                        g = file_gas_names[kss - 1]
                        if g not in gas_names:
                            raise ValueError(
                                f"gas optics: required key gas {g!r} is missing")
                        key_species_red[ib, ia, ip] = gas_names.index(g) + 1

        # flavor = unique key-species pairs in first-appearance order, with
        # the (0,0) pair rewritten to (2,2) (create_flavor, `:247-313`).
        pairs = []
        for ib in range(nbnd):
            for ia in range(2):
                p = tuple(key_species_red[ib, ia, :])
                if p == (0, 0):
                    p = (2, 2)
                if p not in pairs:
                    pairs.append(p)
        flavor = tuple((int(a), int(b)) for a, b in pairs)

        # band -> gpt map; file band2gpt C-order (nbnd, 2), 1-based inclusive.
        b2g = np.asarray(raw["bnd_limits_gpt"], dtype=np.int64)
        band_lims_gpt = tuple((int(b2g[ib, 0] - 1), int(b2g[ib, 1]))
                              for ib in range(nbnd))
        ngpt = int(b2g[:, 1].max())
        gpt2band_np = np.zeros(ngpt, dtype=np.int64)
        for ib, (g0, g1) in enumerate(band_lims_gpt):
            gpt2band_np[g0:g1] = ib
        gpt2band = tuple(int(x) for x in gpt2band_np)

        # gpoint_flavor (create_gpoint_flavor, `:331-363`): row 0 =
        # troposphere (atm index 1 in 1-based Fortran), row 1 = upper.
        gpf = np.zeros((2, ngpt), dtype=np.int64)
        for igpt in range(ngpt):
            ib = gpt2band_np[igpt]
            for ia in range(2):
                p = tuple(key_species_red[ib, ia, :])
                if p == (0, 0):
                    p = (2, 2)
                gpf[ia, igpt] = pairs.index(p)  # 0-based flavor
        gpoint_flavor = (tuple(int(x) for x in gpf[0]),
                         tuple(int(x) for x in gpf[1]))

        # --- minor absorber reduction (reduce_minor_arrays, `:54-162`) ---
        def reduce_minor(suffix: str):
            mg = strings(f"minor_gases_{suffix}")
            lims = np.asarray(raw[f"minor_limits_gpt_{suffix}"], dtype=np.int64)
            swd = np.asarray(raw[f"minor_scales_with_density_{suffix}"]
                             ).astype(bool).reshape(-1)
            sbc = np.asarray(raw[f"scale_by_complement_{suffix}"]
                             ).astype(bool).reshape(-1)
            scaling_gas = strings(f"scaling_gas_{suffix}")
            kstart = np.asarray(raw[f"kminor_start_{suffix}"],
                                dtype=np.int64).reshape(-1)  # 1-based
            kminor_file = np.asarray(raw[f"kminor_{suffix}"],
                                     dtype=np.float64)  # (ntemp, neta, ncont)

            specs = []
            kept_rows = []
            new_start = 0
            for i, ident in enumerate(mg):
                idx_mnr = identifier_minor.index(ident)
                gas = gas_minor[idx_mnr].strip()
                if gas not in available:
                    continue
                ng = int(lims[i, 1] - lims[i, 0] + 1)
                kept_rows.append(np.arange(kstart[i] - 1, kstart[i] - 1 + ng))
                sgas = scaling_gas[i].strip()
                idx_scaling = ((gas_names.index(sgas) + 1)
                               if sgas in gas_names else 0)
                g0 = int(lims[i, 0] - 1)
                specs.append(MinorSpec(
                    gpt_start=g0,
                    gpt_end=int(lims[i, 1]),
                    idx_minor=gas_names.index(gas) + 1,
                    idx_scaling=idx_scaling,
                    scales_with_density=bool(swd[i]),
                    scale_by_complement=bool(sbc[i]),
                    kminor_start=new_start,
                    flavor=int(gpf[0 if suffix == "lower" else 1, g0]),
                ))
                new_start += ng
            if kept_rows:
                kminor_red = kminor_file[:, :, np.concatenate(kept_rows)]
            else:
                kminor_red = np.zeros((ntemp, kminor_file.shape[1], 0))
            # -> (ncontrib, neta, ntemp)
            return tuple(specs), np.transpose(kminor_red, (2, 1, 0))

        minor_lower, kminor_lower = reduce_minor("lower")
        minor_upper, kminor_upper = reduce_minor("upper")

        # --- major/rayleigh/planck table layout normalization ---
        kmajor_file = np.asarray(raw["kmajor"], dtype=np.float64)
        kmajor = np.transpose(kmajor_file, (3, 1, 2, 0))  # (ngpt, np+1, neta, nT)

        krayl = None
        if "rayl_lower" in raw:
            rl = np.asarray(raw["rayl_lower"], dtype=np.float64)   # (nT, neta, ngpt)
            ru = np.asarray(raw["rayl_upper"], dtype=np.float64)
            krayl = np.stack([np.transpose(rl, (2, 1, 0)),
                              np.transpose(ru, (2, 1, 0))])  # (2, ngpt, neta, nT)

        planck_frac = totplnk = None
        solar = solar_q = solar_f = solar_s = None
        totplnk_delta = None
        press_ref = np.asarray(raw["press_ref"], dtype=np.float64).reshape(-1)
        temp_ref = np.asarray(raw["temp_ref"], dtype=np.float64).reshape(-1)
        temp_ref_min = float(temp_ref[0])
        temp_ref_max = float(temp_ref[-1])

        if "totplnk" in raw:
            tp = np.asarray(raw["totplnk"], dtype=np.float64)      # (nbnd, nT)
            totplnk = np.transpose(tp)                              # (nT, nbnd)
            pf = np.asarray(raw["plank_fraction"], dtype=np.float64)
            planck_frac = np.transpose(pf, (3, 1, 2, 0))
            totplnk_delta = ((temp_ref_max - temp_ref_min)
                             / (totplnk.shape[0] - 1))
        else:
            solar_q = np.asarray(raw["solar_source_quiet"],
                                 dtype=np.float64).reshape(-1)
            solar_f = np.asarray(raw["solar_source_facular"],
                                 dtype=np.float64).reshape(-1)
            solar_s = np.asarray(raw["solar_source_sunspot"],
                                 dtype=np.float64).reshape(-1)
            mg = float(np.asarray(raw["mg_default"]).reshape(-1)[0])
            sb = float(np.asarray(raw["sb_default"]).reshape(-1)[0])
            solar = (solar_q + (mg - config.SOLAR_A_OFFSET) * solar_f
                     + (sb - config.SOLAR_B_OFFSET) * solar_s)

        press_ref_log = np.log(press_ref)
        press_ref_trop_log = float(
            np.log(np.asarray(raw["press_ref_trop"]).reshape(-1)[0]))
        npress = press_ref.shape[0]
        # press_ref is stored max -> min; delta is negative.
        press_ref_log_delta = float(
            (np.log(press_ref[-1]) - np.log(press_ref[0])) / (npress - 1))
        temp_ref_delta = float((temp_ref_max - temp_ref_min) / (ntemp - 1))

        if "h2o" not in gas_names:
            raise ValueError("h2o must be among the available gases")

        blw = np.asarray(raw["bnd_limits_wavenumber"], dtype=np.float64)
        band_lims_wvn = tuple((float(blw[ib, 0]), float(blw[ib, 1]))
                              for ib in range(nbnd))

        # --- g-contiguous interpolation tables ---
        # kmajor (ngpt, npress+1, neta, ntemp) -> rows (p*T + t, e, g)
        npress1 = kmajor.shape[1]
        kmajor_rows = np.transpose(kmajor, (1, 3, 2, 0)).reshape(
            npress1 * ntemp, kmajor.shape[2], ngpt)
        planck_rows = None
        if planck_frac is not None:
            planck_rows = np.transpose(planck_frac, (1, 3, 2, 0)).reshape(
                npress1 * ntemp, planck_frac.shape[2], ngpt)
        krayl_rows = None
        if krayl is not None:
            # (2, ngpt, neta, ntemp) -> rows (itropo*T + t, e, g)
            krayl_rows = np.transpose(krayl, (0, 3, 2, 1)).reshape(
                2 * ntemp, krayl.shape[2], ngpt)
        # (ncont, neta, ntemp) -> (ntemp, neta, ncont)
        kminor_lower_trows = np.transpose(kminor_lower, (2, 1, 0))
        kminor_upper_trows = np.transpose(kminor_upper, (2, 1, 0))

        # binary-species eta ratio vmr_ref[g1]/vmr_ref[g2] per (atmosphere,
        # temp, flavor); 0/0 kept exactly as the reference's runtime
        # division would produce it.
        with np.errstate(divide="ignore", invalid="ignore"):
            g1 = np.array([f[0] for f in flavor])
            g2 = np.array([f[1] for f in flavor])
            ratio_rows = (vmr_ref[:, g1, :] / vmr_ref[:, g2, :]).transpose(
                0, 2, 1).reshape(2 * ntemp, len(flavor))

        t = lambda a: to_tensor(a, device, dtype)
        return KDist(
            kmajor=t(kmajor),
            kminor_lower=t(kminor_lower),
            kminor_upper=t(kminor_upper),
            krayl=t(krayl),
            planck_frac=t(planck_frac),
            totplnk=t(totplnk),
            solar_source=t(solar),
            solar_source_quiet=t(solar_q),
            solar_source_facular=t(solar_f),
            solar_source_sunspot=t(solar_s),
            press_ref_log=t(press_ref_log),
            temp_ref=t(temp_ref),
            vmr_ref=t(vmr_ref),
            kmajor_rows=t(kmajor_rows),
            planck_rows=t(planck_rows),
            krayl_rows=t(krayl_rows),
            kminor_lower_trows=t(kminor_lower_trows),
            kminor_upper_trows=t(kminor_upper_trows),
            ratio_rows=t(ratio_rows),
            gas_names=gas_names,
            idx_h2o=gas_names.index("h2o") + 1,
            flavor=flavor,
            gpoint_flavor=gpoint_flavor,
            gpt2band=gpt2band,
            band_lims_gpt=band_lims_gpt,
            minor_lower=minor_lower,
            minor_upper=minor_upper,
            press_ref_trop_log=press_ref_trop_log,
            press_ref_log_delta=press_ref_log_delta,
            temp_ref_min=temp_ref_min,
            temp_ref_max=temp_ref_max,
            temp_ref_delta=temp_ref_delta,
            press_ref_min=float(press_ref[-1]),
            press_ref_max=float(press_ref[0]),
            totplnk_delta=totplnk_delta,
            band_lims_wvn=band_lims_wvn,
        )
