"""Structurally faithful synthetic coefficient tables.

The reference repo snapshot ships *no* k-distribution data (the
``rrtmgp-data`` submodule is empty; only ``data/aerosol_optics.nc`` exists).
This module generates synthetic coefficient sets with

* the exact variable names / dimension layout of the real coefficient
  NetCDF files (``KDist.from_raw`` takes the same raw dict a file reader
  returns),
* the real RRTMGP spectral discretization (16 LW / 14 SW bands, 16 g-points
  per band, the published band wavenumber limits),
* *physically consistent* Planck tables: ``totplnk`` is the band-integrated
  Planck radiance, so summed fluxes obey sigma*T**4 — this is what makes the
  energy-conservation system tests meaningful,
* absorption coefficients that are smooth in (T, p, eta) and span a
  realistic dynamic range (1e-26..1e-21 cm^2/molec, k-distribution-ordered
  within each band).

Real coefficient files drop in without code changes.
"""

from __future__ import annotations

import numpy as np

# Planck constants (SI).
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23

# Published RRTMGP band limits (cm-1).
LW_BAND_LIMITS = [
    (10.0, 250.0), (250.0, 500.0), (500.0, 630.0), (630.0, 700.0),
    (700.0, 820.0), (820.0, 980.0), (980.0, 1080.0), (1080.0, 1180.0),
    (1180.0, 1390.0), (1390.0, 1480.0), (1480.0, 1800.0), (1800.0, 2080.0),
    (2080.0, 2250.0), (2250.0, 2380.0), (2380.0, 2600.0), (2600.0, 3250.0),
]
SW_BAND_LIMITS = [
    (820.0, 2680.0), (2680.0, 3250.0), (3250.0, 4000.0), (4000.0, 4650.0),
    (4650.0, 5150.0), (5150.0, 6150.0), (6150.0, 7700.0), (7700.0, 8050.0),
    (8050.0, 12850.0), (12850.0, 16000.0), (16000.0, 22650.0),
    (22650.0, 29000.0), (29000.0, 38000.0), (38000.0, 50000.0),
]

GAS_NAMES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
TYPICAL_VMR = {
    "h2o": 1.0e-2, "co2": 3.48e-4, "o3": 3.0e-6, "n2o": 3.06e-7,
    "co": 1.0e-7, "ch4": 1.65e-6, "o2": 0.2095, "n2": 0.7808,
}


def planck_band_radiance(temps, band_limits_cm1, n_quad=64):
    """Band-integrated Planck radiance B(T) [W m-2 sr-1] per band.

    integral over the band of 2 h c^2 nu^3 / (exp(h c nu / k T) - 1) dnu,
    nu in m^-1.  pi * sum_bands ~= sigma T^4.
    """
    temps = np.asarray(temps, dtype=np.float64)
    out = np.zeros((temps.size, len(band_limits_cm1)))
    for ib, (lo, hi) in enumerate(band_limits_cm1):
        nu = np.linspace(lo * 100.0, hi * 100.0, n_quad)  # m^-1
        dnu = nu[1] - nu[0]
        x = _H * _C * nu[None, :] / (_KB * temps[:, None])
        b = 2.0 * _H * _C ** 2 * nu[None, :] ** 3 / np.expm1(np.clip(x, 1e-9, 700.0))
        out[:, ib] = np.trapezoid(b, dx=dnu, axis=1)
    return out


def _strings_to_char(strings, string_len=32):
    arr = np.zeros((len(strings), string_len), dtype="S1")
    for i, s in enumerate(strings):
        b = s.encode("ascii")[:string_len]
        arr[i, : len(b)] = np.frombuffer(b, dtype="S1")
    return arr


def make_kdist_raw(longwave: bool, seed: int = 0,
                   ntemp: int = 14, npress: int = 59, neta: int = 9,
                   gpt_per_band: int = 16) -> dict:
    """Build the raw variable dict of a coefficient file (file layouts,
    C-order, matching what h5py reads from the real NetCDF files)."""
    rng = np.random.default_rng(seed + (0 if longwave else 1))
    band_limits = LW_BAND_LIMITS if longwave else SW_BAND_LIMITS
    nbnd = len(band_limits)
    ngpt = nbnd * gpt_per_band

    temp_ref = np.linspace(160.0, 355.0, ntemp)
    press_ref = np.exp(np.linspace(np.log(109663.0), np.log(1.005), npress))
    press_ref_trop = 9948.43

    gas_names = list(GAS_NAMES)
    ngas = len(gas_names)

    # --- key species per band (1-based indices into gas_names; 0 = none) ---
    # Mimic the real structure: h2o-dominated low bands, pairs in the middle,
    # single-gas and no-key bands sprinkled in.  Lower vs upper differ.
    key_species = np.zeros((nbnd, 2, 2), dtype=np.int32)
    pair_choices_lower = [(1, 2), (1, 3), (1, 6), (1, 1), (2, 2), (1, 4), (2, 6)]
    pair_choices_upper = [(1, 2), (3, 3), (2, 2), (1, 1), (2, 6), (3, 2), (0, 0)]
    for ib in range(nbnd):
        key_species[ib, 0, :] = pair_choices_lower[ib % len(pair_choices_lower)]
        key_species[ib, 1, :] = pair_choices_upper[ib % len(pair_choices_upper)]

    bnd_limits_gpt = np.zeros((nbnd, 2), dtype=np.int32)
    for ib in range(nbnd):
        bnd_limits_gpt[ib] = (ib * gpt_per_band + 1, (ib + 1) * gpt_per_band)

    # --- vmr_ref (ntemp, ngas+1, 2) file C-order (ntemp, n_ext, nlayers=2) ---
    n_ext = ngas + 1
    vmr_ref = np.zeros((ntemp, n_ext, 2))
    vmr_ref[:, 0, :] = 1.0  # dry air
    for i, g in enumerate(gas_names):
        base = TYPICAL_VMR[g]
        tfac = 1.0 + 0.1 * (temp_ref - 255.0) / 100.0
        vmr_ref[:, i + 1, 0] = base * tfac           # lower atmosphere
        upper_fac = 0.1 if g == "h2o" else (3.0 if g == "o3" else 1.0)
        vmr_ref[:, i + 1, 1] = base * upper_fac * tfac

    # --- kmajor (ntemp, npress+1, neta, ngpt) ---
    # k-distribution ordering: within each band, k0 spans ~4 decades.
    k0 = np.zeros(ngpt)
    for ib in range(nbnd):
        lo = 10.0 ** rng.uniform(-26.5, -24.0)
        hi = lo * 10.0 ** rng.uniform(2.5, 4.5)
        k0[ib * gpt_per_band:(ib + 1) * gpt_per_band] = np.exp(
            np.linspace(np.log(lo), np.log(hi), gpt_per_band))
    t_norm = (temp_ref - 255.0) / 100.0
    p_ind = np.arange(npress + 1)
    logp_norm = (p_ind / npress) * 2.0 - 1.0  # -1 (high p) .. 1 (low p)
    eta_norm = np.linspace(0.0, 1.0, neta)
    a_t = rng.uniform(-0.8, 0.8, size=ngpt)
    a_p = rng.uniform(-1.2, 0.2, size=ngpt)
    a_e = rng.uniform(-0.7, 0.7, size=ngpt)
    kmajor = (k0[None, None, None, :]
              * np.exp(a_t[None, None, None, :] * t_norm[:, None, None, None])
              * np.exp(a_p[None, None, None, :] * logp_norm[None, :, None, None])
              * (1.0 + 0.5 * np.sin(np.pi * eta_norm)[None, None, :, None]
                 * a_e[None, None, None, :]))

    # --- minor gases ---
    # identifier_minor maps identifiers (e.g. h2o_self) to gas names.
    gas_minor_list = ["h2o", "h2o", "co", "n2o", "o3", "n2"]
    identifier_minor_list = ["h2o_self", "h2o_frgn", "co", "n2o", "o3", "n2"]

    def build_minor(bands, idents, scales, complements, scaling_gases):
        nmin = len(bands)
        lims = np.zeros((nmin, 2), dtype=np.int32)
        kstart = np.zeros(nmin, dtype=np.int32)
        pos = 1
        for i, ib in enumerate(bands):
            lims[i] = bnd_limits_gpt[ib]
            kstart[i] = pos
            pos += gpt_per_band
        ncont = pos - 1
        kminor = np.zeros((ntemp, neta, ncont))
        for i in range(nmin):
            g0 = kstart[i] - 1
            kk = 10.0 ** rng.uniform(-26.0, -23.5)
            prof = kk * np.exp(np.linspace(0.0, 2.0, gpt_per_band))
            at = rng.uniform(-0.6, 0.6)
            ae = rng.uniform(-0.5, 0.5)
            kminor[:, :, g0:g0 + gpt_per_band] = (
                prof[None, None, :]
                * np.exp(at * t_norm[:, None, None])
                * (1.0 + ae * np.sin(np.pi * eta_norm)[None, :, None]))
        return dict(
            gases=idents, lims=lims, kstart=kstart, kminor=kminor,
            swd=np.array(scales, dtype=np.int8),
            sbc=np.array(complements, dtype=np.int8),
            sgas=scaling_gases,
        )

    lower = build_minor(
        bands=[0, 1, 2, 4, 6],
        idents=["h2o_self", "h2o_frgn", "co", "n2o", "o3"],
        scales=[1, 1, 1, 1, 0],
        complements=[0, 1, 0, 0, 0],
        scaling_gases=["h2o", "h2o", "", "", ""],
    )
    upper = build_minor(
        bands=[1, 3, 5],
        idents=["h2o_frgn", "o3", "n2"],
        scales=[1, 0, 1],
        complements=[1, 0, 0],
        scaling_gases=["h2o", "", ""],
    )

    raw = {
        "gas_names": _strings_to_char(gas_names),
        "gas_minor": _strings_to_char(gas_minor_list),
        "identifier_minor": _strings_to_char(identifier_minor_list),
        "key_species": key_species,
        "bnd_limits_wavenumber": np.array(band_limits, dtype=np.float64),
        "bnd_limits_gpt": bnd_limits_gpt,
        "press_ref": press_ref,
        "temp_ref": temp_ref,
        "press_ref_trop": np.float64(press_ref_trop),
        "absorption_coefficient_ref_P": np.float64(1.0),
        "absorption_coefficient_ref_T": np.float64(233.0),
        "vmr_ref": vmr_ref,
        "kmajor": kmajor,
        "kminor_lower": lower["kminor"],
        "kminor_upper": upper["kminor"],
        "minor_gases_lower": _strings_to_char(lower["gases"]),
        "minor_gases_upper": _strings_to_char(upper["gases"]),
        "minor_limits_gpt_lower": lower["lims"],
        "minor_limits_gpt_upper": upper["lims"],
        "minor_scales_with_density_lower": lower["swd"],
        "minor_scales_with_density_upper": upper["swd"],
        "scale_by_complement_lower": lower["sbc"],
        "scale_by_complement_upper": upper["sbc"],
        "scaling_gas_lower": _strings_to_char(lower["sgas"]),
        "scaling_gas_upper": _strings_to_char(upper["sgas"]),
        "kminor_start_lower": lower["kstart"],
        "kminor_start_upper": upper["kstart"],
    }

    if longwave:
        n_planck_t = 196
        planck_temps = np.linspace(temp_ref[0], temp_ref[-1], n_planck_t)
        totplnk = planck_band_radiance(planck_temps, band_limits)  # (nT, nbnd)
        raw["totplnk"] = totplnk.T.copy()  # file layout (nbnd, nT)

        # plank_fraction (file spelling): per band, g-point weights summing
        # to 1, smoothly varying with (T, p, eta).
        base = rng.uniform(0.5, 2.0, size=(1, 1, 1, ngpt))
        mod = (1.0 + 0.3 * np.sin(np.pi * eta_norm)[None, None, :, None]
               * rng.uniform(-1, 1, size=ngpt)[None, None, None, :]
               + 0.2 * t_norm[:, None, None, None]
               * rng.uniform(-1, 1, size=ngpt)[None, None, None, :]
               + 0.1 * logp_norm[None, :, None, None]
               * rng.uniform(-1, 1, size=ngpt)[None, None, None, :])
        pf = base * np.clip(mod, 0.05, None)
        for ib in range(nbnd):
            sl = slice(ib * gpt_per_band, (ib + 1) * gpt_per_band)
            pf[:, :, :, sl] /= pf[:, :, :, sl].sum(axis=3, keepdims=True)
        raw["plank_fraction"] = pf
    else:
        # Rayleigh tables (SW only in our synthetic set, like the real files).
        wvn_mid = np.array([0.5 * (a + b) for a, b in band_limits])
        krayl0 = 1.0e-27 * (wvn_mid / 10000.0) ** 4  # nu^4 scattering
        krayl_gpt = np.repeat(krayl0, gpt_per_band)
        shape_mod = (1.0 + 0.1 * t_norm[:, None, None]
                     + 0.05 * np.sin(np.pi * eta_norm)[None, :, None])
        raw["rayl_lower"] = krayl_gpt[None, None, :] * shape_mod
        raw["rayl_upper"] = krayl_gpt[None, None, :] * shape_mod * 1.02

        # Solar source: distribute a 1361 W/m2 TSI over bands like a 5777 K
        # blackbody, uniform-ish over g-points within a band.
        bb = planck_band_radiance(np.array([5777.0]), band_limits)[0]
        frac_band = bb / bb.sum()
        tsi = 1361.0
        per_gpt = np.repeat(frac_band * tsi / gpt_per_band, gpt_per_band)
        jitter = rng.uniform(0.85, 1.15, size=ngpt)
        for ib in range(nbnd):  # keep band sums exact
            sl = slice(ib * gpt_per_band, (ib + 1) * gpt_per_band)
            jitter[sl] *= (per_gpt[sl].sum() / (per_gpt[sl] * jitter[sl]).sum())
        solar_quiet = per_gpt * jitter
        raw["solar_source_quiet"] = solar_quiet
        raw["solar_source_facular"] = 0.01 * solar_quiet * rng.uniform(0.5, 1.5, ngpt)
        raw["solar_source_sunspot"] = 0.01 * solar_quiet * rng.uniform(0.5, 1.5, ngpt)
        # Defaults equal to the composition offsets -> solar == quiet.
        raw["tsi_default"] = np.float64(tsi)
        raw["mg_default"] = np.float64(0.1495954)
        raw["sb_default"] = np.float64(0.00066696)

    return raw


def write_kdist_nc(path: str, raw: dict) -> None:
    """Write a raw coefficient dict as a classic NetCDF file with the dimension
    names the reference driver reads (src_test/Radiation_solver.cpp:78-95)."""
    from ..utils.ncio import NcWriter

    ntemp, npress1, neta, ngpt = raw["kmajor"].shape
    nbnd = raw["bnd_limits_gpt"].shape[0]

    dims = {
        "temperature": ntemp, "pressure": npress1 - 1, "pressure_interp": npress1,
        "mixing_fraction": neta, "gpt": ngpt, "bnd": nbnd, "pair": 2,
        "atmos_layer": 2, "absorber": raw["gas_names"].shape[0],
        "absorber_ext": raw["vmr_ref"].shape[1],
        "minor_absorber": raw["gas_minor"].shape[0],
        "minor_absorber_intervals_lower": raw["minor_limits_gpt_lower"].shape[0],
        "minor_absorber_intervals_upper": raw["minor_limits_gpt_upper"].shape[0],
        "contributors_lower": raw["kminor_lower"].shape[2],
        "contributors_upper": raw["kminor_upper"].shape[2],
        "string_len": 32,
    }
    var_dims = {
        "gas_names": ("absorber", "string_len"),
        "gas_minor": ("minor_absorber", "string_len"),
        "identifier_minor": ("minor_absorber", "string_len"),
        "key_species": ("bnd", "atmos_layer", "pair"),
        "bnd_limits_wavenumber": ("bnd", "pair"),
        "bnd_limits_gpt": ("bnd", "pair"),
        "press_ref": ("pressure",),
        "temp_ref": ("temperature",),
        "vmr_ref": ("temperature", "absorber_ext", "atmos_layer"),
        "kmajor": ("temperature", "pressure_interp", "mixing_fraction", "gpt"),
        "kminor_lower": ("temperature", "mixing_fraction", "contributors_lower"),
        "kminor_upper": ("temperature", "mixing_fraction", "contributors_upper"),
        "minor_gases_lower": ("minor_absorber_intervals_lower", "string_len"),
        "minor_gases_upper": ("minor_absorber_intervals_upper", "string_len"),
        "minor_limits_gpt_lower": ("minor_absorber_intervals_lower", "pair"),
        "minor_limits_gpt_upper": ("minor_absorber_intervals_upper", "pair"),
        "minor_scales_with_density_lower": ("minor_absorber_intervals_lower",),
        "minor_scales_with_density_upper": ("minor_absorber_intervals_upper",),
        "scale_by_complement_lower": ("minor_absorber_intervals_lower",),
        "scale_by_complement_upper": ("minor_absorber_intervals_upper",),
        "scaling_gas_lower": ("minor_absorber_intervals_lower", "string_len"),
        "scaling_gas_upper": ("minor_absorber_intervals_upper", "string_len"),
        "kminor_start_lower": ("minor_absorber_intervals_lower",),
        "kminor_start_upper": ("minor_absorber_intervals_upper",),
        "totplnk": ("bnd", "temperature_Planck"),
        "plank_fraction": ("temperature", "pressure_interp", "mixing_fraction", "gpt"),
        "rayl_lower": ("temperature", "mixing_fraction", "gpt"),
        "rayl_upper": ("temperature", "mixing_fraction", "gpt"),
        "solar_source_quiet": ("gpt",),
        "solar_source_facular": ("gpt",),
        "solar_source_sunspot": ("gpt",),
    }
    with NcWriter(path) as nc:
        for name, size in dims.items():
            nc.def_dim(name, size)
        if "totplnk" in raw:
            nc.def_dim("temperature_Planck", raw["totplnk"].shape[1])
        for name, val in raw.items():
            val = np.asarray(val)
            if val.ndim == 0:
                nc.write_scalar(name, val)
            else:
                nc.write(name, val, var_dims[name])


def make_cloud_raw(longwave: bool, seed: int = 0) -> dict:
    """Synthetic cloud-optics LUTs (real file layout:
    src_test/Radiation_solver.cpp:286-329)."""
    rng = np.random.default_rng(seed + 100)
    band_limits = LW_BAND_LIMITS if longwave else SW_BAND_LIMITS
    nbnd = len(band_limits)
    nsize_liq, nsize_ice, nrgh = 25, 35, 3
    radliq_lwr, radliq_upr = 2.5, 21.5
    diamice_lwr, diamice_upr = 10.0, 180.0

    rel = np.linspace(radliq_lwr, radliq_upr, nsize_liq)      # microns
    dei = np.linspace(diamice_lwr, diamice_upr, nsize_ice)

    # Geometric-optics-like extinction (m^2 g-1): 3/(2 rho r_eff).
    extliq0 = 3.0 / (2.0 * 1.0e6 * rel * 1e-6)               # (nsize,)
    extice0 = 3.0 / (2.0 * 0.917e6 * dei * 1e-6 / 2.0)
    bmod = rng.uniform(0.8, 1.2, size=nbnd)

    lut_extliq = extliq0[None, :] * bmod[:, None]            # (nbnd, nsize)
    lut_extice = extice0[None, :] * bmod[:, None]
    if longwave:
        lut_ssaliq = np.clip(0.5 + 0.01 * rel, 0, 0.99)[None, :] * rng.uniform(0.9, 1.0, (nbnd, 1))
        lut_ssaice = np.clip(0.45 + 0.001 * dei, 0, 0.99)[None, :] * rng.uniform(0.9, 1.0, (nbnd, 1))
        lut_asyliq = np.full((nbnd, nsize_liq), 0.9) * rng.uniform(0.95, 1.0, (nbnd, 1))
        lut_asyice = np.full((nbnd, nsize_ice), 0.92) * rng.uniform(0.95, 1.0, (nbnd, 1))
    else:
        lut_ssaliq = (1.0 - 1e-3 * (1 + 0.02 * rel))[None, :] * rng.uniform(0.999, 1.0, (nbnd, 1))
        lut_ssaice = (1.0 - 5e-3 * (1 + 0.002 * dei))[None, :] * rng.uniform(0.999, 1.0, (nbnd, 1))
        lut_asyliq = np.full((nbnd, nsize_liq), 0.86) * rng.uniform(0.97, 1.0, (nbnd, 1))
        lut_asyice = np.full((nbnd, nsize_ice), 0.80) * rng.uniform(0.97, 1.0, (nbnd, 1))

    def add_rough(a):  # (nrgh, nbnd, nsize)
        return np.stack([a * f for f in (1.05, 1.0, 0.95)])

    return {
        "bnd_limits_wavenumber": np.array(band_limits),
        "radliq_lwr": np.float64(radliq_lwr), "radliq_upr": np.float64(radliq_upr),
        "radliq_fac": np.float64((radliq_upr - radliq_lwr) / (nsize_liq - 1)),
        "diamice_lwr": np.float64(diamice_lwr), "diamice_upr": np.float64(diamice_upr),
        "diamice_fac": np.float64((diamice_upr - diamice_lwr) / (nsize_ice - 1)),
        "lut_extliq": lut_extliq, "lut_ssaliq": np.clip(lut_ssaliq, 0, 1),
        "lut_asyliq": np.clip(lut_asyliq, 0, 1),
        "lut_extice": add_rough(lut_extice), "lut_ssaice": np.clip(add_rough(lut_ssaice), 0, 1),
        "lut_asyice": np.clip(add_rough(lut_asyice), 0, 1),
    }


def write_cloud_nc(path: str, raw: dict) -> None:
    from ..utils.ncio import NcWriter

    nbnd, nsl = raw["lut_extliq"].shape
    nrgh, _, nsi = raw["lut_extice"].shape
    with NcWriter(path) as nc:
        nc.def_dim("nband", nbnd)
        nc.def_dim("nrghice", nrgh)
        nc.def_dim("nsize_liq", nsl)
        nc.def_dim("nsize_ice", nsi)
        nc.def_dim("pair", 2)
        nc.write("bnd_limits_wavenumber", raw["bnd_limits_wavenumber"], ("nband", "pair"))
        for k in ("radliq_lwr", "radliq_upr", "radliq_fac",
                  "diamice_lwr", "diamice_upr", "diamice_fac"):
            nc.write_scalar(k, raw[k])
        for k in ("lut_extliq", "lut_ssaliq", "lut_asyliq"):
            nc.write(k, raw[k], ("nband", "nsize_liq"))
        for k in ("lut_extice", "lut_ssaice", "lut_asyice"):
            nc.write(k, raw[k], ("nrghice", "nband", "nsize_ice"))


def make_aerosol_raw(seed: int = 0, nbnd: int = 14, nhum: int = 12,
                     nphilic: int = 5, nphobic: int = 11) -> dict:
    """Synthetic CAMS aerosol tables (real file: data/aerosol_optics.nc,
    layout per src_test/Radiation_solver.cpp:331-366)."""
    rng = np.random.default_rng(seed + 200)
    rh = np.linspace(0.1, 1.0, nhum)
    growth = 1.0 + 2.0 * rh[None, :, None] ** 3

    mext_phobic = 10.0 ** rng.uniform(2.0, 3.5, size=(nphobic, nbnd))  # m2/kg
    ssa_phobic = rng.uniform(0.6, 0.99, size=(nphobic, nbnd))
    g_phobic = rng.uniform(0.5, 0.8, size=(nphobic, nbnd))

    mext_philic = 10.0 ** rng.uniform(2.0, 3.5, size=(nphilic, 1, nbnd)) * growth
    ssa_philic = np.clip(rng.uniform(0.85, 0.999, size=(nphilic, 1, nbnd))
                         * (1.0 + 0.02 * rh[None, :, None]), 0, 1)
    g_philic = np.clip(rng.uniform(0.55, 0.75, size=(nphilic, 1, nbnd))
                       * (1.0 + 0.05 * rh[None, :, None]), 0, 1)

    return {
        "relative_humidity2": rh,
        "mass_ext_sw_hydrophobic": mext_phobic,
        "ssa_sw_hydrophobic": ssa_phobic,
        "asymmetry_sw_hydrophobic": g_phobic,
        "mass_ext_sw_hydrophilic": mext_philic,
        "ssa_sw_hydrophilic": ssa_philic,
        "asymmetry_sw_hydrophilic": g_philic,
    }


def write_aerosol_nc(path: str, raw: dict) -> None:
    from ..utils.ncio import NcWriter

    nphobic, nbnd = raw["mass_ext_sw_hydrophobic"].shape
    nphilic, nhum, _ = raw["mass_ext_sw_hydrophilic"].shape
    with NcWriter(path) as nc:
        nc.def_dim("band_sw", nbnd)
        nc.def_dim("relative_humidity", nhum)
        nc.def_dim("hydrophilic", nphilic)
        nc.def_dim("hydrophobic", nphobic)
        nc.write("relative_humidity2", raw["relative_humidity2"], ("relative_humidity",))
        for k in ("mass_ext_sw_hydrophobic", "ssa_sw_hydrophobic",
                  "asymmetry_sw_hydrophobic"):
            nc.write(k, raw[k], ("hydrophobic", "band_sw"))
        for k in ("mass_ext_sw_hydrophilic", "ssa_sw_hydrophilic",
                  "asymmetry_sw_hydrophilic"):
            nc.write(k, raw[k], ("hydrophilic", "relative_humidity", "band_sw"))


def make_mie_raw(seed: int = 0, nbnd: int = 14, n_re: int = 20,
                 n_mie: int = 40, n_ang: int = 181) -> dict:
    """Synthetic Mie phase-function LUT in the reference's
    ``mie_lut_broadband.nc`` layout (Radiation_solver_rt.cu:652-666 for the
    cdf tables; Radiation_solver_bw.cu:740-764 adds the phase-value pair):
    ``phase_cdf`` (nbnd, n_mie) strictly descending 1 -> 0,
    ``phase_cdf_angle`` (nbnd, n_re, n_mie) scattering angles (radians)
    increasing from forward (0) to backward (pi) with a forward-peaked
    HG-like shape that sharpens with effective radius, plus — for the
    backward tracer's next-event estimation — ``phase`` (nbnd, n_re, n_ang)
    phase VALUES on the shared uniform angle grid ``phase_angle`` (n_ang,)
    spanning [0, pi].  The synthetic phase values are the same per-r_eff HG
    lobes that generated the cdf, so Mie sampling + Mie NEE are mutually
    consistent and analytically checkable."""
    rng = np.random.default_rng(seed)
    cdf = np.linspace(1.0, 0.0, n_mie)[None, :] ** np.linspace(
        1.0, 1.5, nbnd)[:, None]                      # descending per band
    g = np.linspace(0.70, 0.92, n_re)                 # sharper for larger r_eff
    # invert HG cdf on the descending grid per (band, r_eff)
    u = np.clip(cdf, 1e-6, 1.0)
    ang = np.empty((nbnd, n_re, n_mie))
    for ir, gg in enumerate(g):
        cos_t = (1.0 + gg * gg
                 - ((1.0 - gg * gg) / (1.0 - gg + 2.0 * gg * u)) ** 2) / (2.0 * gg)
        ang[:, ir, :] = np.arccos(np.clip(cos_t, -1.0, 1.0))
    # phase VALUES: HG(g(r_eff)) on the uniform angle grid, band-constant
    phase_angle = np.linspace(0.0, np.pi, n_ang)
    cos_a = np.cos(phase_angle)
    phase = np.empty((nbnd, n_re, n_ang))
    for ir, gg in enumerate(g):
        denom = np.maximum(1e-7, 1.0 + gg * gg - 2.0 * gg * cos_a)
        phase[:, ir, :] = (1.0 / (4.0 * np.pi) * (1.0 - gg * gg)
                           / (denom * np.sqrt(denom)))[None, :]
    return {"phase_cdf": cdf, "phase_cdf_angle": ang,
            "phase": phase, "phase_angle": phase_angle,
            "r_eff": 2.5 + np.arange(n_re, dtype=float),
            "g_of_re": g}


def write_mie_nc(path: str, raw: dict) -> None:
    from ..utils.ncio import NcWriter

    nbnd, n_re, n_mie = raw["phase_cdf_angle"].shape
    with NcWriter(path) as nc:
        nc.def_dim("band_sw", nbnd)
        nc.def_dim("r_eff", n_re)
        nc.def_dim("n_ang_cdf", n_mie)
        nc.write("r_eff2", raw["r_eff"], ("r_eff",))
        nc.write("phase_cdf", raw["phase_cdf"], ("band_sw", "n_ang_cdf"))
        nc.write("phase_cdf_angle", raw["phase_cdf_angle"],
                 ("band_sw", "r_eff", "n_ang_cdf"))
        if "phase" in raw:
            n_ang = raw["phase"].shape[-1]
            nc.def_dim("n_ang", n_ang)
            nc.write("phase", raw["phase"], ("band_sw", "r_eff", "n_ang"))
            nc.write("phase_angle", raw["phase_angle"], ("n_ang",))
