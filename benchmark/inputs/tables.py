"""The synthetic coefficient tables the benchmark runs on.

Grown from ``rte_rrtmgp_torch/data/synthetic.py`` (``make_kdist_raw``,
``make_cloud_raw``, ``planck_band_radiance``) as it stood when the
benchmark was defined, and kept here so that a later change to the
program cannot move the yardstick.  The raw dicts have the variable names
and C-order layouts of the RRTMGP coefficient files and the shapes of the
published g256 (LW) / g224 (SW) files: 16 LW / 14 SW bands at the
published limits, ``gpt_per_band`` g-points a band, 14 reference
temperatures, 59 reference pressures (60 in the pressure interpolation
axis), 9 eta values, the 19 published absorbers and the published counts
of minor-absorber intervals (38 + 36 LW, 34 + 26 SW), each over one band.
The values, which gas scales each minor interval and in which band, are
synthetic, drawn from ``seed`` or fixed below: the repository holds no
coefficient file.  The major tables, band maps and reference profiles are
those of the program's generator (``tests/test_bench_inputs.py``).
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

# The 19 absorbers of the published files, in their order.
GAS_NAMES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2", "ccl4",
             "cfc11", "cfc12", "cfc22", "hfc143a", "hfc125", "hfc23",
             "hfc32", "hfc134a", "cf4", "no2"]
TYPICAL_VMR = {
    "h2o": 1.0e-2, "co2": 3.48e-4, "o3": 3.0e-6, "n2o": 3.06e-7,
    "co": 1.0e-7, "ch4": 1.65e-6, "o2": 0.2095, "n2": 0.7808,
    "ccl4": 8.0e-11, "cfc11": 2.3e-10, "cfc12": 5.2e-10, "cfc22": 2.3e-10,
    "hfc143a": 1.9e-11, "hfc125": 1.8e-11, "hfc23": 2.8e-11,
    "hfc32": 1.0e-11, "hfc134a": 8.4e-11, "cf4": 8.0e-11, "no2": 2.0e-10,
}
# (lower, upper) minor-absorber intervals of the published files
# (dimensions minor_absorber_intervals_lower / _upper of
# rrtmgp-data-lw-g256-2018-12-04.nc and rrtmgp-data-sw-g224-2018-12-04.nc).
MINOR_INTERVALS = {"lw": (38, 36), "sw": (34, 26)}
# Minor-absorber identifiers and the gas each scales with: water vapour's
# self and foreign continua and every other absorber.
MINOR_IDS = ["h2o_self", "h2o_frgn"] + GAS_NAMES[1:]
MINOR_GAS = dict({"h2o_self": "h2o", "h2o_frgn": "h2o"},
                 **{g: g for g in GAS_NAMES[1:]})


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


def _build_minor(rng, nmin, atm, bnd_limits_gpt, gpt_per_band, t_norm,
                 eta_norm):
    """``nmin`` minor intervals of one atmosphere (0 lower, 1 upper), each
    over one band's g-points as in the published files: interval i scales
    with identifier ``MINOR_IDS[i % 20]`` in band ``(5 i + 3 atm) % nbnd``
    (no identifier twice in a band), so that several gases overlap in a
    band; the continua scale with density and water vapour (the foreign
    one by its complement), n2 and o2 with density alone."""
    nbnd = bnd_limits_gpt.shape[0]
    ntemp, neta = t_norm.size, eta_norm.size
    idents = [MINOR_IDS[i % len(MINOR_IDS)] for i in range(nmin)]
    bands = [(5 * i + 3 * atm) % nbnd for i in range(nmin)]
    lims = np.zeros((nmin, 2), dtype=np.int32)
    kstart = np.zeros(nmin, dtype=np.int32)
    kminor = np.zeros((ntemp, neta, nmin * gpt_per_band))
    for i, ib in enumerate(bands):
        lims[i] = bnd_limits_gpt[ib]
        kstart[i] = 1 + i * gpt_per_band
        kk = 10.0 ** rng.uniform(-26.0, -23.5)
        prof = kk * np.exp(np.linspace(0.0, 2.0, gpt_per_band))
        at = rng.uniform(-0.6, 0.6)
        ae = rng.uniform(-0.5, 0.5)
        kminor[:, :, i * gpt_per_band:(i + 1) * gpt_per_band] = (
            prof[None, None, :]
            * np.exp(at * t_norm[:, None, None])
            * (1.0 + ae * np.sin(np.pi * eta_norm)[None, :, None]))
    swd = [int(g in ("h2o_self", "h2o_frgn", "n2", "o2")) for g in idents]
    sbc = [int(g == "h2o_frgn") for g in idents]
    sgas = ["h2o" if g in ("h2o_self", "h2o_frgn") else "" for g in idents]
    return dict(gases=idents, lims=lims, kstart=kstart, kminor=kminor,
                swd=np.array(swd, dtype=np.int8),
                sbc=np.array(sbc, dtype=np.int8), sgas=sgas)


def make_kdist_raw(longwave: bool, seed: int = 0,
                   ntemp: int = 14, npress: int = 59, neta: int = 9,
                   gpt_per_band: int = 16, minor_intervals=None) -> dict:
    """Build the raw variable dict of a coefficient file (file layouts,
    C-order, matching what h5py reads from the real NetCDF files).
    ``minor_intervals``: (lower, upper) counts of minor-absorber
    intervals, by default the published file's (:data:`MINOR_INTERVALS`)."""
    if minor_intervals is None:
        minor_intervals = MINOR_INTERVALS["lw" if longwave else "sw"]
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

    # --- minor gases, at the published counts of intervals ---
    lower = _build_minor(rng, minor_intervals[0], 0, bnd_limits_gpt,
                         gpt_per_band, t_norm, eta_norm)
    upper = _build_minor(rng, minor_intervals[1], 1, bnd_limits_gpt,
                         gpt_per_band, t_norm, eta_norm)

    raw = {
        "gas_names": _strings_to_char(gas_names),
        "gas_minor": _strings_to_char([MINOR_GAS[i] for i in MINOR_IDS]),
        "identifier_minor": _strings_to_char(MINOR_IDS),
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
