"""Frozen copy of the analytic atmosphere the benchmark runs on.

A copy of ``rte_rrtmgp_torch/cases/profiles.py`` (``rce_p_q_T``,
``rce_grid``, ``ozone_profile``, ``make_atmosphere``) and of the step's
input packing (``rte_rrtmgp_torch/step.atmos_arrays``, with the dry-air
column of ``ops/gas_optics.get_col_dry``) as they stood when the benchmark
was defined: the radiative-convective-equilibrium sounding of the
reference's allsky / RCEMIP cases, perturbed column by column from the
seed, with idealized clouds where 1e4 < p < 9e4 Pa.  Beyond the copy, the
trace gases of the published tables (halocarbons, no2) are set at
present-day values (:data:`TRACE_VMR`).  The volume mixing
ratios come back as a plain dict (gas name -> scalar or (ncol, nlay)
array) in place of the program's ``GasConcs``; the relative humidity and
aerosol fields, drawn last, are left out.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Z_TOP = 70.0e3
Z_TROP = 15.0e3
# The program's eight gases, then the trace gases the benchmark adds at
# present-day values so that every published minor interval has its gas.
GASES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2", "ccl4",
         "cfc11", "cfc12", "cfc22", "hfc143a", "hfc125", "hfc23", "hfc32",
         "hfc134a", "cf4", "no2")
TRACE_VMR = {"ccl4": 8.0e-11, "cfc11": 2.3e-10, "cfc12": 5.2e-10,
             "cfc22": 2.3e-10, "hfc143a": 1.9e-11, "hfc125": 1.8e-11,
             "hfc23": 2.8e-11, "hfc32": 1.0e-11, "hfc134a": 8.4e-11,
             "cf4": 8.0e-11, "no2": 2.0e-10}
NBND_LW, NBND_SW = 16, 14

# Physical constants of the dry-air column (src/Gas_optics_rrtmgp.cpp:764-792).
GRAV = 9.80665
AVOGADRO = 6.02214076e23
M_DRY = 0.028964
M_H2O = 0.018016


def rce_p_q_T(z: np.ndarray, T_0=300.0, q_0=0.01864
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RCE sounding at heights z [m] -> (p [Pa], q [kg/kg], T [K]); ``T_0``
    and ``q_0`` may be arrays that broadcast against ``z``."""
    z = np.asarray(z, dtype=np.float64)
    z_q1, z_q2, q_t = 4.0e3, 7.5e3, 1.0e-8
    q = q_0 * np.exp(-z / z_q1) * np.exp(-((z / z_q2) ** 2))
    above = z > Z_TROP
    q = np.where(above, q_t, q)

    Tv_0 = (1.0 + 0.608 * q_0) * T_0
    gamma = 6.7e-3
    T = T_0 - gamma * z / (1.0 + 0.608 * q)
    T = np.where(above, T_0 - gamma * Z_TROP / (1.0 + 0.608 * q_0), T)
    Tv = T * (1.0 + 0.608 * q)

    g, Rd, p0 = 9.79764, 287.04, 101480.0
    p = p0 * (Tv / Tv_0) ** (g / (Rd * gamma))
    p_above = (p0 * (Tv / Tv_0) ** (g / (Rd * gamma))
               * np.exp(-(g * (z - Z_TROP)) / (Rd * Tv)))
    p = np.where(above, p_above, p)
    return p, q, T


def rce_grid(nlay: int) -> Tuple[np.ndarray, np.ndarray]:
    """Piecewise-uniform height grid: half the layers below the tropopause
    (allsky_init.py:17-22).  Returns (z_lay, z_lev)."""
    zh = np.zeros(nlay + 1)
    for i in range(1, nlay // 2 + 1):
        zh[i] = 2.0 * i * Z_TROP / nlay
        zh[i + nlay // 2] = Z_TROP + 2.0 * i * (Z_TOP - Z_TROP) / nlay
    z = 0.5 * (zh[1:] + zh[:-1])
    return z, zh


def ozone_profile(p_lay: np.ndarray) -> np.ndarray:
    """Analytic o3 vmr (allsky_init.py:82-90)."""
    g1, g2, g3 = 3.6478, 0.83209, 11.3515
    p_hpa = p_lay / 100.0
    return np.maximum(1e-13, g1 * p_hpa ** g2 * np.exp(-p_hpa / g3) * 1e-6)


def make_atmosphere(ncol: int, nlay: int, seed: int) -> dict:
    """The perturbed multi-column RCE atmosphere, bottom-up (index 0 at the
    surface): p_lay/p_lev/t_lay/t_lev (ncol, nlay[+1]), t_sfc (ncol,),
    ``vmr`` {gas: scalar or (ncol, nlay)}, lwp/iwp (g m-2), rel/dei
    (micron), mu0 (ncol,), all float64."""
    rng = np.random.default_rng(seed)
    z, zh = rce_grid(nlay)

    t0 = 300.0 + rng.uniform(-12.0, 10.0, ncol)
    q0 = 0.01864 * rng.uniform(0.5, 1.3, ncol)

    # All columns at once (the original loops over columns; same values).
    p_lay, q_lay, t_lay = rce_p_q_T(z[None, :], t0[:, None], q0[:, None])
    p_lev, _, t_lev = rce_p_q_T(zh[None, :], t0[:, None], q0[:, None])
    # Within the coefficient tables' ranges, levels strictly monotonic.
    p_lev = np.clip(p_lev, 1.10, 109000.0)
    p_lay = np.clip(p_lay, 1.12, 108000.0)
    for i in range(1, nlay + 1):
        p_lev[:, i] = np.minimum(p_lev[:, i], 0.998 * p_lev[:, i - 1])
    p_lay = np.minimum(np.maximum(p_lay, p_lev[:, 1:] * 1.0005),
                       p_lev[:, :-1] * 0.9995)
    t_lay = np.clip(t_lay, 161.0, 354.0)
    t_lev = np.clip(t_lev, 161.0, 354.0)

    vmr = {"h2o": np.maximum(q_lay, 1e-9), "o3": ozone_profile(p_lay),
           "co2": 348.0e-6, "ch4": 1650.0e-9, "n2o": 306.0e-9, "co": 1.0e-7,
           "n2": 0.7808, "o2": 0.2095, **TRACE_VMR}

    t_sfc = t_lev[:, 0].copy()

    # Idealized clouds (allsky_init.py:170-176): 2 of 3 columns cloudy.
    cloud_flag = (np.arange(1, ncol + 1) % 3 > 0)
    cmask = ((p_lay > 1.0e4) & (p_lay < 9.0e4) & cloud_flag[:, None])
    lwp = np.where(cmask & (t_lay > 263.0), 10.0, 0.0)
    iwp = np.where(cmask & (t_lay < 273.0), 10.0, 0.0)
    rel = np.where(lwp > 0.0, 12.0, 0.0)
    dei = np.where(iwp > 0.0, 95.0, 0.0)

    mu0 = rng.uniform(0.2, 1.0, ncol)
    return dict(p_lay=p_lay, p_lev=p_lev, t_lay=t_lay, t_lev=t_lev,
                t_sfc=t_sfc, vmr=vmr, lwp=lwp, iwp=iwp, rel=rel, dei=dei,
                mu0=mu0)


def vmr_field(vmr: dict, ncol: int, nlay: int, gases=GASES) -> np.ndarray:
    """(ncol, nlay, len(gases)) float64 vmr of ``gases``, in that order."""
    return np.stack([np.broadcast_to(np.asarray(vmr[g], np.float64),
                                     (ncol, nlay)) for g in gases], axis=-1)


def col_dry(h2o: np.ndarray, p_lev: np.ndarray) -> np.ndarray:
    """Hydrostatic dry-air column [molec cm-2] (src/Gas_optics_rrtmgp.cpp
    :764-792), float64."""
    delta_plev = np.abs(p_lev[:, :-1] - p_lev[:, 1:])
    m_air = (M_DRY + M_H2O * h2o) / (1.0 + h2o)
    col = 10.0 * delta_plev * AVOGADRO / (1000.0 * m_air * 100.0 * GRAV)
    return col / (1.0 + h2o)


def step_arrays(atm: dict, dtype=np.float32, gases=GASES) -> dict:
    """The step's 16 input arrays (bottom-up) in the step's argument order,
    as ``rte_rrtmgp_torch.step.atmos_arrays`` packs them: surface
    emissivity 0.98, albedos 0.06, TSI scaling 1, ``col_dry`` from the
    float64 fields; ``vmr`` of ``gases`` (h2o first), in that order."""
    ncol, nlay = atm["p_lay"].shape
    vmr = vmr_field(atm["vmr"], ncol, nlay, gases)
    cast = lambda a: np.asarray(a, dtype)
    return dict(
        p_lay=cast(atm["p_lay"]), p_lev=cast(atm["p_lev"]),
        t_lay=cast(atm["t_lay"]), t_lev=cast(atm["t_lev"]),
        t_sfc=cast(atm["t_sfc"]), vmr=cast(vmr),
        col_dry=cast(col_dry(vmr[:, :, 0], atm["p_lev"])),
        emis_sfc=np.full((ncol, NBND_LW), 0.98, dtype),
        sfc_alb_dir=np.full((ncol, NBND_SW), 0.06, dtype),
        sfc_alb_dif=np.full((ncol, NBND_SW), 0.06, dtype),
        tsi_scaling=np.ones((ncol,), dtype),
        mu0=cast(atm["mu0"]),
        lwp=cast(atm["lwp"]), iwp=cast(atm["iwp"]),
        rel=cast(atm["rel"]), dei=cast(atm["dei"]),
    )
