"""Analytic atmospheric profiles for cases, tests and benchmarks.

Ports the radiative-convective-equilibrium sounding used by the reference's
allsky / RCEMIP cases (``allsky/allsky_init.py:16-70``,
``rcemip/test_rcemip_input.py:20-60``): hydrostatic pressure/temperature from
a fixed virtual-temperature lapse rate below a 15 km tropopause, isothermal
above, exponential water vapour, an analytic ozone profile, and idealized
clouds where 1e4 < p < 9e4 Pa (``allsky/allsky_init.py:170-176``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..models.gas_concs import GasConcs

Z_TOP = 70.0e3
Z_TROP = 15.0e3


def rce_p_q_T(z: np.ndarray, T_0: float = 300.0, q_0: float = 0.01864
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RCE sounding at heights z [m] -> (p [Pa], q [kg/kg], T [K])."""
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


def make_atmosphere(ncol: int, nlay: int = 72, seed: int = 0,
                    perturb: bool = True) -> dict:
    """Build a clear+cloudy multi-column atmosphere within the k-distribution
    table ranges.  Columns get per-column perturbations so the interpolation
    indices exercise the full tables.

    Returns a dict with p_lay/p_lev/t_lay/t_lev (ncol, nlay[+1]),
    t_sfc (ncol,), GasConcs, cloud fields, SW boundary conditions.
    """
    rng = np.random.default_rng(seed)
    z, zh = rce_grid(nlay)

    t0 = 300.0 + (rng.uniform(-12.0, 10.0, ncol) if perturb else np.zeros(ncol))
    q0 = 0.01864 * (rng.uniform(0.5, 1.3, ncol) if perturb else np.ones(ncol))

    p_lay = np.zeros((ncol, nlay))
    p_lev = np.zeros((ncol, nlay + 1))
    t_lay = np.zeros((ncol, nlay))
    t_lev = np.zeros((ncol, nlay + 1))
    q_lay = np.zeros((ncol, nlay))
    for i in range(ncol):
        p_lay[i], q_lay[i], t_lay[i] = rce_p_q_T(z, t0[i], q0[i])
        p_lev[i], _, t_lev[i] = rce_p_q_T(zh, t0[i], q0[i])
    # Keep within the coefficient-table valid ranges; enforce strictly
    # monotonic levels so no layer degenerates to zero thickness (the RCE
    # profile reaches ~1 Pa at 70 km, right at the table edge).
    p_lev = np.clip(p_lev, 1.10, 109000.0)
    p_lay = np.clip(p_lay, 1.12, 108000.0)
    for i in range(1, nlay + 1):
        p_lev[:, i] = np.minimum(p_lev[:, i], 0.998 * p_lev[:, i - 1])
    p_lay = np.minimum(np.maximum(p_lay, p_lev[:, 1:] * 1.0005),
                       p_lev[:, :-1] * 0.9995)
    t_lay = np.clip(t_lay, 161.0, 354.0)
    t_lev = np.clip(t_lev, 161.0, 354.0)

    gas = GasConcs()
    gas.set_vmr("h2o", np.maximum(q_lay, 1e-9))  # case convention: vmr ~= q
    gas.set_vmr("o3", ozone_profile(p_lay))
    gas.set_vmr("co2", 348.0e-6)
    gas.set_vmr("ch4", 1650.0e-9)
    gas.set_vmr("n2o", 306.0e-9)
    gas.set_vmr("co", 1.0e-7)
    gas.set_vmr("n2", 0.7808)
    gas.set_vmr("o2", 0.2095)

    t_sfc = t_lev[:, 0].copy()  # surface is the high-pressure end (index 0)

    # Idealized clouds (allsky_init.py:170-176): 2 of 3 columns cloudy.
    cloud_flag = (np.arange(1, ncol + 1) % 3 > 0)
    cmask = ((p_lay > 1.0e4) & (p_lay < 9.0e4) & cloud_flag[:, None])
    lwp = np.where(cmask & (t_lay > 263.0), 10.0, 0.0)
    iwp = np.where(cmask & (t_lay < 273.0), 10.0, 0.0)
    rel = np.where(lwp > 0.0, 12.0, 0.0)
    dei = np.where(iwp > 0.0, 95.0, 0.0)

    mu0 = rng.uniform(0.2, 1.0, ncol) if perturb else np.full(ncol, 0.86)

    # Relative humidity proxy + CAMS aerosol mixing ratios for aerosol tests.
    rh = np.clip(q_lay / np.maximum(q_lay.max(axis=1, keepdims=True), 1e-12), 0.05, 1.0)
    aermr = 1e-9 * rng.uniform(0.1, 2.0, (ncol, nlay, 11)) \
        * np.exp(-z / 3.0e3)[None, :, None]

    return dict(
        z_lay=z, z_lev=zh,
        p_lay=p_lay, p_lev=p_lev, t_lay=t_lay, t_lev=t_lev, t_sfc=t_sfc,
        gas_concs=gas, lwp=lwp, iwp=iwp, rel=rel, dei=dei,
        mu0=mu0, sfc_alb_dir=0.06, sfc_alb_dif=0.06, emis_sfc=0.98,
        rh=rh, aermr=aermr,
    )
