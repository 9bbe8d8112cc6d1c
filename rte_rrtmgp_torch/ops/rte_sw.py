"""Shortwave two-stream + adding RTE solver in PyTorch.

Port of ``sw_source_2stream_kernel`` + ``sw_adding_kernel``
(``src_kernels_cuda/rte_solver_kernels.cu:196-286, 543-655``): Meador-Weaver
two-stream coefficients with the Ukkonen clamp (`:589-592`), the direct
beam as a cumulative product of t_noscat, the adding up-sweep (surface
albedo and source accumulation) and the diffuse down-sweep.

:func:`sw_solver_2stream` returns per-g-point fluxes as plain tensor code.
:func:`sw_solver_2stream_broadband` returns g-point-summed fluxes: on the
card it is one launch of the hand-written kernel ``csrc/sw_2stream.cu``.
:func:`sw_solver_2stream_broadband_lm` does the same on layer-major
(nlay*ncol, G) planes (cell (c, l) at row l*ncol + c).
:func:`sw_solver_2stream_fused_broadband` and its layer-major form take the
gas optics (tau_abs, tau_rayleigh) and the per-band increments in place
of the planes: on the card the same kernel forms tau, ssa and g itself,
and the twin is the plain chain :func:`sw_optics_plain`.

Canonical orientation: top of atmosphere at layer index 0.
"""

from __future__ import annotations

import torch

from .. import config
from .kernels import solvers as _kern


def two_stream_coeffs(tau, ssa, g, mu0):
    """Meador-Weaver two-stream reflectance/transmittance
    (sw_2stream_function, rte_solver_kernels.cu:543-592)."""
    dtype = tau.dtype
    tmin = config.eps(dtype)
    kmin = config.k_min(dtype)
    mu0b = mu0[:, None, None]

    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0b * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4

    k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2), min=kmin))
    exp_mkt = torch.exp(-tau * k)
    exp_m2kt = exp_mkt * exp_mkt
    rt_term = 1.0 / (k * (1.0 + exp_m2kt) + gamma1 * (1.0 - exp_m2kt))
    r_dif = rt_term * gamma2 * (1.0 - exp_m2kt)
    t_dif = rt_term * 2.0 * k * exp_mkt
    t_noscat = torch.exp(-tau / mu0b)

    k_mu = k * mu0b
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    one_m = 1.0 - k_mu * k_mu
    fact = torch.where(torch.abs(one_m) > tmin, one_m,
                       torch.full((), tmin, dtype=dtype, device=tau.device))
    rt2 = ssa * rt_term / fact
    r_dir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g3)
                   - (1.0 + k_mu) * (alpha2 - k_g3) * exp_m2kt
                   - 2.0 * (k_g3 - alpha2 * k_mu) * exp_mkt * t_noscat)
    t_dir = -rt2 * ((1.0 + k_mu) * (alpha1 + k_g4) * t_noscat
                    - (1.0 - k_mu) * (alpha1 - k_g4) * exp_m2kt * t_noscat
                    - 2.0 * (k_g4 + alpha1 * k_mu) * exp_mkt)
    # Ukkonen clamp (energy conservation in single precision).
    r_dir = torch.clamp(torch.minimum(r_dir, 1.0 - t_noscat), min=tmin)
    t_dir = torch.clamp(torch.minimum(t_dir, 1.0 - t_noscat - r_dir), min=tmin)
    return r_dif, t_dif, r_dir, t_dir, t_noscat


def sw_solver_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, inc_flux_dif=None):
    """Two-stream solve with adding.  (ncol, nlay, ngpt) optics, top at 0.

    mu0: (ncol,); sfc_alb_* and inc_flux_*: (ncol, ngpt).
    Returns flux_up, flux_dn (diffuse+direct), flux_dir: (ncol, nlay+1, ngpt).
    """
    nlay = tau.shape[1]
    r_dif, t_dif, r_dir, t_dir, t_noscat = two_stream_coeffs(tau, ssa, g, mu0)

    # Direct beam: flux_dir[0] = inc*mu0; flux_dir[l+1] = t_noscat[l]*flux_dir[l].
    top_dir = inc_flux_dir * mu0[:, None]
    cum = torch.cumprod(t_noscat, dim=1)
    flux_dir = torch.cat([top_dir[:, None], top_dir[:, None] * cum], dim=1)

    src_up = r_dir * flux_dir[:, :-1]
    src_dn = t_dir * flux_dir[:, :-1]
    src_sfc = flux_dir[:, -1] * sfc_alb_dir

    # Up-sweep: albedo/src accumulation from the surface
    # (sw_adding_kernel :216-227).
    alb_below, src_below = sfc_alb_dif, src_sfc
    albedo, src, denom = [alb_below], [src_below], [None] * nlay
    for l in range(nlay - 1, -1, -1):
        rd, td = r_dif[:, l], t_dif[:, l]
        dnm = 1.0 / (1.0 - rd * alb_below)
        alb = rd + td * td * alb_below * dnm
        src_l = src_up[:, l] + td * dnm * (src_below + alb_below * src_dn[:, l])
        alb_below, src_below = alb, src_l
        albedo.append(alb)
        src.append(src_l)
        denom[l] = dnm
    albedo = torch.stack(albedo[::-1], dim=1)
    src = torch.stack(src[::-1], dim=1)

    # Down-sweep (sw_adding_kernel :231-243).
    dn = (inc_flux_dif if inc_flux_dif is not None
          else torch.zeros_like(top_dir))
    flux_dn = [dn]
    for l in range(nlay):
        dn = (t_dif[:, l] * dn + r_dif[:, l] * src[:, l + 1]
              + src_dn[:, l]) * denom[l]
        flux_dn.append(dn)
    flux_dn = torch.stack(flux_dn, dim=1)

    flux_up = flux_dn * albedo + src
    flux_dn = flux_dn + flux_dir
    return flux_up, flux_dn, flux_dir


def sw_2stream_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                     inc_flux_dir, inc_flux_dif=None):
    """Plain twin of the SW two-stream kernel: fluxes summed over g."""
    up, dn, fdir = sw_solver_2stream(tau, ssa, g, mu0, sfc_alb_dir,
                                     sfc_alb_dif, inc_flux_dir, inc_flux_dif)
    return up.sum(-1), dn.sum(-1), fdir.sum(-1)


def sw_solver_2stream_broadband(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                inc_flux_dir, inc_flux_dif=None):
    """As :func:`sw_solver_2stream` but returning g-point-summed broadband
    fluxes (ncol, nlay+1): one kernel launch on the card (coefficients,
    sweeps and the spectral reduction fused, no (ncol, nlev, ngpt) planes)."""
    return _kern.sw_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                            inc_flux_dir, inc_flux_dif)


def sw_2stream_lm_plain(tau_lm, ssa_lm, g_lm, mu0, sfc_alb_dir, sfc_alb_dif,
                        inc_flux_dir, inc_flux_dif=None, *, ncol: int):
    """Plain twin of the layer-major SW kernel: :func:`sw_2stream_plain` on
    the planes viewed column-major."""
    nlay = tau_lm.shape[0] // ncol
    cm = lambda a: a.reshape(nlay, ncol, -1).transpose(0, 1)
    return sw_2stream_plain(cm(tau_lm), cm(ssa_lm), cm(g_lm), mu0,
                            sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                            inc_flux_dif)


def sw_solver_2stream_broadband_lm(tau_lm, ssa_lm, g_lm, mu0, sfc_alb_dir,
                                   sfc_alb_dif, inc_flux_dir,
                                   inc_flux_dif=None, *, ncol: int):
    """Broadband SW solve on layer-major planes: tau/ssa/g (nlay*ncol, G),
    mu0 (ncol,), albedos and incident fluxes (ncol, G).  One kernel launch
    on the card.  Returns up, dn (diffuse + direct), dir each
    (ncol, nlay+1)."""
    return _kern.sw_2stream_lm(tau_lm, ssa_lm, g_lm, mu0, sfc_alb_dir,
                               sfc_alb_dif, inc_flux_dir, inc_flux_dif,
                               ncol=ncol)


def sw_optics_plain(tau_abs, tau_ray, increments, gpt2band):
    """tau, ssa and g planes from the gas optics and per-band increments,
    as the plain chain computes them (the fused kernel entries' twin):
    ``gas_optics.combine_abs_and_rayleigh``, then
    ``optics_ops.increment_2str_by_2str_bybnd`` for each increment in turn
    (clouds, then aerosols).  Any cell shape: (ncol, nlay) or layer-major
    (nlay*ncol,)."""
    from ..models.types import OpticalProps2str
    from .gas_optics import combine_abs_and_rayleigh
    from .optics_ops import increment_2str_by_2str_bybnd

    op = OpticalProps2str(*combine_abs_and_rayleigh(tau_abs, tau_ray))
    for inc in increments:
        op = increment_2str_by_2str_bybnd(op, inc, gpt2band)
    return op


def sw_2stream_fused_plain(tau_abs, tau_ray, increments, gpt2band, mu0,
                           sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                           inc_flux_dif=None):
    """Plain twin of the fused SW kernel entry: :func:`sw_optics_plain`,
    then :func:`sw_2stream_plain`."""
    op = sw_optics_plain(tau_abs, tau_ray, increments, gpt2band)
    return sw_2stream_plain(op.tau, op.ssa, op.g, mu0, sfc_alb_dir,
                            sfc_alb_dif, inc_flux_dir, inc_flux_dif)


def sw_2stream_fused_lm_plain(tau_abs, tau_ray, increments, gpt2band, mu0,
                              sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                              inc_flux_dif=None, *, ncol: int):
    """Plain twin of the fused layer-major SW kernel entry:
    :func:`sw_optics_plain` on the layer-major planes, then
    :func:`sw_2stream_lm_plain`."""
    op = sw_optics_plain(tau_abs, tau_ray, increments, gpt2band)
    return sw_2stream_lm_plain(op.tau, op.ssa, op.g, mu0, sfc_alb_dir,
                               sfc_alb_dif, inc_flux_dir, inc_flux_dif,
                               ncol=ncol)


def sw_solver_2stream_fused_broadband(tau_abs, tau_ray, increments, gpt2band,
                                      mu0, sfc_alb_dir, sfc_alb_dif,
                                      inc_flux_dir, inc_flux_dif=None):
    """Broadband SW solve from the gas optics: tau_abs and tau_ray
    (ncol, nlay, G) and up to two per-band increments (``.tau``, ``.ssa``,
    ``.g`` each (ncol, nlay, nbnd)) added at each g-point's band
    ``gpt2band``.  One kernel launch on the card, which forms tau, ssa and
    g itself.  Returns up, dn (diffuse + direct), dir each
    (ncol, nlay+1)."""
    return _kern.sw_2stream_fused(tau_abs, tau_ray, increments, gpt2band,
                                  mu0, sfc_alb_dir, sfc_alb_dif,
                                  inc_flux_dir, inc_flux_dif)


def sw_solver_2stream_fused_broadband_lm(tau_abs, tau_ray, increments,
                                         gpt2band, mu0, sfc_alb_dir,
                                         sfc_alb_dif, inc_flux_dir,
                                         inc_flux_dif=None, *, ncol: int):
    """:func:`sw_solver_2stream_fused_broadband` on layer-major planes:
    tau_abs and tau_ray (nlay*ncol, G), the increments (nlay*ncol, nbnd)."""
    return _kern.sw_2stream_fused_lm(tau_abs, tau_ray, increments, gpt2band,
                                     mu0, sfc_alb_dir, sfc_alb_dif,
                                     inc_flux_dir, inc_flux_dif, ncol=ncol)
