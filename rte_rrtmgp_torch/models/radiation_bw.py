"""Backward (camera) rendering driver — images and broadband radiances.

Port of ``rte_rrtmgp_tpu/models/radiation_bw.py``, the equivalent of
``Radiation_solver_bw`` + ``Raytracer_bw``
(``src_test/Radiation_solver_bw.cu:960-1120``, ``src_cuda_rt/Raytracer_bw.cu``):

* gas optics once for all g-points, over spectral chunks (on the card each
  chunk is one launch of the gas-optics kernel, ``csrc/gas_optics_interp.cu``),
  cloud and aerosol optics with optional delta scaling;
* the spectral render loop over (g-point x sub-interval) steps with
  per-step scalars (Planck weight, XYZ colour factors, mean Rayleigh cross
  section) computed on the host, in windows of ``steps_per_dispatch``
  steps: step by step (``spectral_mode="scan"``) or a window's steps in one
  batched photon loop (``"lanes"``);
* each RRTMGP band is split into ``n_sub`` sub-intervals weighted by a
  5778 K Planck integral; sub-intervals replace the gas scattering with
  the Bodhaine-1999 mean Rayleigh cross section (image mode);
* spectral radiances accumulate into CIE XYZ images (``add_xyz_camera`` /
  ``normalize_xyz_camera``) with the single-lobe Gaussian fits of Wyman et
  al. (jcgt 2013) for the colour matching functions;
* the 1D background column above the domain is the first column's profile
  of the remaining layers ("first", the reference) or their column mean.

Keys as in the JAX package: the window starting at step ``s0`` folds
``1000003 * s0`` into the solve's key, and a step of g-point ``igpt`` folds
``igpt * 16`` into the window's key, so results depend on the window size
exactly as there.  The solve runs on the tables' device in ``dtype``
(float32 unless the caller asks for another, as in the JAX package); the
per-step host arrays take that dtype, the tables keep theirs and mixed
operands promote.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import aerosol_optics as aero_ops
from ..ops import cloud_optics as cloud_ops
from ..ops import gas_optics as gas_ops
from ..ops import optics_ops
from . import raytracer_bw as rbw
from .kdist import KDist, numpy_dtype
from .radiation import _host, as_torch_dtype

# ---------------------------------------------------------------------------
# Host-side spectral helpers (Radiation_solver_bw.cu:636-723).
# ---------------------------------------------------------------------------

_H, _C, _KB = 6.62607015e-34, 299792458.0, 1.380649e-23


def _planck_5778(wv_m):
    return (2.0 * _H * _C * _C / wv_m ** 5
            / (np.exp(_H * _C / (wv_m * _KB * 5778.0)) - 1.0))


def planck_integral(wv1_nm, wv2_nm, n=100):
    wv = (wv1_nm + (np.arange(n) + 0.0) * (wv2_nm - wv1_nm) / n) * 1e-9
    return _planck_5778(wv).sum() * (wv2_nm - wv1_nm) / n * 1e-9


def get_x(wv):
    a = (wv - 442.0) * np.where(wv < 442.0, 0.0624, 0.0374)
    b = (wv - 599.8) * np.where(wv < 599.8, 0.0264, 0.0323)
    c = (wv - 501.1) * np.where(wv < 501.1, 0.0490, 0.0382)
    return (0.362 * np.exp(-0.5 * a * a) + 1.056 * np.exp(-0.5 * b * b)
            - 0.065 * np.exp(-0.5 * c * c))


def get_y(wv):
    a = (wv - 568.8) * np.where(wv < 568.8, 0.0213, 0.0247)
    b = (wv - 530.9) * np.where(wv < 530.9, 0.0613, 0.0322)
    return 0.821 * np.exp(-0.5 * a * a) + 0.286 * np.exp(-0.5 * b * b)


def get_z(wv):
    a = (wv - 437.0) * np.where(wv < 437.0, 0.0845, 0.0278)
    b = (wv - 459.0) * np.where(wv < 459.0, 0.0385, 0.0725)
    return 1.217 * np.exp(-0.5 * a * a) + 0.681 * np.exp(-0.5 * b * b)


def xyz_irradiance(wv1, wv2, fn):
    wv = np.arange(wv1, wv2, 0.1) + 0.05
    return (fn(wv) * _planck_5778(wv * 1e-9)).sum() * 0.1 * 1e-9


def rayleigh_mean(wv1, wv2):
    """Bodhaine 1999 mean Rayleigh cross section over [wv1, wv2] nm."""
    Ns = 2.546899e19
    wv = wv1 + (np.arange(100) + 0.0) * (wv2 - wv1) / 100.0
    n = 1 + 1e-8 * (8060.77 + 2481070.0 / (132.274 - (wv / 1e3) ** -2)
                    + 17456.3 / (39.32957 - (wv / 1e3) ** -2))
    nom = 24.0 * np.pi ** 3 * (n * n - 1.0) ** 2
    denom = (wv / 1e7) ** 4 * Ns * Ns * (n * n + 2.0) ** 2
    return (nom / denom * 1.055).mean()


def spectral_weights(kd: KDist, n_sub: int):
    """Per (gpt, sub): (igpt, band, toa_factor, xyz factors (3,), mean
    Rayleigh cross section).

    toa_factor = planck(sub)/planck(band) / solar_source(band)
    (Radiation_solver_bw.cu:1006-1016)."""
    solar = kd.solar_source.detach().cpu().numpy().astype(np.float64)
    band_solar = np.array([solar[g0:g1].sum() for g0, g1 in kd.band_lims_gpt])
    steps = []
    for igpt in range(kd.ngpt):
        band = kd.gpt2band[igpt]
        wn1, wn2 = kd.band_lims_wvn[band]
        wv1, wv2 = 1e7 / wn2, 1e7 / wn1      # nm
        total_p = planck_integral(wv1, wv2)
        dwv = (wv2 - wv1) / n_sub
        for isub in range(n_sub):
            a, b = wv1 + isub * dwv, wv1 + (isub + 1) * dwv
            toa_factor = (planck_integral(a, b) / total_p
                          / max(band_solar[band], 1e-30))
            xyz = np.array([xyz_irradiance(a, b, get_x),
                            xyz_irradiance(a, b, get_y),
                            xyz_irradiance(a, b, get_z)])
            rayl = rayleigh_mean(a, b) if n_sub > 1 else 0.0
            steps.append((igpt, band, toa_factor, xyz, rayl))
    return steps


def gas_planes(kd: KDist, p_lay, t_lay, vmr, col_dry, gpt_chunk=None):
    """Gas optical depth and single-scattering albedo of every g-point,
    (ncol, nlay, ngpt) each, surface at layer 0: the k-distribution
    interpolated on top-at-0 inputs, one spectral chunk of ``gpt_chunk``
    g-points at a time (None: one chunk)."""
    flip = lambda a: torch.flip(a, dims=(1,))
    play_f, tlay_f, col_dry_f = flip(p_lay), flip(t_lay), flip(col_dry)
    col_gas = gas_ops.build_col_gas(flip(vmr), col_dry_f)
    interp = gas_ops.interpolation(kd, play_f, tlay_f, col_gas)
    taus, ssas = [], []
    step = gpt_chunk or kd.ngpt
    for g0 in range(0, kd.ngpt, step):
        kdc = kd.slice_gpt(g0, min(g0 + step, kd.ngpt))
        t, r = gas_ops.tau_majmin_and_rayleigh(kdc, interp, play_f, tlay_f,
                                               col_gas)
        tt, ss, _ = gas_ops.combine_abs_and_rayleigh(t, r)
        taus.append(flip(tt))
        ssas.append(flip(ss))
    return torch.cat(taus, dim=-1), torch.cat(ssas, dim=-1)


class RadiationSolverBW:
    """Backward Monte-Carlo camera renderer.

    Mie tables (``load_mie_tables``, Radiation_solver_bw.cu:740-788):
    broadband layout ``mie_cdf`` (nbnd, n_cdf), ``mie_ang``
    (nbnd, n_re, n_cdf), ``mie_phase`` (nbnd, n_re, n_ang); image layout
    adds a sub_band axis after nbnd ((nbnd, n_sub, ...)).
    ``mie_phase_ang`` (n_ang,) is the shared uniform angle grid."""

    def __init__(self, kdist: KDist, cloud_lut=None, aerosol_lut=None,
                 mie_cdf=None, mie_ang=None, mie_phase=None,
                 mie_phase_ang=None):
        self.kdist = kdist
        self.cloud_lut = cloud_lut
        self.aerosol_lut = aerosol_lut
        self.mie_cdf = mie_cdf
        self.mie_ang = mie_ang
        self.mie_phase = mie_phase
        self.mie_phase_ang = mie_phase_ang

    def solve(self, gas_concs, p_lay, p_lev, t_lay, mu0, azi,
              sfc_alb, land_use_map, camera: rbw.Camera,
              grid_cells, grid_d, kn_grid, z_lev,
              col_dry=None, lwp=None, iwp=None, rel=None, dei=None,
              rh=None, aermr=None, photons_per_pixel: int = 16,
              mode: str = "image", n_sub: int = 3,
              delta_cloud: bool = False, delta_aerosol: bool = False,
              gpt_chunk: Optional[int] = None, seed: int = 0,
              bg_column: str = "first", steps_per_dispatch=4,
              nee_mode: str = "walk", spectral_mode: str = "scan",
              respawn_mode: str = "auto", return_aux: bool = False,
              spectral_steps: slice = slice(None), dtype=torch.float32):
        """Render a camera view.  mode="image" -> {"XYZ": (3, ny, nx),
        "radiance"}; mode="broadband" -> {"radiance": (ny, nx)}.

        z_lev: (nlev,) heights of ALL model levels (the background column
        spans z_lev[nz:]); surface at layer 0.  ``steps_per_dispatch``:
        spectral steps a window (None or "auto": one window).  ``seed``
        makes the solve's key.  With ``return_aux`` also a dict with each
        trace's loop counts (``"traces"``).  ``spectral_steps``: the slice
        of the spectral steps to render (all; ``tools/bench_bw`` times
        one step's loop with a slice of one).  ``dtype``: a torch or NumPy
        dtype.
        """
        kd = self.kdist
        dtype, dev = as_torch_dtype(dtype), kd.device
        p = _host(p_lay)
        if not p[0, 0] > p[0, -1]:
            raise ValueError("BW solver expects the surface at layer 0")
        ncol, nlay = p.shape
        nz, ny, nx = grid_cells
        if ncol != ny * nx or nz >= nlay:
            raise ValueError(f"grid_cells {tuple(grid_cells)} do not fit "
                             f"{ncol} columns x {nlay} layers with a "
                             "background layer above the domain")
        if mode == "broadband":
            n_sub = 1
        cast = lambda a: torch.as_tensor(_host(a), dtype=dtype, device=dev)

        vmr = cast(gas_concs.materialize(kd.gas_names, ncol, nlay,
                                         dtype=numpy_dtype(dtype)))
        col_dry = (gas_ops.get_col_dry(cast(gas_concs.expand("h2o", ncol,
                                                             nlay)),
                                       cast(p_lev))
                   if col_dry is None else cast(col_dry))
        gas_tau, gas_ssa = gas_planes(kd, cast(p_lay), cast(t_lay), vmr,
                                      col_dry, gpt_chunk)

        cld = aer = None
        if lwp is not None:
            cld = cloud_ops.cloud_optics_2str(self.cloud_lut, cast(lwp),
                                              cast(iwp), cast(rel), cast(dei))
            if delta_cloud:
                cld = optics_ops.delta_scale(cld)
        if aermr is not None:
            aer = aero_ops.aerosol_optics_2str(self.aerosol_lut, cast(aermr),
                                               cast(rh), cast(p_lev))
            if delta_aerosol:
                aer = optics_ops.delta_scale(aer)

        # --- spectral step table (host) ---
        steps = spectral_weights(kd, n_sub)[spectral_steps]
        ft = numpy_dtype(dtype)
        igpt_arr = np.array([s[0] for s in steps], np.int64)
        band_arr = np.array([s[1] for s in steps], np.int64)
        toaf_arr = np.array([s[2] for s in steps], ft)
        xyz_arr = np.array([s[3] for s in steps], ft)
        rayl_arr = np.array([s[4] for s in steps], ft)

        # --- Mie tables: flatten any (nbnd, n_sub, ...) image layout to
        # (nbnd*n_sub, ...) with each step's row (the reference's
        # per-(band, iwv) subsets, Radiation_solver_bw.cu:1036-1038) ---
        mie = None
        mie_idx_arr = np.zeros_like(band_arr)
        if self.mie_cdf is not None and lwp is not None:
            mc = np.asarray(_host(self.mie_cdf), ft)
            ma = np.asarray(_host(self.mie_ang), ft)
            if ma.ndim == 4:           # image layout with a sub_band axis
                nsub_t = ma.shape[1]
                if nsub_t != n_sub:
                    raise ValueError(f"Mie tables have {nsub_t} sub-bands, "
                                     f"the render {n_sub}")
                isub = np.arange(len(steps)) % n_sub
                mie_idx_arr = band_arr * nsub_t + isub
                mc = mc.reshape(-1, mc.shape[-1])
                ma = ma.reshape(-1, *ma.shape[2:])
            else:
                mie_idx_arr = band_arr
            mie = dict(mie_cdf=cast(mc), mie_ang=cast(ma))
            if self.mie_phase is not None:
                mp = np.asarray(_host(self.mie_phase), ft)
                if mp.ndim == 4:
                    mp = mp.reshape(-1, *mp.shape[2:])
                mie.update(mie_phase=cast(mp),
                           mie_phase_ang=cast(self.mie_phase_ang))
        rel_dom = cast(rel) if (rel is not None and mie is not None) else None

        # per-cell air column for the Bodhaine Rayleigh override
        air_col = col_dry * (1.0 + vmr[:, :, kd.idx_h2o - 1])

        n_steps = len(steps)
        spd = (n_steps if steps_per_dispatch in (None, "auto")
               else min(int(steps_per_dispatch), n_steps))
        key = rbw._key(seed)
        acc, traces = None, []
        for s0 in range(0, n_steps, spd):
            sl = slice(s0, min(s0 + spd, n_steps))
            part, aux = _render(
                kd, rbw._fold_in(key, 1000003 * s0), gas_tau, gas_ssa, cld,
                aer, cast(sfc_alb), cast(land_use_map), cast(mu0), cast(azi),
                air_col, cast(z_lev), igpt_arr[sl], band_arr[sl],
                toaf_arr[sl], xyz_arr[sl], rayl_arr[sl], mie_idx_arr[sl],
                rel_dom, mie, camera=camera, grid_cells=tuple(grid_cells),
                grid_d=tuple(float(d) for d in grid_d),
                kn_grid=tuple(kn_grid), photons_per_pixel=photons_per_pixel,
                bg_column=bg_column, nee_mode=nee_mode,
                spectral_mode=spectral_mode, respawn_mode=respawn_mode,
                dtype=dtype)
            acc = part if acc is None else tuple(a + b for a, b in
                                                 zip(acc, part))
            traces += aux
        xyz_img, radiance, total_src = acc
        if mode == "image":
            # normalize_xyz_camera (Raytracer_bw.cu:339-357)
            out = {"XYZ": xyz_img / torch.clamp(total_src, min=1e-30),
                   "radiance": radiance}
        else:
            out = {"radiance": radiance}
        return (out, {"traces": traces}) if return_aux else out


def step_optics(gas_tau, gas_ssa, cld, aer, air_col, sfc_alb, igpt: int,
                band: int, rayl_xs: float, *, grid_cells, dz: float,
                bg_column: str = "first"):
    """One spectral step's tracer inputs: the six 3D fields (k_ext,
    k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer), the background
    profile (k_ext, ssa, scattering split [gas, cld, aer]) of the layers
    above the domain, and the albedo (ny, nx).  ``cld`` / ``aer``: (tau,
    ssa, g) by band, (ncol, nlay, nbnd), or None."""
    nz, ny, nx = grid_cells
    ncol, nlay, _ = gas_tau.shape

    def pick(a):     # the JAX package's take(mode="clip") on the band axis
        return a[:, :, min(band, a.shape[2] - 1)]

    zeros = torch.zeros((ncol, nlay), dtype=gas_tau.dtype,
                        device=gas_tau.device)
    tc, sc, gc = (pick(a) for a in cld) if cld is not None else (zeros,) * 3
    ta, sa, ga = (pick(a) for a in aer) if aer is not None else (zeros,) * 3
    tau_g, ssa_g = gas_tau[:, :, igpt], gas_ssa[:, :, igpt]

    # gas absorption fixed; scattering optionally replaced by the mean
    # Bodhaine cross section of the sub-interval.
    tau_abs_g = tau_g * (1.0 - ssa_g)
    tau_sca_g = rayl_xs * air_col if rayl_xs > 0.0 else tau_g * ssa_g
    k_abs_g = tau_abs_g / dz
    k_sca_g = tau_sca_g / dz
    k_sca_c = tc * sc / dz
    k_sca_a = ta * sa / dz
    k_abs_c = tc * (1.0 - sc) / dz
    k_abs_a = ta * (1.0 - sa) / dz
    k_ext = k_abs_g + k_sca_g + k_sca_c + k_sca_a + k_abs_c + k_abs_a

    to3d = lambda a: a[:, :nz].T.reshape(nz, ny, nx)
    k3 = tuple(to3d(a) for a in (k_ext, k_sca_g, k_sca_c, k_sca_a, gc, ga))
    # The reference's background_profile kernel takes the first column
    # (src_cuda_rt/Raytracer_bw.cu:200-238); "mean" averages all columns.
    if bg_column == "mean":
        bg = lambda a: a[:, nz:].mean(dim=0)
    else:
        bg = lambda a: a[0, nz:]
    kbg_prof = bg(k_ext)
    ksca_bg = bg(k_sca_g + k_sca_c + k_sca_a)
    ssa_bg = ksca_bg / torch.clamp(kbg_prof, min=1e-30)
    split = torch.stack([bg(k_sca_g) / torch.clamp(ksca_bg, min=1e-30),
                         bg(k_sca_c) / torch.clamp(ksca_bg, min=1e-30),
                         bg(k_sca_a) / torch.clamp(ksca_bg, min=1e-30)], dim=1)
    alb = sfc_alb[:, min(band, sfc_alb.shape[1] - 1)].reshape(ny, nx)
    return k3, (kbg_prof, ssa_bg, split), alb


def _render(kd: KDist, key, gas_tau, gas_ssa, cld, aer, sfc_alb, land_use,
            mu0, azi, air_col, z_lev, igpt_arr, band_arr, toaf_arr, xyz_arr,
            rayl_arr, mie_idx_arr, rel_dom, mie, *, camera, grid_cells,
            grid_d, kn_grid, photons_per_pixel: int, bg_column: str,
            nee_mode: str, spectral_mode: str, respawn_mode: str, dtype):
    """One window of spectral steps.  Returns ((3, ny, nx) XYZ, (ny, nx)
    radiance, total source) summed over the window's steps, and each
    trace's aux dict.  The solar source enters in the solve's ``dtype``."""
    nz, ny, nx = grid_cells
    ncol, nlay, _ = gas_tau.shape
    if nlay - nz < 1:
        raise ValueError("backward tracer needs at least one background layer")
    dz = grid_d[0]
    mu = torch.clamp(mu0[0], min=1e-3)
    zen = torch.arccos(torch.clamp(mu, -1.0, 1.0))
    sun_dir = torch.stack([  # toward the sun (z > 0)
        torch.sin(zen) * torch.cos(0.5 * np.pi - azi[0]),
        torch.sin(zen) * torch.sin(0.5 * np.pi - azi[0]),
        torch.cos(zen)])
    z_lev_bg = z_lev[nz:]
    cld_b = None if cld is None else (cld.tau, cld.ssa, cld.g)
    aer_b = None if aer is None else (aer.tau, aer.ssa, aer.g)
    rel3 = (rel_dom[:, :nz].T.reshape(nz, ny, nx)
            if mie is not None and rel_dom is not None else None)
    land = land_use.reshape(ny, nx)
    solar = kd.solar_source.to(dtype)

    def optics(i):
        k3, bgp, alb = step_optics(
            gas_tau, gas_ssa, cld_b, aer_b, air_col, sfc_alb,
            int(igpt_arr[i]), int(band_arr[i]), float(rayl_arr[i]),
            grid_cells=grid_cells, dz=dz, bg_column=bg_column)
        mie_s = None
        if mie is not None:
            # the step's Mie row (take(mode="clip"))
            mi = lambda t: t[min(int(mie_idx_arr[i]), t.shape[0] - 1)]
            mie_s = {k: mi(v) for k, v in mie.items() if k != "mie_phase_ang"}
        return k3, bgp, alb, mie_s

    common = dict(photons_per_pixel=photons_per_pixel, nee_mode=nee_mode,
                  respawn_mode=respawn_mode, return_aux=True)
    if mie is not None:
        common.update(r_eff=rel3, mie_phase_ang=mie.get("mie_phase_ang"))
    n = len(igpt_arr)
    toa_src = solar[torch.as_tensor(igpt_arr, device=solar.device)]
    toaf = torch.as_tensor(toaf_arr, device=solar.device)
    xyz = torch.as_tensor(xyz_arr, device=solar.device)
    flux_w = toa_src * toaf / photons_per_pixel            # (n,)
    if spectral_mode == "lanes":
        # Every step of this window traces in one batched photon loop;
        # per-step keys equal the scan's, so the modes agree to
        # accumulation order.
        ins = [optics(i) for i in range(n)]
        stack = lambda f: torch.stack([f(x) for x in ins])
        mie_kw = {}
        if mie is not None:
            mie_kw = {k: stack(lambda x, k=k: x[3][k]) for k in ins[0][3]}
        (counts, _), aux = rbw.trace_rays_bw_batched(
            [rbw._fold_in(key, int(g) * 16 + 0) for g in igpt_arr], camera,
            *(stack(lambda x, j=j: x[0][j]) for j in range(6)),
            *(stack(lambda x, j=j: x[1][j]) for j in range(3)), z_lev_bg,
            stack(lambda x: x[2]), land, kn_grid, grid_d, sun_dir, mu,
            **common, **mie_kw)
        flux_cam = counts * flux_w[:, None, None]
        xyz_img = torch.einsum("sc,syx->cyx", xyz.to(flux_cam.dtype),
                               flux_cam)
        radiance = flux_cam.sum(dim=0)
        return (xyz_img, radiance, (toa_src * toaf).sum()), [aux]

    xyz_img = torch.zeros((3, camera.ny, camera.nx), dtype=gas_tau.dtype,
                          device=gas_tau.device)
    radiance = torch.zeros((camera.ny, camera.nx), dtype=gas_tau.dtype,
                           device=gas_tau.device)
    total_src = torch.zeros((), dtype=gas_tau.dtype, device=gas_tau.device)
    auxes = []
    for i in range(n):
        k3, bgp, alb, mie_s = optics(i)
        (count, _), aux = rbw.trace_rays_bw(
            rbw._fold_in(key, int(igpt_arr[i]) * 16 + 0), camera, *k3, *bgp,
            z_lev_bg, alb, land, kn_grid, grid_d, sun_dir, mu, **common,
            **(mie_s or {}))
        flux_cam = rbw.count_to_radiance(count, toa_src[i], toaf[i],
                                         photons_per_pixel)
        xyz_img = xyz_img + xyz[i][:, None, None] * flux_cam[None, :, :]
        radiance = radiance + flux_cam
        total_src = total_src + toa_src[i] * toaf[i]
        auxes.append(aux)
    return (xyz_img, radiance, total_src), auxes
