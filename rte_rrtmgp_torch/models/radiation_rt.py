"""3D forward ray-traced shortwave solver (per-g-point spectral streaming).

Port of ``rte_rrtmgp_tpu/models/radiation_rt.py``, the equivalent of
``Radiation_solver_shortwave::solve_gpu`` in
``src_test/Radiation_solver_rt.cu:668-990`` + ``Raytracer::trace_rays``:

* pass 1: gas optics once for all g-points, over spectral chunks (on the
  card each chunk is one launch of the gas-optics kernel,
  ``csrc/gas_optics_interp.cu``), cloud and aerosol optics, and the
  optional 1D two-stream pass (the by-g-point SW solver, plain PyTorch as
  the JAX package's ``lax.scan``);
* pass 2: a loop over g-points driving the Monte-Carlo tracer and the
  per-g-point flux accumulation (``add_from_gpoint``,
  ``src_kernels_cuda_rt/gpt_combine_kernels_rt.cu``) — ``spectral_mode=
  "lanes"`` traces a window's g-points in one batched photon loop instead;
* when the atmosphere extends above the 3D domain, the ray-traced grid
  gets ONE extra cell on top (``test_rte_rrtmgp_rt.cu:334``) whose optical
  properties integrate every above-domain layer (``bundles_optical_props_
  tod``, Raytracer.cu:111-166).

G-point ``igpt`` draws from the stream of ``seed + igpt`` (the JAX
package's ``fold_in(key, igpt)``), so the scan, the windows of
``gpt_per_dispatch`` and the ``lanes`` mode trace every g-point with the
same stream.  The solve runs on the tables' device in ``dtype`` (float32
unless the caller asks for another, as the JAX package's ``dtype or
np.float32``); the tables keep theirs and mixed operands promote.

Domain conventions: columns are an (ny, nx) raster with column index
``icol = iy*nx + ix``; the surface is at layer index 0 (LES-style grids);
the ray-traced domain spans the lowest ``nz`` layers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops import aerosol_optics as aero_ops
from ..ops import cloud_optics as cloud_ops
from ..ops import fluxes as flux_ops
from ..ops import gas_optics as gas_ops
from ..ops import optics_ops, rte_sw
from . import raytracer as rt
from .kdist import KDist, numpy_dtype
from .radiation import _host, as_torch_dtype


class RTFluxes(NamedTuple):
    # broadband ray-traced fluxes
    rt_flux_tod_dn: object   # (ny, nx)
    rt_flux_tod_up: object
    rt_flux_sfc_dir: object
    rt_flux_sfc_dif: object
    rt_flux_sfc_up: object
    # (nz_rt, ny, nx) with nz_rt = nz+1 when the atmosphere extends above
    # the domain: the last layer is the above-domain (TOD) integral cell.
    rt_flux_abs_dir: object
    rt_flux_abs_dif: object
    # broadband two-stream fluxes (None unless requested)
    sw_flux_up: object
    sw_flux_dn: object
    sw_flux_dn_dir: object
    # by-band outputs (None unless output_bnd_fluxes; reference
    # Fluxes_byband_rt, include_rt/Fluxes_rt.h:113-142, extended to the
    # ray-traced accumulators)
    sw_bnd_flux_up: object = None       # (ncol, nlev, nbnd)
    sw_bnd_flux_dn: object = None
    sw_bnd_flux_dn_dir: object = None
    rt_bnd_flux_tod_dn: object = None   # (nbnd, ny, nx)
    rt_bnd_flux_tod_up: object = None
    rt_bnd_flux_sfc_dir: object = None
    rt_bnd_flux_sfc_dif: object = None
    rt_bnd_flux_sfc_up: object = None


def _flip(a):
    return torch.flip(a, dims=(1,))


def _pass1(kd: KDist, p_lay, t_lay, vmr, col_dry, sfc_alb_dir, sfc_alb_dif,
           tsi_scaling, mu0_safe, cld, aer, *, gpt_chunk, nbnd: int,
           with_twostream: bool, output_bnd_fluxes: bool, want_planes: bool):
    """Gas optics over spectral chunks and the optional two-stream solve,
    on top-at-0 inputs.  Returns the broadband two-stream (up, dn, dir)
    sums (or None), their by-band sums (or None) and the gas (tau, ssa)
    planes flipped back to surface-at-0, (ncol, nlay, ngpt) each (or None
    unless ``want_planes``)."""
    ncol, nlay = p_lay.shape
    dtype, dev = p_lay.dtype, p_lay.device
    col_gas = gas_ops.build_col_gas(vmr, col_dry)
    interp = gas_ops.interpolation(kd, p_lay, t_lay, col_gas)
    cellw = config.cellw_enabled(kd.device)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    ts = (zeros(ncol, nlay + 1),) * 3 if with_twostream else None
    bnd_ts = ((zeros(ncol, nlay + 1, nbnd),) * 3
              if output_bnd_fluxes and with_twostream else None)
    tau_parts, ssa_parts = [], []
    step = gpt_chunk or kd.ngpt
    for g0 in range(0, kd.ngpt, step):
        kdc = kd.slice_gpt(g0, min(g0 + step, kd.ngpt))
        tau_abs, tau_ray = gas_ops.tau_majmin_and_rayleigh(
            kdc, interp, p_lay, t_lay, col_gas, col_dry, cellw=cellw)
        tau_g, ssa_g, _ = gas_ops.combine_abs_and_rayleigh(tau_abs, tau_ray)
        if want_planes:
            tau_parts.append(_flip(tau_g))
            ssa_parts.append(_flip(ssa_g))
        if not with_twostream:
            continue
        op = optics_ops.OpticalProps2str(tau=tau_g, ssa=ssa_g,
                                         g=torch.zeros_like(tau_g))
        for extra in (cld, aer):
            if extra is not None:
                op = optics_ops.increment_2str_by_2str_bybnd(
                    op, optics_ops.OpticalProps2str(
                        tau=_flip(extra.tau), ssa=_flip(extra.ssa),
                        g=_flip(extra.g)), kdc.gpt2band)
        toa = (kdc.solar_source[None, :] * tsi_scaling[:, None]).to(dtype)
        up, dn, fdir = rte_sw.sw_solver_2stream(
            op.tau, op.ssa, op.g, mu0_safe,
            flux_ops.expand_bands_to_gpt(sfc_alb_dir, kdc.gpt2band),
            flux_ops.expand_bands_to_gpt(sfc_alb_dif, kdc.gpt2band), toa)
        ts = tuple(acc + flux_ops.sum_broadband(f)
                   for acc, f in zip(ts, (up, dn, fdir)))
        if bnd_ts is not None:
            bnd_ts = tuple(acc + flux_ops.sum_byband(f, kdc.gpt2band, nbnd)
                           for acc, f in zip(bnd_ts, (up, dn, fdir)))
    planes = ((torch.cat(tau_parts, dim=-1), torch.cat(ssa_parts, dim=-1))
              if want_planes else None)
    return ts, bnd_ts, planes


def _solve_rt_impl(kd: KDist, cloud_lut, aerosol_lut, seed: int,
                   p_lay, p_lev, t_lay, vmr, col_dry,
                   sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0, azi,
                   lwp, iwp, rel, dei, rh, aermr, grid_d,
                   mie_cdf, mie_ang, g_start=None, acc_in=None,
                   gas_planes=None,
                   *, grid_cells, kn_grid, photons_per_pixel: int,
                   independent_column: bool, gpt_chunk,
                   with_twostream: bool, with_raytracing: bool,
                   with_clouds: bool, with_aerosols: bool,
                   delta_cloud: bool, delta_aerosol: bool,
                   with_mie: bool = False,
                   output_bnd_fluxes: bool = False,
                   scan_width=None,
                   spectral_mode: str = "scan",
                   nbnd: Optional[int] = None,
                   return_gas_planes: bool = False):
    """The JAX package's ``_solve_rt_impl``: pass 1, then the g-point loop
    over all g-points, or over ``scan_width`` g-points from ``g_start``
    chaining the accumulators ``acc_in`` (a window; returns the raw
    accumulators).  ``gas_planes``: pass 1's planes, precomputed."""
    nz, ny, nx = grid_cells
    ncol, nlay = p_lay.shape
    dtype, dev = p_lay.dtype, p_lay.device
    # By-band accumulators always span the FULL band axis: with
    # --single-gpt the sliced kd shrinks nbnd to 1 while gpt2band keeps
    # GLOBAL band indices, so the caller passes the unsliced band count.
    nbnd = kd.nbnd if nbnd is None else nbnd

    cld = aer = None
    if with_clouds:
        cld = cloud_ops.cloud_optics_2str(cloud_lut, lwp, iwp, rel, dei)
        if delta_cloud:
            cld = optics_ops.delta_scale(cld)      # banded, surface-at-0
    if with_aerosols:
        aer = aero_ops.aerosol_optics_2str(aerosol_lut, aermr, rh, p_lev)
        if delta_aerosol:
            aer = optics_ops.delta_scale(aer)

    mu0_safe = torch.where(mu0 > 0.0, mu0, 1.0)

    # --- pass 1 (top-at-0 for the 1D work: flip, the surface is at 0) ---
    ts = bnd_ts = None
    if gas_planes is None:
        ts, bnd_ts, gas_planes = _pass1(
            kd, _flip(p_lay), _flip(t_lay), _flip(vmr), _flip(col_dry),
            sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0_safe, cld, aer,
            gpt_chunk=gpt_chunk, nbnd=nbnd, with_twostream=with_twostream,
            output_bnd_fluxes=output_bnd_fluxes, want_planes=with_raytracing)
    day = (mu0 > 0.0).to(dtype)[:, None]
    ts_out = (tuple(_flip(a) * day for a in ts) if ts is not None
              else (None, None, None))
    bnd_ts_out = (tuple(_flip(a) * day[:, :, None] for a in bnd_ts)
                  if bnd_ts is not None else (None, None, None))

    # Ray-traced grid height: one extra integrated cell above the domain
    # when the atmosphere extends past it (test_rte_rrtmgp_rt.cu:334).
    nz_rt = nz + 1 if nz < nlay else nz

    if not with_raytracing:
        zeros2 = torch.zeros((ny, nx), dtype=dtype, device=dev)
        zeros3 = torch.zeros((nz_rt, ny, nx), dtype=dtype, device=dev)
        return RTFluxes(zeros2, zeros2, zeros2, zeros2, zeros2, zeros3, zeros3,
                        *ts_out, *bnd_ts_out)
    if return_gas_planes:
        return gas_planes
    gas_tau, gas_ssa = gas_planes

    # --- pass 2: the g-point loop driving the Monte-Carlo tracer ---
    zero_b = torch.zeros((ncol, nlay, nbnd), dtype=dtype, device=dev)
    cld_b = ((cld.tau, cld.ssa, cld.g) if with_clouds
             else (zero_b, zero_b, zero_b))
    aer_b = ((aer.tau, aer.ssa, aer.g) if with_aerosols
             else (zero_b, zero_b, zero_b))
    nb = cld_b[0].shape[-1]

    dz = float(grid_d[0])
    zen = torch.arccos(torch.clamp(mu0_safe[0], -1.0, 1.0))
    azi0 = azi[0]
    sun_dir = torch.stack([
        -torch.sin(zen) * torch.cos(0.5 * math.pi - azi0),
        -torch.sin(zen) * torch.sin(0.5 * math.pi - azi0),
        -torch.cos(zen)])

    def to3d(col_field_lay):  # (ncol, nz_rt) -> (nz_rt, ny, nx)
        return col_field_lay.T.reshape(nz_rt, ny, nx)

    if with_clouds:
        # No clouds above the domain: zero r_eff in the extra TOD cell.
        rel3d = to3d(torch.cat(
            [rel[:, :nz], torch.zeros((ncol, nz_rt - nz), dtype=dtype,
                                      device=dev)], dim=1))
    else:
        rel3d = torch.zeros((nz_rt, ny, nx), dtype=dtype, device=dev)

    def tod_compress(q):
        """(ncol, nlay) -> (ncol, nz_rt): in-domain cells keep their exact
        per-layer values; the extra top cell (if any) integrates every
        above-domain layer into one cell of height dz
        (bundles_optical_props_tod, Raytracer.cu:111-166)."""
        if nz_rt == nz:
            return q[:, :nz]
        return torch.cat([q[:, :nz], q[:, nz:].sum(dim=1, keepdim=True)],
                         dim=1)

    g2b = kd.gpt2band

    def optics(igpt):
        """One g-point's tracer inputs: the six 3D fields, the albedo
        (ny, nx), the TOD direct flux and the band's Mie tables."""
        band = g2b[igpt]
        bc = min(band, nb - 1)    # the JAX package's take(mode="clip")
        tau_cld, ssa_cld, g_cld = (a[:, :, bc] for a in cld_b)
        tau_aer, ssa_aer, g_aer = (a[:, :, bc] for a in aer_b)
        tau_g, ssa_g = gas_tau[:, :, igpt], gas_ssa[:, :, igpt]

        # total optics per cell = gas + cloud + aerosol (increment op)
        tau_tot = tau_g + tau_cld + tau_aer
        tausca = tau_g * ssa_g + tau_cld * ssa_cld + tau_aer * ssa_aer

        # TOD compression of scattering-weighted quantities.
        tau_tot_c = tod_compress(tau_tot)
        tausca_c = tod_compress(tausca)
        ssa_tot_c = tausca_c / torch.clamp(tau_tot_c, min=1e-30)
        tau_cld_c = tod_compress(tau_cld)
        tausca_cld_c = tod_compress(tau_cld * ssa_cld)
        ssa_cld_c = tausca_cld_c / torch.clamp(tau_cld_c, min=1e-30)
        asy_cld_c = (tod_compress(tau_cld * ssa_cld * g_cld)
                     / torch.clamp(tausca_cld_c, min=1e-30))
        tau_aer_c = tod_compress(tau_aer)
        tausca_aer_c = tod_compress(tau_aer * ssa_aer)
        ssa_aer_c = tausca_aer_c / torch.clamp(tau_aer_c, min=1e-30)
        asy_aer_c = (tod_compress(tau_aer * ssa_aer * g_aer)
                     / torch.clamp(tausca_aer_c, min=1e-30))

        k = rt.bundle_optical_props(
            to3d(tau_tot_c), to3d(ssa_tot_c),
            to3d(tau_cld_c), to3d(ssa_cld_c), to3d(asy_cld_c),
            to3d(tau_aer_c), to3d(ssa_aer_c), to3d(asy_aer_c), dz)
        alb_band = sfc_alb_dir[:, min(band, sfc_alb_dir.shape[1] - 1)]
        tod_dir = kd.solar_source[igpt] * tsi_scaling[0] * mu0_safe[0]
        mie = None
        if with_mie:
            # Per-band Mie phase-function subset (the reference's
            # mie_cdfs.subset per band, Radiation_solver_rt.cu:921-935).
            mb = min(band, mie_cdf.shape[0] - 1)
            mie = (mie_cdf[mb], mie_ang[mb])
        return k, alb_band.reshape(ny, nx), tod_dir.to(dtype), mie, band

    common = dict(photons_per_pixel=photons_per_pixel,
                  independent_column=independent_column,
                  # "auto": env > the persisted tune_rt.py winner > "fifo".
                  respawn_mode="auto")
    zeros2 = torch.zeros((ny, nx), dtype=dtype, device=dev)
    zeros3 = torch.zeros((nz_rt, ny, nx), dtype=dtype, device=dev)
    acc = [zeros2, zeros2, zeros2, zeros2, zeros2, zeros3, zeros3]
    if output_bnd_fluxes:
        acc += [torch.zeros((nbnd, ny, nx), dtype=dtype, device=dev)
                for _ in range(5)]
    if acc_in is not None:
        acc = list(acc_in)
    g_lo = 0 if scan_width is None else int(g_start)
    gpts = range(g_lo, kd.ngpt if scan_width is None else g_lo + scan_width)

    def add(flat, band):
        for i, f in enumerate(flat):
            acc[i] = acc[i] + f
        if output_bnd_fluxes:
            # By-band accumulation of the 2D ray-traced fluxes
            # (Fluxes_byband_rt analog).
            for i, f in enumerate(flat[:5]):
                b = acc[7 + i].clone()
                b[band] = b[band] + f
                acc[7 + i] = b

    if spectral_mode == "lanes":
        # Every g-point of this window traces concurrently in one batched
        # photon loop; per-g streams equal the scan's, so the two modes
        # agree to accumulation order.
        ins = [optics(igpt) for igpt in gpts]
        stack = lambda j: torch.stack([x[0][j] for x in ins])
        mie_kw = {}
        if with_mie:
            mie_kw = dict(mie_cdf=torch.stack([x[3][0] for x in ins]),
                          mie_ang=torch.stack([x[3][1] for x in ins]))
        out = rt.trace_rays_batched(
            [seed + igpt for igpt in gpts], *(stack(j) for j in range(6)),
            rel3d, torch.stack([x[1] for x in ins]), kn_grid, grid_d,
            torch.stack([x[2] for x in ins]),
            torch.zeros(len(ins), dtype=dtype, device=dev), sun_dir,
            **common, **mie_kw)
        for w, x in enumerate(ins):
            add(tuple(f[w] for f in out), x[4])
    else:
        for igpt in gpts:
            k, alb_band, tod_dir, mie, band = optics(igpt)
            mie_kw = ({} if mie is None
                      else dict(mie_cdf=mie[0], mie_ang=mie[1]))
            out = rt.trace_rays(
                seed + igpt, *k, rel3d, alb_band, kn_grid, grid_d, tod_dir,
                0.0, sun_dir, **common, **mie_kw)
            add(tuple(out), band)

    day0 = (mu0[0] > 0.0).to(dtype)
    acc = tuple(a * day0 for a in acc)
    if scan_width is not None:
        # Window mode: the raw accumulators for chaining (the day0 mask is
        # 0/1 and idempotent over summed windows).
        return acc
    bnd_rt = acc[7:] if output_bnd_fluxes else (None,) * 5
    return RTFluxes(*acc[:7], *ts_out, *bnd_ts_out, *bnd_rt)


class RadiationSolverRT:
    """Shortwave 3D forward ray-tracing solver (per-g-point streaming)."""

    def __init__(self, kdist: KDist, cloud_lut=None, aerosol_lut=None,
                 mie_cdf=None, mie_ang=None):
        self.kdist = kdist
        self.cloud_lut = cloud_lut
        self.aerosol_lut = aerosol_lut
        self.mie_cdf = mie_cdf
        self.mie_ang = mie_ang

    def solve(self, gas_concs, p_lay, p_lev, t_lay, mu0, azi,
              sfc_alb_dir, sfc_alb_dif, grid_cells, grid_d, kn_grid,
              tsi_scaling=None, col_dry=None, lwp=None, iwp=None, rel=None,
              dei=None, rh=None, aermr=None, photons_per_pixel: int = 32,
              independent_column: bool = False, raytracing: bool = True,
              twostream: bool = False, delta_cloud: bool = False,
              delta_aerosol: bool = False, gpt_chunk: Optional[int] = None,
              single_gpt: Optional[int] = None,
              output_bnd_fluxes: bool = False,
              gpt_per_dispatch: Optional[int] = None,
              spectral_mode: str = "scan", seed: int = 0,
              dtype=None) -> RTFluxes:
        """grid_cells = (nz, ny, nx); grid_d = (dz, dy, dx) in meters.
        Runs on the k-distribution's device in ``dtype`` (a torch or NumPy
        dtype; None: float32, the JAX package's default).

        Surface must be at layer index 0 (LES-style ordering;
        p_lay[:, 0] > p_lay[:, -1]).

        ``gpt_per_dispatch``: trace the g-points in windows of this many
        (the largest divisor of ngpt not above it), chaining the
        accumulators; None traces them in one window.  The windows equal
        one window up to accumulation order.

        ``spectral_mode="lanes"``: trace every g-point of a window in one
        batched photon loop instead of one after another; memory grows
        with the window (combine with ``gpt_per_dispatch`` on large
        domains).  ``seed``: g-point ``igpt`` traces the stream of
        ``seed + igpt``.
        """
        kd = self.kdist
        dtype = as_torch_dtype(torch.float32 if dtype is None else dtype)
        dev = kd.device
        if single_gpt is not None:
            # Reference --single-gpt: trace one g-point only (1-based).
            kd = kd.slice_gpt(single_gpt - 1, single_gpt)
        p = _host(p_lay)
        if not p[0, 0] > p[0, -1]:
            raise ValueError("RT solver expects the surface at layer 0")
        ncol, nlay = p.shape
        nz, ny, nx = grid_cells
        if ncol != ny * nx or nz > nlay:
            raise ValueError(f"grid_cells {tuple(grid_cells)} do not fit "
                             f"{ncol} columns x {nlay} layers")

        cast = lambda a: torch.as_tensor(_host(a), dtype=dtype, device=dev)
        vmr = cast(gas_concs.materialize(kd.gas_names, ncol, nlay,
                                         dtype=numpy_dtype(dtype)))
        if col_dry is None:
            col_dry = gas_ops.get_col_dry(
                cast(gas_concs.expand("h2o", ncol, nlay)), cast(p_lev))
        if tsi_scaling is None:
            tsi_scaling = np.ones(ncol)

        with_clouds = lwp is not None
        with_aerosols = aermr is not None
        zeros = torch.zeros((ncol, nlay), dtype=dtype, device=dev)
        with_mie = self.mie_cdf is not None
        mie_cdf = cast(self.mie_cdf) if with_mie else None
        mie_ang = cast(self.mie_ang) if with_mie else None
        args = (kd, self.cloud_lut, self.aerosol_lut, seed,
                cast(p_lay), cast(p_lev), cast(t_lay), vmr, cast(col_dry),
                cast(sfc_alb_dir), cast(sfc_alb_dif), cast(tsi_scaling),
                cast(mu0), cast(azi),
                cast(lwp) if with_clouds else zeros,
                cast(iwp) if with_clouds else zeros,
                cast(rel) if with_clouds else zeros,
                cast(dei) if with_clouds else zeros,
                cast(rh) if with_aerosols else zeros,
                cast(aermr) if with_aerosols else torch.zeros(
                    (ncol, nlay, 11), dtype=dtype, device=dev),
                tuple(float(d) for d in grid_d), mie_cdf, mie_ang)
        kw = dict(
            grid_cells=tuple(grid_cells), kn_grid=tuple(kn_grid),
            photons_per_pixel=photons_per_pixel,
            independent_column=independent_column, gpt_chunk=gpt_chunk,
            with_clouds=with_clouds, with_aerosols=with_aerosols,
            delta_cloud=delta_cloud, delta_aerosol=delta_aerosol,
            with_mie=with_mie, output_bnd_fluxes=output_bnd_fluxes,
            spectral_mode=spectral_mode, nbnd=self.kdist.nbnd)
        if gpt_per_dispatch is None or not raytracing:
            return _solve_rt_impl(*args, with_twostream=twostream,
                                  with_raytracing=raytracing, **kw)
        # Windows of W g-points: the two-stream pass runs once by itself,
        # the gas planes once for the full spectrum, then each window
        # chains the ray-traced accumulators.
        ts = (_solve_rt_impl(*args, with_twostream=True,
                             with_raytracing=False, **kw)
              if twostream else None)
        planes = _solve_rt_impl(*args, with_twostream=False,
                                with_raytracing=True,
                                return_gas_planes=True, **kw)
        W = min(gpt_per_dispatch, kd.ngpt)
        while kd.ngpt % W:
            W -= 1
        acc = None
        for s0 in range(0, kd.ngpt, W):
            acc = _solve_rt_impl(*args, s0, acc, planes,
                                 with_twostream=False, with_raytracing=True,
                                 scan_width=W, **kw)
        bnd_rt = acc[7:] if output_bnd_fluxes else (None,) * 5
        ts_f = ((ts.sw_flux_up, ts.sw_flux_dn, ts.sw_flux_dn_dir)
                if ts is not None else (None, None, None))
        bnd_ts = ((ts.sw_bnd_flux_up, ts.sw_bnd_flux_dn,
                   ts.sw_bnd_flux_dn_dir)
                  if ts is not None and output_bnd_fluxes
                  else (None, None, None))
        return RTFluxes(*acc[:7], *ts_f, *bnd_ts, *bnd_rt)
