"""Forward Monte-Carlo ray tracer (3D cloudy domains).

Port of ``rte_rrtmgp_tpu/models/raytracer.py``, the SIMD form of the
reference's null-collision (Woodcock) delta-tracking tracer
(``src_kernels_cuda_rt/raytracer_kernels.cu`` + ``src_cuda_rt/Raytracer.cu``):
one lane per photon, every lane stepped together, every event type
evaluated with masks.  The JAX package's ``lax.while_loop`` is a Python
loop over tensors here: each step is a few hundred small PyTorch ops on the
lanes of the current width phase, and the loop condition (any lane alive,
the compaction count, the ``max_steps`` fuse) is read on the host only
every :data:`CHECK_EVERY` steps, because each read waits for the card.  A
step after every lane has died changes no state and scores nothing, so the
cadence changes no result without compaction; with compaction it moves a
phase's end by at most ``CHECK_EVERY - 1`` steps.

Kept as in the JAX package: the flat accumulator of ``2*ncell*nz + 4*ncell``
entries, the analytic ``sfc_up = albedo * (dir + dif)`` when one g-point
owns the accumulator (G == 1), the respawn modes (fifo default, arith,
pool), staged width compaction, the knull grid, the int32 range guard, and
the order and shapes of the uniform draws: ``(5, n_lanes)`` (``(5,
n_photons)`` in pool mode) at launch, then ``(11, width)`` (6 in pool mode)
every step.  Every uniform comes from :func:`_uniform` on the stream
:func:`_generator` makes from a seed (the JAX package's key).

Dropped, since they change no value: the one-hot small-table lookup (plain
indexing here) and the optimization barrier.  Indices are int64 (PyTorch's
index ops), the int32 guard stays as a behaviour check.  Scoring uses
``index_add_``; on the card its float atomics sum in no fixed order, so two
card runs agree statistically, not bit for bit.

Physics as the reference: Iwabuchi 2006 absorption weighting with Russian
roulette at w < 0.5, Rayleigh / Henyey-Greenstein / Mie-LUT phase sampling,
Lambertian surface, cyclic x/y boundaries, independent-column mode, photon
kinds (direct/diffuse) split by the two-stream TOD fluxes.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config

W_THRES = 0.5      # Russian-roulette threshold (raytracer_kernels.cu:11)
CHECK_EVERY = 8    # steps between host reads of the loop condition


def _generator(seed: int, device) -> torch.Generator:
    """The random stream of one trace, from its seed."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _uniform(gen, shape, dtype, device) -> torch.Tensor:
    """Every uniform the tracer draws comes from here, in the JAX
    package's order and shapes."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _resolve_respawn_mode(mode: str, device) -> str:
    """``"auto"`` -> ``RTE_RRTMGP_RT_RESPAWN`` > the tuned ``rt_trace``
    winner for ``device``'s kind (``tuning/tune_rt.py``) > ``"fifo"``."""
    if mode != "auto":
        return mode
    env = os.environ.get("RTE_RRTMGP_RT_RESPAWN")
    if env:
        return env
    from ..utils import tuner

    tuned = tuner.best_workload_opts("rt_trace", device) or {}
    return tuned.get("respawn_mode") or "fifo"


class RaytracerOutput(NamedTuple):
    flux_toa_down: object   # (ny, nx) W m-2
    flux_tod_up: object
    flux_sfc_dir: object
    flux_sfc_dif: object
    flux_sfc_up: object
    flux_abs_dir: object    # (nz, ny, nx) W m-3
    flux_abs_dif: object


def _coarse_reduce_axis(a, axis: int, k: int, reduce: str):
    """Reduce a fine axis of length n onto k coarse cells, where each fine
    cell contributes to every coarse cell it geometrically overlaps (the
    reference's overlapping-range loop, Raytracer.cu:55-73).  ``reduce``:
    ``"amax"`` or ``"amin"``."""
    n = a.shape[axis]
    if k > n:
        raise ValueError(f"coarse grid of {k} cells on a fine axis of {n}")
    i = torch.arange(n, device=a.device)
    a2 = a.movedim(axis, 0)
    parts = []
    for ids in ((i * k) // n, torch.clamp(((i + 1) * k - 1) // n, max=k - 1)):
        idx = ids.view((n,) + (1,) * (a2.dim() - 1)).expand_as(a2)
        parts.append(a2.new_zeros((k,) + a2.shape[1:]).scatter_reduce_(
            0, idx, a2, reduce, include_self=False))
    out = (torch.maximum if reduce == "amax" else torch.minimum)(*parts)
    return out.movedim(0, axis)


def coarse_grid_reduce(k_ext, kn_shape, reduce: str = "amax"):
    out = k_ext
    for axis, k in enumerate(kn_shape):
        out = _coarse_reduce_axis(out, axis, k, reduce)
    return out


def create_knull_grid(k_ext, kn_shape, k_ext_null_min=1e-3):
    """Max-k acceleration grid (Raytracer.cu:40-75).  k_ext: (nz, ny, nx);
    kn_shape: (knz, kny, knx) coarse dims (any sizes <= the fine grid)."""
    return torch.clamp(coarse_grid_reduce(k_ext, kn_shape, "amax"),
                       min=k_ext_null_min)


def _rayleigh_sample(u):
    """Analytic inverse CDF of the Rayleigh phase function
    (raytracer_functions.h:72-78).  The cube root's argument
    -q + sqrt(1 + q^2) is always positive."""
    q = 4.0 * u - 2.0
    d = 1.0 + q * q
    cbrt = torch.pow(-q + torch.sqrt(d), 1.0 / 3.0)
    return cbrt - 1.0 / cbrt


def _henyey_sample(g, u):
    """Henyey-Greenstein inverse CDF (raytracer_functions.h:81-87)."""
    a = (1.0 - g * g) ** 2
    b = 2.0 * g * (2.0 * u * g + 1.0 - g) ** 2
    c = -g / 2.0 - 1.0 / (2.0 * g)
    return -(a / b) - c


def _mie_sample(mie_cdf, mie_ang, u, r_eff):
    """Mie scattering angle from cdf+angle LUTs
    (raytracer_functions.h:109-125).  mie_cdf: (n_mie,) descending;
    mie_ang: (n_re, n_mie).  Or, for B traces whose lanes are B equal
    consecutive segments of ``u``: (B, n_mie) and (B, n_re, n_mie).
    Returns cos(theta)."""
    batched = mie_cdf.dim() == 2
    cdf = mie_cdf if batched else mie_cdf[None]
    ang = (mie_ang if batched else mie_ang[None]).reshape(cdf.shape[0], -1)
    B, n_mie = cdf.shape
    n_re = ang.shape[1] // n_mie
    u2, re2 = u.reshape(B, -1), r_eff.reshape(B, -1)
    r_idx = torch.clamp((re2 - 2.5).to(torch.int64), 0, n_re - 2)
    r_rest = torch.remainder(re2 - 2.5, 1.0)
    # mie_cdf is descending; find i with cdf[i] >= u > cdf[i+1].
    i = torch.clamp(torch.searchsorted(-cdf, -u2, right=True) - 1,
                    0, n_mie - 2)
    c0 = cdf.gather(1, i)
    c1 = cdf.gather(1, i + 1)
    dr = torch.abs(c1 - c0)
    w0 = torch.abs(u2 - c1) / torch.clamp(dr, min=1e-30)
    w1 = torch.abs(c0 - u2) / torch.clamp(dr, min=1e-30)
    at = lambda r, j: ang.gather(1, r * n_mie + j)
    ang_lwr = w0 * at(r_idx, i) + w1 * at(r_idx, i + 1)
    ang_upr = w0 * at(r_idx + 1, i) + w1 * at(r_idx + 1, i + 1)
    return torch.cos(ang_lwr * (1.0 - r_rest)
                     + ang_upr * r_rest).reshape(u.shape)


def _mie_phase_value(mie_phase_ang, mie_phase, scat_ang, r_eff):
    """Mie phase-function VALUE at scattering angle ``scat_ang`` (radians)
    — the next-event-estimation weight (mie_interpolate_phase_table,
    raytracer_functions.h:128-147).  ``mie_phase_ang``: (n_ang,) equally
    spaced angles 0..pi; ``mie_phase``: (n_re, n_ang) phase values per
    effective radius (r_eff grid 2.5..2.5+n_re-1 um, like the cdf tables).
    Or, for B traces whose lanes are B equal consecutive segments of
    ``scat_ang``: ``mie_phase`` (B, n_re, n_ang).  Returns phase per
    steradian."""
    n_re, n_ang = mie_phase.shape[-2:]
    r_idx = torch.clamp((r_eff - 2.5).to(torch.int64), 0, n_re - 2)
    r_rest = torch.remainder(r_eff - 2.5, 1.0)
    d_ang = mie_phase_ang[1] - mie_phase_ang[0]     # uniform grid spacing
    i = torch.clamp((scat_ang / d_ang).to(torch.int64), 0, n_ang - 2)
    a0 = mie_phase_ang[i]
    a1 = mie_phase_ang[i + 1]
    dr = torch.clamp(torch.abs(a1 - a0), min=1e-30)
    w0 = torch.abs(scat_ang - a1) / dr
    w1 = torch.abs(a0 - scat_ang) / dr
    if mie_phase.dim() == 3:
        # Row r of trace b is row b * n_re + r of the stacked tables.
        B = mie_phase.shape[0]
        r_idx = r_idx + (torch.arange(B, device=r_idx.device) * n_re
                         ).repeat_interleave(r_idx.shape[0] // B)
        mie_phase = mie_phase.reshape(B * n_re, n_ang)
    p_lwr = w0 * mie_phase[r_idx, i] + w1 * mie_phase[r_idx, i + 1]
    p_upr = w0 * mie_phase[r_idx + 1, i] + w1 * mie_phase[r_idx + 1, i + 1]
    return p_lwr * (1.0 - r_rest) + p_upr * r_rest


def _scatter_direction(direction, cos_scat, u_phi):
    """Rotate ``direction`` by scattering angle with random azimuth
    (raytracer_kernels.cu:385-404).  direction: (N, 3)."""
    dtype = direction.dtype
    eps = config.eps(dtype)
    sin_scat = torch.clamp(torch.sqrt(1.0 - cos_scat ** 2 + eps), min=0.0)

    a = torch.abs(direction)
    # Pick the smallest component as the helper axis.
    use_x = (a[:, 0] < a[:, 1]) & (a[:, 0] < a[:, 2])
    use_y = (~use_x) & (a[:, 1] < a[:, 2])
    t1 = torch.stack([use_x, use_y, ~(use_x | use_y)], dim=1).to(dtype)
    proj = torch.sum(t1 * direction, dim=1, keepdim=True)
    t1 = t1 - direction * proj
    t1 = t1 / torch.sqrt(torch.sum(t1 * t1, dim=1, keepdim=True))
    t2 = torch.linalg.cross(direction, t1, dim=1)

    phi = 2.0 * math.pi * u_phi
    return (cos_scat[:, None] * direction
            + sin_scat[:, None] * (torch.sin(phi)[:, None] * t1
                                   + torch.cos(phi)[:, None] * t2))


def _tensor(a, dtype, device):
    return torch.as_tensor(a, dtype=dtype, device=device)


def trace_rays(seed,
               k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer,
               r_eff, surface_albedo, kn_grid_shape,
               grid_d, tod_inc_direct, tod_inc_diffuse, sun_direction,
               photons_per_pixel: int,
               independent_column: bool = False,
               mie_cdf=None, mie_ang=None,
               max_steps: int = 50_000,
               k_ext_null_min: float = 1e-3,
               photons_per_lane: Optional[int] = None,
               compact: bool = True,
               compact_floor: int = 128,
               respawn_mode: str = "fifo",
               return_aux: bool = False):
    """Trace one spectral band/g-point through a 3D domain.

    All 3D fields are (nz, ny, nx) tensors with z the vertical (index 0 at
    the surface); ``surface_albedo``: (ny, nx); ``grid_d``: (dz, dy, dx)
    cell sizes in m; ``sun_direction``: unit vector with negative z
    (downward).  ``tod_inc_direct/diffuse``: W m-2 entering the domain top.
    ``seed`` makes the trace's random stream (the JAX package's key).
    Runs on ``k_ext``'s device in its dtype.

    ``photons_per_lane``: each lane traces this many photons in turn,
    respawning as soon as its current photon dies.  Default: the largest
    quota (<= 8) that keeps >= 32k lanes in flight.

    Returns fluxes in W m-2 (2D) / W m-3 (3D absorption); with
    ``return_aux`` also a dict of loop counts (steps, phase widths and
    steps, lanes, quota) and the host ms of each width phase.
    """
    out, aux = _trace_impl(
        [seed], *(a[None, None] for a in (k_ext, k_sca_gas, k_sca_cld,
                                          k_sca_aer, asy_cld, asy_aer)),
        r_eff, surface_albedo[None, None], kn_grid_shape, grid_d,
        _tensor(tod_inc_direct, k_ext.dtype, k_ext.device).reshape(1, 1),
        _tensor(tod_inc_diffuse, k_ext.dtype, k_ext.device).reshape(1, 1),
        sun_direction, photons_per_pixel=photons_per_pixel,
        independent_column=independent_column,
        mie_cdf=None if mie_cdf is None else mie_cdf[None],
        mie_ang=None if mie_ang is None else mie_ang[None],
        max_steps=max_steps, k_ext_null_min=k_ext_null_min,
        photons_per_lane=photons_per_lane, compact=compact,
        compact_floor=compact_floor, respawn_mode=respawn_mode)
    out = RaytracerOutput(*(f[0] for f in out))
    return (out, aux) if return_aux else out


def trace_rays_pooled(seed,
                      k_ext, k_sca_gas, k_sca_cld, k_sca_aer,
                      asy_cld, asy_aer,
                      r_eff, surface_albedo, kn_grid_shape,
                      grid_d, tod_inc_direct, tod_inc_diffuse,
                      sun_direction,
                      photons_per_pixel: int,
                      independent_column: bool = False,
                      mie_cdf=None, mie_ang=None,
                      max_steps: int = 200_000,
                      k_ext_null_min: float = 1e-3,
                      photons_per_lane: Optional[int] = None,
                      compact: bool = True,
                      compact_floor: int = 128,
                      respawn_mode: str = "fifo",
                      return_aux: bool = False):
    """Trace a WINDOW of G g-points in ONE photon loop (spectral pooling).

    All optics fields carry a leading spectral axis: ``k_*``/``asy_*``
    are (G, nz, ny, nx), ``surface_albedo`` (G, ny, nx),
    ``tod_inc_direct/diffuse`` (G,).  ``r_eff`` stays (nz, ny, nx).
    ``mie_cdf``/``mie_ang`` are the single band's tables (a pooled window
    with Mie must not cross a band boundary).  Lanes respawn into the next
    g-point's photons the moment theirs die, so the long-walk tail is paid
    once per window; each deposit is scaled by its g-point's W m-2 per
    photon, so the output holds the window's summed fluxes.
    """
    dtype, dev = k_ext.dtype, k_ext.device
    out, aux = _trace_impl(
        [seed], *(a[None] for a in (k_ext, k_sca_gas, k_sca_cld, k_sca_aer,
                                    asy_cld, asy_aer)),
        r_eff, surface_albedo[None], kn_grid_shape, grid_d,
        _tensor(tod_inc_direct, dtype, dev).reshape(1, -1),
        _tensor(tod_inc_diffuse, dtype, dev).reshape(1, -1),
        sun_direction, photons_per_pixel=photons_per_pixel,
        independent_column=independent_column,
        mie_cdf=None if mie_cdf is None else mie_cdf[None],
        mie_ang=None if mie_ang is None else mie_ang[None],
        max_steps=max_steps, k_ext_null_min=k_ext_null_min,
        photons_per_lane=photons_per_lane, compact=compact,
        compact_floor=compact_floor, respawn_mode=respawn_mode)
    out = RaytracerOutput(*(f[0] for f in out))
    return (out, aux) if return_aux else out


def trace_rays_batched(seeds,
                       k_ext, k_sca_gas, k_sca_cld, k_sca_aer,
                       asy_cld, asy_aer,
                       r_eff, surface_albedo, kn_grid_shape,
                       grid_d, tod_inc_direct, tod_inc_diffuse,
                       sun_direction,
                       photons_per_pixel: int,
                       independent_column: bool = False,
                       mie_cdf=None, mie_ang=None,
                       max_steps: int = 50_000,
                       k_ext_null_min: float = 1e-3,
                       photons_per_lane: Optional[int] = None,
                       compact: bool = True,
                       compact_floor: int = 128,
                       respawn_mode: str = "fifo",
                       return_aux: bool = False):
    """B independent single-g-point traces in ONE batched photon loop (the
    JAX package's ``jax.vmap(trace_rays)``, the solver's ``lanes`` mode).

    Fields carry a leading batch axis: ``k_*``/``asy_*`` (B, nz, ny, nx),
    ``surface_albedo`` (B, ny, nx), ``tod_inc_*`` (B,), ``mie_cdf`` (B,
    n_mie) and ``mie_ang`` (B, n_re, n_mie); ``r_eff`` (nz, ny, nx) is
    shared; ``seeds`` has one seed a trace.  Each trace draws from its own
    stream and stops when its own loop condition fails, so each equals
    :func:`trace_rays` on its inputs up to accumulation order.  Returns a
    :class:`RaytracerOutput` of (B, ...) fields.
    """
    dtype, dev = k_ext.dtype, k_ext.device
    out, aux = _trace_impl(
        list(seeds), *(a[:, None] for a in (k_ext, k_sca_gas, k_sca_cld,
                                            k_sca_aer, asy_cld, asy_aer)),
        r_eff, surface_albedo[:, None], kn_grid_shape, grid_d,
        _tensor(tod_inc_direct, dtype, dev).reshape(-1, 1),
        _tensor(tod_inc_diffuse, dtype, dev).reshape(-1, 1),
        sun_direction, photons_per_pixel=photons_per_pixel,
        independent_column=independent_column, mie_cdf=mie_cdf,
        mie_ang=mie_ang, max_steps=max_steps,
        k_ext_null_min=k_ext_null_min, photons_per_lane=photons_per_lane,
        compact=compact, compact_floor=compact_floor,
        respawn_mode=respawn_mode)
    out = RaytracerOutput(*out)
    return (out, aux) if return_aux else out


def _trace_impl(seeds,
                k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer,
                r_eff, surface_albedo, kn_grid_shape,
                grid_d, tod_inc_direct, tod_inc_diffuse, sun_direction,
                photons_per_pixel: int,
                independent_column: bool,
                mie_cdf, mie_ang, max_steps: int,
                k_ext_null_min: float,
                photons_per_lane,
                compact: bool, compact_floor: int,
                respawn_mode: str):
    """Shared tracer core: B traces of G pooled g-points each.  Fields are
    (B, G, nz, ny, nx), albedo (B, G, ny, nx), incident fluxes (B, G), Mie
    tables (B, n_mie) / (B, n_re, n_mie).  The B traces' lanes are B equal
    consecutive segments of one lane axis; a lane of trace b and g-point
    g reads row block b*G + g of the stacked tables.  Returns the seven
    output fields, each with a leading B axis, and the aux dict."""
    dtype, dev = k_ext.dtype, k_ext.device
    respawn_mode = _resolve_respawn_mode(respawn_mode, dev)
    if respawn_mode not in ("fifo", "arith", "pool"):
        raise ValueError(f"unknown respawn_mode {respawn_mode!r}; "
                         "expected 'fifo', 'arith', 'pool', or 'auto'")
    ft = np.float32 if dtype == torch.float32 else np.float64
    eps = config.eps(dtype)
    B, G, nz, ny, nx = k_ext.shape
    BG = B * G
    ncell = ny * nx
    ncol = ncell * nz                       # cells per g-point
    n_photons_g = ncell * photons_per_pixel
    n_photons = G * n_photons_g
    acc_len = 2 * ncell * nz + 4 * ncell
    # Photon ids and flat accumulator indices are int32 in the JAX package
    # (TPU gathers and scatters want 32-bit indices); the same range guard.
    if n_photons >= 2 ** 31 or acc_len >= 2 ** 31:
        raise ValueError(
            f"photon pool too large for int32 ids: G={G} ncell={ncell} "
            f"ppp={photons_per_pixel} -> n_photons={n_photons}")
    if photons_per_lane is None:
        if G == 1:
            photons_per_lane = max(1, min(8, photons_per_pixel,
                                          n_photons // 32768))
        else:
            photons_per_lane = max(1, n_photons // 32768)
    while n_photons % photons_per_lane:
        photons_per_lane -= 1
    ppl = photons_per_lane
    n_lanes = n_photons // ppl
    # Scalars rounded in the working dtype, as the JAX package computes them.
    dz, dy, dx = (ft(v) for v in grid_d)
    size_z, size_y, size_x = ft(nz) * dz, ft(ny) * dy, ft(nx) * dx
    s_min = float(max(size_z, size_y, size_x) * ft(eps))
    knz, kny, knx = kn_grid_shape
    kn_ncell = knz * kny * knx
    kn_dz, kn_dy, kn_dx = (float(size_z / ft(knz)), float(size_y / ft(kny)),
                           float(size_x / ft(knx)))
    dz, dy, dx = float(dz), float(dy), float(dx)
    size_z, size_y, size_x = float(size_z), float(size_y), float(size_x)

    knull_flat = torch.stack([
        create_knull_grid(k, kn_grid_shape, k_ext_null_min)
        for k in k_ext.reshape(BG, nz, ny, nx)]).reshape(-1)  # (BG*kn_ncell,)
    sun_direction = _tensor(sun_direction, dtype, dev)
    tod_dir = tod_inc_direct.reshape(BG)
    tod_dif = tod_inc_diffuse.reshape(BG)
    diff_frac = tod_dif / torch.clamp(tod_dir + tod_dif, min=eps)
    # W m-2 credited per photon of each g-point; deposits are scaled by
    # this at scatter time so pooled windows share one accumulator.
    flux_per_ray = (tod_dir + tod_dif) / photons_per_pixel      # (BG,)

    # One packed row per cell: a single row gather a step.  The 8th slot
    # carries the COLUMN's surface albedo (the crossing and collision
    # branches are disjoint per lane, so the merged gather serves both).
    reff_col = (_tensor(r_eff, dtype, dev).reshape(-1) if r_eff is not None
                else torch.zeros(ncol, dtype=dtype, device=dev))
    alb = surface_albedo.reshape(BG, ncell).to(dtype)
    fields = torch.stack([
        k_ext.reshape(BG, ncol), k_sca_gas.reshape(BG, ncol),
        k_sca_cld.reshape(BG, ncol), k_sca_aer.reshape(BG, ncol),
        asy_cld.reshape(BG, ncol), asy_aer.reshape(BG, ncol),
        reff_col.expand(BG, ncol), alb.repeat(1, nz)],
        dim=2).reshape(BG * ncol, 8)
    use_mie = mie_cdf is not None
    fifo = respawn_mode == "fifo"
    i64 = torch.int64

    def lane_layout(width):
        """Per-lane trace index (None for one trace)."""
        if B == 1:
            return None
        return torch.arange(B, device=dev).repeat_interleave(width)

    def launch_state(pid, u5row, bid):
        """Stratified launch state for photon ids ``pid`` (of the lanes'
        traces ``bid``) from 5 uniforms (rows of shape pid.shape)."""
        g = pid // n_photons_g
        pix = pid % ncell
        px = (pix % nx).to(dtype)
        py = (pix // nx).to(dtype)
        lpos = torch.stack([(px + u5row[0]) * dx, (py + u5row[1]) * dy,
                            torch.full(pid.shape, size_z - s_min, dtype=dtype,
                                       device=dev)], dim=1)
        tg = g if bid is None else bid * G + g
        ldirect = u5row[2] >= (diff_frac[0] if BG == 1 else diff_frac[tg])
        mu_s = torch.sqrt(u5row[3])
        az_s = 2.0 * math.pi * u5row[4]
        dif_dir = torch.stack([mu_s * torch.sin(az_s), mu_s * torch.cos(az_s),
                               -torch.sqrt(1.0 - mu_s ** 2 + eps)], dim=1)
        ldir = torch.where(ldirect[:, None], sun_direction[None, :], dif_dir)
        return lpos, ldir, ldirect, g

    gens = [_generator(s, dev) for s in seeds]

    def draw(rows, width, active=None):
        return torch.cat([
            _uniform(gen, (rows, width), dtype, dev)
            if active is None or active[b]
            else torch.zeros((rows, width), dtype=dtype, device=dev)
            for b, gen in enumerate(gens)], dim=1)

    # Launch state.  Every photon id in [0, n_photons) of each trace is
    # launched exactly once, so toa_down is credited in full up front.
    # Pool order is g-major: pid -> g = pid // n_photons_g, pixel = pid % ncell.
    n0 = n_photons if respawn_mode == "pool" else n_lanes
    u5 = draw(5, n0)
    pid0 = torch.arange(n0, device=dev).repeat(B)
    pool_pos, pool_dir, pool_direct, g0 = launch_state(pid0, u5,
                                                       lane_layout(n0))
    pool = None
    if respawn_mode == "pool":
        pool = torch.cat([pool_pos, pool_dir, pool_direct[:, None].to(dtype)],
                         dim=1)                                 # (B*n_photons, 7)
        first = (torch.arange(B, device=dev)[:, None] * n_photons
                 + torch.arange(n_lanes, device=dev)[None, :]).reshape(-1)
        pool_pos, pool_dir = pool_pos[first], pool_dir[first]
        pool_direct, g0 = pool_direct[first], g0[first]
    N = B * n_lanes
    state = dict(
        pos=pool_pos, direction=pool_dir,
        weight=torch.ones(N, dtype=dtype, device=dev),
        is_direct=pool_direct,
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        tau=torch.zeros(N, dtype=dtype, device=dev),
        d_max=torch.zeros(N, dtype=dtype, device=dev),
        k_null=torch.ones(N, dtype=dtype, device=dev),
        transition=torch.zeros(N, dtype=torch.bool, device=dev),
        gid=g0)
    if not fifo:
        state["count"] = torch.zeros(N, dtype=i64, device=dev)
        state["lane_id"] = torch.arange(n_lanes, device=dev).repeat(B)
    pid_all = torch.arange(n_photons, device=dev)
    per_photon = flux_per_ray.reshape(B, G)[:, pid_all // n_photons_g]
    toa_down = torch.zeros((B, ncell), dtype=dtype, device=dev).index_add_(
        1, pid_all % ncell, per_photon)
    # One packed FLAT accumulator a trace: entries 2*r+c for cell rows r in
    # [0, ncell*nz) with c = (0 absorb_dir, 1 absorb_dif), then a per-pixel
    # block at offset 2*ncell*nz with 4 channels (0 tod_up, 1 sfc_dir,
    # 2 sfc_dif, 3 sfc_up).
    acc = torch.zeros(B * acc_len, dtype=dtype, device=dev)
    next_pid = torch.full((B,), n_lanes, dtype=i64, device=dev)
    sfc0 = 2 * ncell * nz
    n_rows = 6 if respawn_mode == "pool" else 11
    static = (n_lanes == n_photons) if fifo else (ppl == 1)
    mie_b = mie_cdf is not None and mie_cdf.shape[0] > 1

    # 0-d constants: a Python scalar in torch.where is wrapped and cast on
    # every call.
    const = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    ZERO, ONE, EPS, G_MIN = const(0.0), const(1.0), const(eps), const(1e-4)
    NUDGE_UP, NUDGE_DN = const(s_min), const(-s_min)
    # The x, y and z axes at once, as (3,) rows against (N, 3) positions:
    # the knull cell size and count, the grid cell size and count, and the
    # flat-index strides (the same elementwise values as one axis at a
    # time, in a third of the launches).
    KN_D, CELL_D = const([kn_dx, kn_dy, kn_dz]), const([dx, dy, dz])
    SIZE_XY = const([size_x, size_y])
    i64_row = lambda v: torch.tensor(v, dtype=i64, device=dev)
    KN_MAX, CELL_MAX = i64_row([knx - 1, kny - 1, knz - 1]), \
        i64_row([nx - 1, ny - 1, nz - 1])
    KN_STRIDE, CELL_STRIDE = i64_row([1, knx, kny * knx]), \
        i64_row([1, nx, ny * nx])
    # Scatter types no cell has never win the type draw (sr >= 0): their
    # phase samples are skipped, which changes no value.
    has_aer = bool((k_sca_aer > 0).any())
    has_cld = bool((k_sca_cld > 0).any())

    def cell_index(p, d, nmax):
        """(N, k) positions -> (N, k) cell indices, each axis clipped."""
        return torch.minimum(torch.clamp((p / d).to(i64), min=0), nmax)

    def body(st, u, bid, lane_on, next_pid):
        """One step of every lane.  ``bid``: each lane's trace (None for one
        trace); ``lane_on``: lanes whose trace steps (None: all)."""
        pos, direction, alive = st["pos"], st["direction"], st["alive"]
        width = alive.shape[0] // B
        tg = None
        if BG > 1:
            tg = st["gid"] if bid is None else bid * G + st["gid"]

        # 1. (re)establish knull cell + distance to its boundary.
        need_grid = st["d_max"] == 0.0
        ijk3 = cell_index(pos, KN_D, KN_MAX)                  # (i, j, k)
        lo3 = ijk3.to(dtype) * KN_D
        hi3 = (ijk3 + 1).to(dtype) * KN_D
        s3 = torch.abs(torch.where(direction > 0, hi3 - pos, lo3 - pos)
                       / torch.where(direction == 0, EPS, direction))
        d_new = s3[:, 2] if independent_column else torch.minimum(
            s3[:, 0], torch.minimum(s3[:, 1], s3[:, 2]))
        ijk_n = (ijk3 * KN_STRIDE).sum(dim=1)
        if tg is not None:
            ijk_n = ijk_n + tg * kn_ncell
        d_max = torch.where(need_grid, d_new, st["d_max"])
        k_null = torch.where(need_grid, knull_flat[ijk_n], st["k_null"])

        # 2. sample tau unless resuming across a cell boundary.
        tau_sampled = -torch.log(1.0 - u[0] + eps)
        tau = torch.where(st["transition"], st["tau"], tau_sampled)
        dn = torch.clamp(tau / k_null, min=eps)
        crossing = dn >= d_max

        # ---- crossing branch: advance to the cell boundary ----
        step_len = s_min + d_max
        if independent_column:
            zero = torch.zeros_like(step_len)
            adv = torch.stack([zero, zero, direction[:, 2] * step_len], dim=1)
        else:
            adv = direction * step_len[:, None]
        pos_cross = pos + adv
        hit_sfc = pos_cross[:, 2] < eps
        hit_tod = pos_cross[:, 2] >= size_z
        pix_s = (cell_index(pos_cross[:, :2], CELL_D[:2], CELL_MAX[:2])
                 * CELL_STRIDE[:2]).sum(dim=1)
        m_cross = alive & crossing
        m_sfc = m_cross & hit_sfc
        m_tod = m_cross & hit_tod & ~hit_sfc
        m_pass = m_cross & ~hit_sfc & ~hit_tod

        # Lambertian reflection for surviving surface hits.
        mu_r = torch.sqrt(u[3])
        az_r = 2.0 * math.pi * u[4]
        refl_dir = torch.stack([mu_r * torch.sin(az_r), mu_r * torch.cos(az_r),
                                torch.sqrt(1.0 - mu_r ** 2 + eps)], dim=1)

        # cell-boundary pass: nudge, cyclic BCs, keep remaining tau.
        nudge = torch.where(direction > 0, NUDGE_UP, NUDGE_DN)
        if independent_column:
            zero = torch.zeros_like(nudge[:, 2])
            nudge = torch.stack([zero, zero, nudge[:, 2]], dim=1)
        pos_pass = pos_cross + nudge
        pos_pass = torch.cat([torch.remainder(pos_pass[:, :2], SIZE_XY),
                              pos_pass[:, 2:]], dim=1)
        tau_pass = tau - d_max * k_null

        # ---- collision branch: move dn inside the knull cell ----
        move = direction * dn[:, None]
        if independent_column:
            move = torch.cat([torch.zeros_like(move[:, :2]), move[:, 2:]], 1)
        # clamp into the current knull cell (kernel :317-325)
        pos_col = torch.minimum(torch.maximum(pos + move, lo3 + s_min),
                                hi3 - s_min)
        if independent_column:
            pos_col = torch.cat([pos[:, :2], pos_col[:, 2:]], dim=1)
        ijk = (cell_index(pos_col, CELL_D, CELL_MAX) * CELL_STRIDE).sum(dim=1)

        # ONE merged row gather for both branches (disjoint per lane).
        idx = torch.where(crossing, pix_s, ijk)
        cell = fields[idx if tg is None else idx + tg * ncol]    # (N, 8)
        k_here = cell[:, 0]
        ksca_c = cell[:, 2]
        ksca_a = cell[:, 3]
        k_sca_tot = cell[:, 1] + ksca_c + ksca_a
        ssa_tot = k_sca_tot / torch.clamp(k_here, min=eps)
        f_no_abs = 1.0 - (1.0 - ssa_tot) * (k_here / k_null)

        w = st["weight"]
        m_col = alive & ~crossing
        w_abs = w * (1.0 - f_no_abs)
        w_sfc = w * cell[:, 7]

        # Flat single-element scoring: each lane's event writes exactly one
        # primary channel, scaled by its g-point's flux per photon.  With
        # one g-point per accumulator sfc_up is albedo * (dir + dif) after
        # the loop; pooled windows keep the explicit second deposit.
        scale = flux_per_ray[0] if tg is None else flux_per_ray[tg]
        dir_off = (~st["is_direct"]).to(i64)
        idx_a = torch.where(
            m_col, 2 * idx + dir_off,
            sfc0 + 4 * pix_s + (1 + dir_off) * ~m_tod)
        val_a = scale * torch.where(m_col, w_abs,
                                    torch.where(m_tod | m_sfc, w, ZERO))
        if lane_on is not None:
            val_a = torch.where(lane_on, val_a, ZERO)
        if bid is not None:
            idx_a = idx_a + bid * acc_len
        acc.index_add_(0, idx_a, val_a)
        if G > 1:
            idx_b = sfc0 + 4 * pix_s + 3
            val_b = scale * torch.where(m_sfc, w_sfc, ZERO)
            if lane_on is not None:
                val_b = torch.where(lane_on, val_b, ZERO)
            if bid is not None:
                idx_b = idx_b + bid * acc_len
            acc.index_add_(0, idx_b, val_b)

        # Russian roulette after surface reflection.
        w_after = torch.where(m_sfc, w_sfc, w)
        roulette = m_sfc & (w_after < W_THRES)
        w_after = torch.where(roulette, torch.where(u[1] > w_after, ZERO, ONE),
                              w_after)
        sfc_alive = m_sfc & (w_after > 0.0)

        w_col = w * f_no_abs
        roulette_c = m_col & (w_col < W_THRES)
        w_col = torch.where(roulette_c, torch.where(u[1] > w_col, ZERO, ONE),
                            w_col)
        col_alive = m_col & (w_col > 0.0)

        # null collision vs scattering (kernel :345-352)
        p_scat = ssa_tot / (ssa_tot - 1.0
                            + k_null / torch.clamp(k_here, min=eps))
        is_null = u[2] >= p_scat
        m_scat = col_alive & ~is_null

        # scatter type: 0 gas (Rayleigh), 1 cloud (Mie/HG), 2 aerosol (HG)
        sr = u[3] * torch.clamp(k_sca_tot, min=eps)
        cos_scat = _rayleigh_sample(u[4])
        if has_cld:
            if use_mie:
                cos_cld = _mie_sample(mie_cdf if mie_b else mie_cdf[0],
                                      mie_ang if mie_b else mie_ang[0], u[4],
                                      cell[:, 6])
            else:
                g_cld = torch.clamp(cell[:, 4], max=1.0 - eps)
                cos_cld = _henyey_sample(
                    torch.where(torch.abs(g_cld) < 1e-4, G_MIN, g_cld), u[4])
            cos_scat = torch.where(sr < ksca_a + ksca_c, cos_cld, cos_scat)
        if has_aer:
            g_aer = torch.clamp(cell[:, 5], max=1.0 - eps)
            cos_aer = _henyey_sample(
                torch.where(torch.abs(g_aer) < 1e-4, G_MIN, g_aer), u[4])
            cos_scat = torch.where(sr < ksca_a, cos_aer, cos_scat)
        cos_scat = torch.clamp(cos_scat, -1.0, 1.0)
        scat_dir = _scatter_direction(direction, cos_scat, u[5])

        # ---- merge all branches into the next state ----
        pos_sfc = torch.cat([pos_cross[:, :2],
                             torch.full_like(pos_cross[:, 2:], eps)], dim=1)
        new_pos = torch.where(m_col[:, None], pos_col,
                              torch.where(m_sfc[:, None], pos_sfc,
                                          torch.where(m_pass[:, None],
                                                      pos_pass, pos)))
        new_dir = torch.where(sfc_alive[:, None], refl_dir,
                              torch.where(m_scat[:, None], scat_dir,
                                          direction))
        new_weight = torch.where(m_sfc, w_after, torch.where(m_col, w_col, w))
        new_direct = st["is_direct"] & ~sfc_alive & ~m_scat
        died = (m_sfc & ~sfc_alive) | m_tod | (m_col & ~col_alive)
        new_alive = alive & ~died

        # d_max bookkeeping: reset on scatter/surface/tod; decrement on null.
        null_continue = col_alive & is_null
        new_dmax = torch.where(
            null_continue, d_max - dn,
            torch.where(m_pass | m_scat | m_sfc | m_tod, ZERO, d_max))
        new_dmax = torch.where(m_col & ~null_continue, ZERO, new_dmax)
        new_trans = m_pass
        new_tau = torch.where(m_pass, tau_pass, tau)
        new = dict(st, pos=new_pos, direction=new_dir, weight=new_weight,
                   is_direct=new_direct, alive=new_alive, tau=new_tau,
                   d_max=new_dmax, k_null=k_null, transition=new_trans)
        new_next = next_pid

        # ---- respawn: a lane whose photon died launches its next photon.
        # Static no-respawn path when every photon already has a lane; the
        # draw shapes are the same either way.
        if not static:
            if fifo:
                # Global photon queue: dying lanes take the next queue ids
                # in lane order (per-trace counter + inclusive cumsum rank).
                dying = alive & ~new_alive
                d2 = dying.view(B, width)
                rank = (torch.cumsum(d2, dim=1) - 1).reshape(-1)
                base = next_pid[0] if bid is None else next_pid[bid]
                respawn = dying & (base + rank < n_photons)
                pid = torch.clamp(base + torch.clamp(rank, min=0),
                                  max=n_photons - 1)
                new_next = torch.clamp(next_pid + d2.sum(dim=1),
                                       max=n_photons)
                lpos, ldir, ldirect, lgid = launch_state(pid, u[6:11], bid)
            else:
                respawn = alive & ~new_alive & (st["count"] < ppl - 1)
                new["count"] = torch.where(respawn, st["count"] + 1,
                                           st["count"])
                pid = st["lane_id"] + n_lanes * new["count"]
                if respawn_mode == "pool":
                    launch = pool[pid if bid is None
                                  else pid + bid * n_photons]
                    lpos, ldir = launch[:, 0:3], launch[:, 3:6]
                    ldirect = launch[:, 6] > 0.5
                    lgid = pid // n_photons_g
                else:
                    lpos, ldir, ldirect, lgid = launch_state(pid, u[6:11],
                                                             bid)
            new.update(
                pos=torch.where(respawn[:, None], lpos, new["pos"]),
                direction=torch.where(respawn[:, None], ldir,
                                      new["direction"]),
                weight=torch.where(respawn, ONE, new["weight"]),
                is_direct=torch.where(respawn, ldirect, new["is_direct"]),
                alive=new["alive"] | respawn,
                d_max=torch.where(respawn, ZERO, new["d_max"]),
                transition=new["transition"] & ~respawn)
            if G > 1:
                new["gid"] = torch.where(respawn, lgid, st["gid"])
        if lane_on is not None:
            for k, v in new.items():
                on = lane_on.view((-1,) + (1,) * (v.dim() - 1))
                new[k] = torch.where(on, v, st[k])
        return new, new_next

    # Staged width compaction: each phase runs at a fixed width until fewer
    # than width/4 lanes of a trace are alive (or the fuse), then packs the
    # alive lanes (alive-first stable argsort, per trace) into a width/4
    # state.  Dead lanes carry no state and every accumulator is
    # width-independent, so the physics is unchanged.
    widths = [n_lanes]
    if compact:
        floor = min(compact_floor, n_lanes)
        while widths[-1] > floor:
            widths.append(max(floor, widths[-1] // 4))

    steps = [0] * B
    phase_steps, phase_ms = [], []
    for phase, width in enumerate(widths):
        is_last = phase == len(widths) - 1
        thresh = 0 if is_last else width // 4
        bid = lane_layout(width)
        masks = {}
        t0 = time.perf_counter()
        while True:
            n_alive = state["alive"].view(B, width).sum(dim=1).tolist()
            room = [max_steps - s if n > thresh else 0
                    for n, s in zip(n_alive, steps)]
            block = min(CHECK_EVERY, max(room))
            if block <= 0:
                break
            for j in range(block):
                active = tuple(r > j for r in room)
                lane_on = None
                if not all(active):
                    if active not in masks:
                        masks[active] = torch.tensor(
                            active, device=dev).repeat_interleave(width)
                    lane_on = masks[active]
                u = draw(n_rows, width, active)
                state, new_next = body(state, u, bid, lane_on, next_pid)
                next_pid = (new_next if all(active) else torch.where(
                    torch.tensor(active, device=dev), new_next, next_pid))
                steps = [s + a for s, a in zip(steps, active)]
        phase_ms.append((time.perf_counter() - t0) * 1e3)
        phase_steps.append(list(steps))
        if not is_last:
            nxt = widths[phase + 1]
            order = torch.argsort((~state["alive"]).view(B, width).to(
                torch.uint8), dim=1, stable=True)[:, :nxt]
            order = (order + torch.arange(B, device=dev)[:, None] * width
                     ).reshape(-1)
            state = {k: v[order] for k, v in state.items()}

    # Deposits were flux-scaled at scatter time; only the volumetric
    # normalization remains.
    acc = acc.view(B, acc_len)
    absorb = acc[:, :sfc0].reshape(B, ncol, 2)
    sfc = acc[:, sfc0:].reshape(B, ncell, 4)
    # G == 1: sfc_up reconstructed from the incident deposits (exactly
    # albedo * (dir + dif) per pixel).
    sfc_up = (sfc[:, :, 3] if G > 1
              else alb.view(B, ncell) * (sfc[:, :, 1] + sfc[:, :, 2]))
    f2 = lambda c: c.reshape(B, ny, nx)
    f3 = lambda c: (c / dz).reshape(B, nz, ny, nx)
    out = (f2(toa_down), f2(sfc[:, :, 0]), f2(sfc[:, :, 1]), f2(sfc[:, :, 2]),
           f2(sfc_up), f3(absorb[:, :, 0]), f3(absorb[:, :, 1]))
    aux = {"steps": steps[0] if B == 1 else steps, "n_lanes": n_lanes,
           "ppl": ppl, "phase_widths": widths,
           "phase_steps": [s[0] if B == 1 else s for s in phase_steps],
           "phase_ms": phase_ms, "respawn_mode": respawn_mode}
    return out, aux


def bundle_optical_props(tau_tot, ssa_tot, tau_cld, ssa_cld, asy_cld,
                         tau_aer, ssa_aer, asy_aer, dz):
    """Per-cell extinction decomposition (bundles_optical_props,
    Raytracer.cu:78-108).  All (nz, ny, nx) per-g-point fields; returns
    (k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer)."""
    k_ext = tau_tot / dz
    k_cld = tau_cld / dz
    k_aer = tau_aer / dz
    k_sca_cld = k_cld * ssa_cld
    k_sca_aer = k_aer * ssa_aer
    k_sca_gas = k_ext * ssa_tot - k_sca_cld - k_sca_aer
    return (k_ext, torch.clamp(k_sca_gas, min=0.0), k_sca_cld, k_sca_aer,
            asy_cld, asy_aer)


def sun_direction_from_angles(zenith_angle: float, azimuth_angle: float):
    """Unit vector of the direct beam (Raytracer.cu:341-343: azimuth 0 =
    north, clockwise positive).  Returned as (x, y, z) with z < 0."""
    return np.array([
        -math.sin(zenith_angle) * math.cos(0.5 * math.pi - azimuth_angle),
        -math.sin(zenith_angle) * math.sin(0.5 * math.pi - azimuth_angle),
        -math.cos(zenith_angle),
    ])
