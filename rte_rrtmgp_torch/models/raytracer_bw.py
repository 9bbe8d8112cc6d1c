"""Backward (camera) Monte-Carlo ray tracer — radiance rendering.

Port of ``rte_rrtmgp_tpu/models/raytracer_bw.py``, the SIMD form of the
reference's ``src_kernels_cuda_rt/raytracer_kernels_bw.cu`` +
``src_cuda_rt/Raytracer_bw.cu``:

* one lane per camera sample (npix x photons-per-pixel), every lane
  stepped together through backward delta-tracking in the 3D domain and a
  1D background column between the domain top and TOA;
* next-event estimation toward the sun at every scattering and surface
  event: phase value x sun solid angle x direct-sun transmission, the
  transmission from the stochastic null-collision walk (Villefranque et
  al. 2019: k_min integrated, k_max - k_min by russian roulette) or, with
  ``nee_mode="field"``, from a deterministic tilted transmission field;
* Lambertian / specular (water) surfaces, Rayleigh / Henyey-Greenstein /
  Mie phase functions; fisheye (0), rectangular (1) and TOA nadir (2)
  cameras.

The JAX package's ``lax.while_loop`` is a Python loop over tensors here, as
in the forward tracer (``models/raytracer.py``): each step is a few hundred
small PyTorch ops, and the loop condition is read on the host every
:data:`CHECK_EVERY` steps.  The sun-transmission walk, a while loop nested
in every step, runs in blocks of :data:`WALK_BLOCK` sub-steps with
``any(live)`` read on the host before each block (a read costs far less
than a sub-step's launches): a sub-step with no live lane changes
nothing, and the walk draws from its own key, so neither cadence changes a
result (compaction aside, see the forward tracer).

Random numbers come from a tree of keys, as in JAX: :func:`_split`,
:func:`_fold_in` and :func:`_uniform`, in the JAX package's order and
shapes (``split(key, 3)`` at launch and every step, ``(10 if fifo else 8,
width)`` uniforms a step, ``(2, width)`` a walk sub-step), so a test can
put JAX's threefry in their place.  A key here is a 63-bit integer; its
children are derived on the host by an integer hash, and its uniforms come
from a ``torch.Generator`` seeded with it.

Dropped, since they change no value: the one-hot small-table reads (plain
indexing here), the unused background scatter-type draw, and a merge of the
walk's per-axis arithmetic into (N, 3) rows.  ``count.at[pix].add``
becomes ``index_add_``; on the card its float atomics sum in no fixed
order, so card runs agree statistically, not bit for bit.

Radiance calibration matches the reference: count += w * phase(sun) *
sun_solid_angle * T_sun; pixel radiance = count * toa_src * toa_factor /
photons_per_pixel (``count_to_flux_2d``, Raytracer_bw.cu:275-289).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import config
from .raytracer import (W_THRES, _henyey_sample, _mie_phase_value,
                        _mie_sample, _rayleigh_sample, _scatter_direction,
                        coarse_grid_reduce)

# Sun disc: half angle 0.266 deg (raytracer_kernels_bw.h:27-30).
COS_HALF_ANGLE = 0.9999891776066407
SUN_SOLID_ANGLE = 6.799910294339209e-05
CHECK_EVERY = 8     # photon-loop steps between host reads
WALK_BLOCK = 2      # walk sub-steps between host reads (8 cost the same)

# ---------------------------------------------------------------------------
# The random stream: a tree of integer keys.
# ---------------------------------------------------------------------------

_M63 = (1 << 63) - 1
_M64 = (1 << 64) - 1
_gens: dict = {}


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijective hash of a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _key(seed: int) -> int:
    """The root key of a seed (the JAX package's ``PRNGKey``)."""
    return _mix(int(seed) & _M64) & _M63


def _split(key, n: int = 2):
    """``n`` child keys of ``key`` (``jax.random.split``)."""
    base = _mix(int(key) ^ 0x5851F42D4C957F2D)
    return [_mix((base + i) & _M64) & _M63 for i in range(n)]


def _fold_in(key, data: int):
    """The key of ``key`` and an integer (``jax.random.fold_in``)."""
    return _mix(_mix(int(key) ^ 0x14057B7EF767814F) ^ (int(data) & _M64)) & _M63


def _uniform(key, shape, dtype, device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``key`` (``jax.random.uniform``)."""
    dev = torch.device(device)
    gen = _gens.get(dev)
    if gen is None:
        gen = _gens[dev] = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    return torch.rand(shape, generator=gen, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------


def rayleigh_phase(cos_a):
    return 3.0 / (16.0 * np.pi) * (1.0 + cos_a * cos_a)


def henyey_phase(g, cos_a):
    eps = 1.1920929e-07
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_a, min=eps)
    return 1.0 / (4.0 * np.pi) * (1.0 - g * g) / (denom * torch.sqrt(denom))


def lambertian_phase():
    return 1.0 / np.pi


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera description (reference Camera struct,
    raytracer_kernels_bw.h:40-91).  ``position`` is an (x, y, z) tuple in
    meters."""

    position: tuple = (0.0, 0.0, 0.0)
    cam_type: int = 1              # 0 fisheye, 1 rectangular, 2 TOA nadir
    yaw_deg: float = 0.0
    pitch_deg: float = 0.0
    roll_deg: float = 0.0
    f_zoom: float = 1.0
    fov: float = 80.0
    nx: int = 128
    ny: int = 128

    @property
    def npix(self) -> int:
        return self.nx * self.ny

    def rotation(self):
        y, p, r = (np.deg2rad(self.yaw_deg), np.deg2rad(self.pitch_deg),
                   np.deg2rad(self.roll_deg))
        mx = np.array([np.cos(y) * np.cos(p),
                       np.cos(y) * np.sin(p) * np.sin(r) - np.sin(y) * np.cos(r),
                       np.cos(y) * np.sin(p) * np.cos(r) + np.sin(y) * np.sin(r)])
        my = np.array([np.sin(y) * np.cos(p),
                       np.sin(y) * np.sin(p) * np.sin(r) + np.cos(y) * np.cos(r),
                       np.sin(y) * np.sin(p) * np.cos(r) - np.cos(y) * np.sin(r)])
        mz = np.array([-np.sin(p), np.cos(p) * np.sin(r), np.cos(p) * np.cos(r)])
        return mx, my, mz

    def rect_basis(self):
        """cam_width/height/depth for the rectangular camera
        (setup_normal_camera, raytracer_kernels_bw.h:68-86)."""
        mx, my, mz = self.rotation()
        dir_tmp = np.array([1.0, 0.0, 0.0])
        dir_up = np.array([0.0, 0.0, 1.0])
        dir_cam = np.array([mx @ dir_tmp, my @ dir_tmp, mz @ dir_tmp])
        dir_cam /= np.linalg.norm(dir_cam)
        cam_height = np.array([mx @ dir_up, my @ dir_up, mz @ dir_up])
        cam_height /= np.linalg.norm(cam_height)
        cam_width = -np.cross(dir_cam, dir_up)
        cam_width /= np.linalg.norm(cam_width)
        cam_depth = dir_cam / np.tan(np.deg2rad(self.fov) / 2.0)
        if self.nx > self.ny:
            cam_height = cam_height * self.ny / self.nx
        elif self.ny > self.nx:
            cam_width = cam_width * self.nx / self.ny
        return cam_width, cam_height, cam_depth


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _view_directions(camera: Camera, i, j, dtype):
    """Unit view directions of the fisheye and rectangular cameras at
    camera-plane coordinates ``i``, ``j`` in [0, 1)."""
    dev = i.device
    if camera.cam_type == 0:
        mx, my, mz = camera.rotation()
        zen = i * float(0.5 * np.deg2rad(camera.fov))
        azi = j * 2.0 * np.pi
        dt = torch.stack([torch.cos(zen), torch.sin(zen) * torch.cos(azi),
                          torch.sin(zen) * torch.sin(azi)], dim=1)
        M = _tensor(np.stack([mx, my, mz]), dtype, dev)      # (3, 3)
        return dt @ M.T
    w, h, d = camera.rect_basis()
    direction = ((2.0 * i - 1.0)[:, None] * _tensor(w, dtype, dev)[None, :]
                 + (2.0 * j - 1.0)[:, None] * _tensor(h, dtype, dev)[None, :]
                 + _tensor(d, dtype, dev)[None, :])
    return direction / torch.linalg.norm(direction, dim=1, keepdim=True)


def _camera_rays(camera: Camera, key, n_photons, size, z_top, dtype, device):
    """Initial pixel ids, positions and directions of npix*ppp camera
    samples."""
    pix = torch.arange(n_photons, device=device) % camera.npix
    k1, k2 = _split(key)
    u1 = _uniform(k1, (n_photons,), dtype, device)
    u2 = _uniform(k2, (n_photons,), dtype, device)
    return (pix,) + _camera_rays_for(camera, pix, u1, u2, size, z_top, dtype)


def _camera_rays_for(camera: Camera, pix, u1, u2, size, z_top, dtype):
    """Positions/directions for given pixel ids with stratified jitter
    (u1, u2) — the respawnable core of :func:`_camera_rays`."""
    dev = pix.device
    n_photons = pix.shape[0]
    ui = (pix % camera.nx).to(dtype) + u1
    uj = (pix // camera.nx).to(dtype) + u2
    i = ui / camera.nx
    j = uj / camera.ny
    size_x, size_y, _ = size
    if camera.cam_type in (0, 1):
        direction = _view_directions(camera, i, j, dtype)
        pos = _tensor(camera.position, dtype, dev)[None, :].expand(n_photons, 3)
    else:  # TOA nadir
        direction = _tensor([0.0, 0.0, -1.0], dtype, dev)[None, :].expand(
            n_photons, 3)
        px = ((pix % camera.nx).to(dtype) + 0.5) * (size_x / camera.nx)
        py = ((pix // camera.nx).to(dtype) + 0.5) * (size_y / camera.ny)
        pos = torch.stack([px, py, torch.full((n_photons,), float(z_top),
                                              dtype=dtype, device=dev)], dim=1)

    # Bring rays starting above TOA down to z_top along their direction.
    above = (pos[:, 2] > z_top) & (direction[:, 2] < 0)
    ds = (pos[:, 2] - z_top) / torch.where(direction[:, 2] == 0, -1.0,
                                           direction[:, 2])
    pos_adj = pos + direction * ds[:, None]
    pos_adj = torch.cat([pos_adj[:, :2], torch.full_like(pos_adj[:, 2:],
                                                         float(z_top))], 1)
    pos = torch.where(above[:, None], pos_adj, pos)
    pos = torch.cat([torch.remainder(pos[:, 0:1], size_x),
                     torch.remainder(pos[:, 1:2], size_y), pos[:, 2:]], dim=1)
    return pos, direction


def default_rays_per_lane(n_photons: int, photons_per_pixel: int) -> int:
    """Camera rays a lane traces in turn (the forward tracer's
    photons-per-thread amortization), targeting ~32k lanes: below 65,536
    rays every lane traces one and no lane respawns."""
    return max(1, min(photons_per_pixel, n_photons // 32768))


def _resolve_respawn_mode(mode: str, device) -> str:
    """``"auto"`` -> ``RTE_RRTMGP_BW_RESPAWN`` > the tuned ``bw_render``
    winner for ``device``'s kind (``tuning/tune_bw.py``) > ``"pool"``."""
    if mode != "auto":
        return mode
    env = os.environ.get("RTE_RRTMGP_BW_RESPAWN")
    if env:
        return env
    from ..utils import tuner

    tuned = tuner.best_workload_opts("bw_render", device) or {}
    return tuned.get("respawn_mode") or "pool"


def _shift_sample(plane, scx, scy):
    """Bilinear sample of (..., ny, nx) planes at (+scy, +scx) cells
    (uniform shift, periodic); the shifts are host scalars."""
    x0f, y0f = np.floor(scx), np.floor(scy)
    tx, ty = float(scx - x0f), float(scy - y0f)
    ox, oy = int(x0f), int(y0f)
    p00 = torch.roll(plane, (-oy, -ox), dims=(-2, -1))
    p01 = torch.roll(plane, (-oy, -ox - 1), dims=(-2, -1))
    p10 = torch.roll(plane, (-oy - 1, -ox), dims=(-2, -1))
    p11 = torch.roll(plane, (-oy - 1, -ox - 1), dims=(-2, -1))
    return ((1 - ty) * ((1 - tx) * p00 + tx * p01)
            + ty * ((1 - tx) * p10 + tx * p11))


def sun_tau_levels(k_ext, sun_direction, grid_d):
    """The deterministic NEE field (``nee_mode="field"``): tau_lev[k, j, i]
    = integral of k_ext from level k at cell center (i, j) to the domain
    top along the sun direction, periodic horizontal boundaries.  k_ext:
    (..., nz, ny, nx); returns (..., nz+1, ny, nx) (level nz: zero).

    Each layer is resampled once at its absolute offset into V_k(y) =
    sum_{j>=k} k_ext[j](y + (j+0.5)*drift), and V_k is shifted back by
    -k*drift per level (a carry-resampling recurrence would compound the
    bilinear smoothing over nz layers)."""
    ft = np.float32 if k_ext.dtype == torch.float32 else np.float64
    nz = k_ext.shape[-3]
    dz, dy, dx = (ft(v) for v in grid_d)
    sun = np.asarray(sun_direction, ft)
    s_z = max(sun[2], ft(1e-4))
    drift_cx = sun[0] / s_z * dz / dx     # cells of x drift a layer
    drift_cy = sun[1] / s_z * dz / dy
    path_layer = float(dz / s_z)          # meters of path a layer
    v = torch.zeros_like(k_ext[..., 0, :, :])
    v_lev = [None] * nz
    for j in range(nz - 1, -1, -1):
        off = ft(j) + ft(0.5)
        v = v + _shift_sample(k_ext[..., j, :, :], off * drift_cx,
                              off * drift_cy)
        v_lev[j] = v
    tau = [_shift_sample(v_lev[k], -ft(k) * drift_cx, -ft(k) * drift_cy)
           * path_layer for k in range(nz)]
    tau.append(torch.zeros_like(v))
    return torch.stack(tau, dim=-3)


def trace_rays_bw(key, camera: Camera,
                  k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer,
                  k_ext_bg, ssa_bg, asy_split_bg, z_lev_bg,
                  surface_albedo, land_use_map, kn_grid_shape,
                  grid_d, sun_direction, mu0,
                  photons_per_pixel: int,
                  max_steps: int = 20_000,
                  sun_sub_steps: int = 400,
                  k_ext_null_min: float = 1e-3,
                  rays_per_lane: Optional[int] = None,
                  compact: bool = True,
                  nee_mode: str = "walk",
                  respawn_mode: str = "auto",
                  r_eff=None, mie_cdf=None, mie_ang=None, mie_phase=None,
                  mie_phase_ang=None, return_aux: bool = False):
    """Render one spectral interval.  Returns per-pixel count and shot
    arrays (ny, nx); radiance = count * toa_src * toa_factor / ppp.  Runs
    on ``k_ext``'s device in its dtype; ``key`` is the stream's key (an
    integer; ``_key(seed)`` makes one from a seed).

    ``sun_direction`` points TOWARD the sun (z > 0) — opposite to the
    forward tracer's photon-travel convention.

    Background column: ``k_ext_bg`` (kbg,), ``ssa_bg`` (kbg,),
    ``asy_split_bg`` (kbg, 3) [gas, cld, aer] scattering fractions (kept
    for the JAX signature: background scattering is Rayleigh) are the 1D
    profile above the domain; ``z_lev_bg`` (kbg+1,) runs from the domain
    top to TOA.

    Mie: with ``mie_cdf`` / ``mie_ang`` (and per-cell ``r_eff``), cloud
    scatter events sample the Mie LUT instead of Henyey-Greenstein; with
    ``mie_phase`` (n_re, n_ang) / ``mie_phase_ang`` (n_ang,), the sun NEE
    evaluates the Mie phase value (raytracer_kernels_bw.cu:276-292,714-718).

    ``respawn_mode``: ``"fifo"`` (global ray queue), ``"pool"`` (per-lane
    quota over a precomputed launch table) or ``"auto"``
    (``RTE_RRTMGP_BW_RESPAWN`` > the persisted ``tune_bw.py`` winner >
    ``"pool"``).  ``nee_mode``: ``"walk"`` (the unbiased stochastic walk,
    default) or ``"field"`` (deterministic tilted field, fast preview).

    With ``return_aux`` also a dict of loop counts: photon-loop steps and
    walk sub-steps, in all and by width phase, the host ms of each phase,
    the lanes and rays a lane.
    """
    b1 = lambda a: None if a is None else a[None]
    (count, shot), aux = _trace_bw_impl(
        [key], camera, *(a[None] for a in (k_ext, k_sca_gas, k_sca_cld,
                                           k_sca_aer, asy_cld, asy_aer)),
        _tensor_like(k_ext_bg, k_ext)[None], _tensor_like(ssa_bg, k_ext)[None],
        z_lev_bg, _tensor_like(surface_albedo, k_ext)[None], land_use_map,
        kn_grid_shape, grid_d, sun_direction, mu0, photons_per_pixel,
        max_steps=max_steps, sun_sub_steps=sun_sub_steps,
        k_ext_null_min=k_ext_null_min, rays_per_lane=rays_per_lane,
        compact=compact, nee_mode=nee_mode, respawn_mode=respawn_mode,
        r_eff=r_eff, mie_cdf=b1(mie_cdf), mie_ang=b1(mie_ang),
        mie_phase=b1(mie_phase), mie_phase_ang=mie_phase_ang)
    out = (count[0], shot)
    return (out, aux) if return_aux else out


def trace_rays_bw_batched(keys, camera: Camera,
                          k_ext, k_sca_gas, k_sca_cld, k_sca_aer,
                          asy_cld, asy_aer,
                          k_ext_bg, ssa_bg, asy_split_bg, z_lev_bg,
                          surface_albedo, land_use_map, kn_grid_shape,
                          grid_d, sun_direction, mu0,
                          photons_per_pixel: int,
                          max_steps: int = 20_000,
                          sun_sub_steps: int = 400,
                          k_ext_null_min: float = 1e-3,
                          rays_per_lane: Optional[int] = None,
                          compact: bool = True,
                          nee_mode: str = "walk",
                          respawn_mode: str = "auto",
                          r_eff=None, mie_cdf=None, mie_ang=None,
                          mie_phase=None, mie_phase_ang=None,
                          return_aux: bool = False):
    """B renders in ONE batched photon loop (the JAX package's
    ``jax.vmap(trace_rays_bw)``, the solver's ``lanes`` mode).

    The optics carry a leading batch axis: ``k_*``/``asy_*`` (B, nz, ny,
    nx), ``k_ext_bg``/``ssa_bg`` (B, kbg), ``asy_split_bg`` (B, kbg, 3),
    ``surface_albedo`` (B, ny, nx), ``mie_cdf`` (B, n_mie), ``mie_ang`` (B,
    n_re, n_mie), ``mie_phase`` (B, n_re, n_ang); the camera, grid, sun,
    ``z_lev_bg``, ``land_use_map``, ``r_eff`` and ``mie_phase_ang`` are
    shared.  ``keys`` has one key a render.  B renders are B segments of
    one lane axis; each draws from its own keys and stops when its own loop
    condition fails, so each equals :func:`trace_rays_bw` on its inputs up
    to accumulation order.  Returns counts (B, ny, nx) and shot (ny, nx).
    """
    (count, shot), aux = _trace_bw_impl(
        list(keys), camera, k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld,
        asy_aer, _tensor_like(k_ext_bg, k_ext), _tensor_like(ssa_bg, k_ext),
        z_lev_bg, _tensor_like(surface_albedo, k_ext), land_use_map,
        kn_grid_shape, grid_d, sun_direction, mu0, photons_per_pixel,
        max_steps=max_steps, sun_sub_steps=sun_sub_steps,
        k_ext_null_min=k_ext_null_min, rays_per_lane=rays_per_lane,
        compact=compact, nee_mode=nee_mode, respawn_mode=respawn_mode,
        r_eff=r_eff, mie_cdf=mie_cdf, mie_ang=mie_ang, mie_phase=mie_phase,
        mie_phase_ang=mie_phase_ang)
    out = (count, shot)
    return (out, aux) if return_aux else out


def _tensor_like(a, ref):
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def _host_floats(a, ft):
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=ft)


def _trace_bw_impl(keys, camera: Camera,
                   k_ext, k_sca_gas, k_sca_cld, k_sca_aer, asy_cld, asy_aer,
                   k_ext_bg, ssa_bg, z_lev_bg, surface_albedo, land_use_map,
                   kn_grid_shape, grid_d, sun_direction, mu0,
                   photons_per_pixel: int, *, max_steps: int,
                   sun_sub_steps: int, k_ext_null_min: float, rays_per_lane,
                   compact: bool, nee_mode: str, respawn_mode: str,
                   r_eff, mie_cdf, mie_ang, mie_phase, mie_phase_ang):
    """Shared core: B renders, fields (B, nz, ny, nx).  Render b's lanes
    are lane segment b; a lane of render b reads row block b of every
    stacked table.  Returns ((B, ny, nx) counts, (ny, nx) shot) and the
    aux dict."""
    dtype, dev = k_ext.dtype, k_ext.device
    respawn_mode = _resolve_respawn_mode(respawn_mode, dev)
    if respawn_mode not in ("fifo", "pool"):
        raise ValueError(f"unknown respawn_mode {respawn_mode!r}; "
                         "expected 'fifo', 'pool', or 'auto'")
    if nee_mode not in ("walk", "field"):
        raise ValueError(f"unknown nee_mode {nee_mode!r}; expected 'walk' "
                         "or 'field'")
    fifo = respawn_mode == "fifo"
    field = nee_mode == "field"
    ft = np.float32 if dtype == torch.float32 else np.float64
    eps = config.eps(dtype)
    i64 = torch.int64
    B, nz, ny, nx = k_ext.shape
    ncell3, ncol2 = nz * ny * nx, ny * nx
    npix = camera.npix
    n_photons = npix * photons_per_pixel
    rpl = (default_rays_per_lane(n_photons, photons_per_pixel)
           if rays_per_lane is None else rays_per_lane)
    while n_photons % rpl:
        rpl -= 1
    n_lanes = n_photons // rpl
    # Scalars rounded in the working dtype, as the JAX package computes them.
    dz, dy, dx = (ft(v) for v in grid_d)
    size_z, size_y, size_x = ft(nz) * dz, ft(ny) * dy, ft(nx) * dx
    kbg = k_ext_bg.shape[1]
    zl_h = _host_floats(z_lev_bg, ft)
    z_top = zl_h[-1]
    s_min = float(max(size_z, size_y, size_x) * ft(eps))
    s_min_bg = float(max(z_top, size_y, size_x) * ft(eps))
    knz, kny, knx = kn_grid_shape
    kn_ncell = knz * kny * knx
    kn_d = (float(size_x / ft(knx)), float(size_y / ft(kny)),
            float(size_z / ft(knz)))
    sun_h = _host_floats(sun_direction, ft).reshape(3)
    mu0_h = float(_host_floats(mu0, ft).reshape(-1)[0])
    size = (float(size_x), float(size_y), float(size_z))
    size_x, size_y, size_z = size
    dz, dy, dx = float(dz), float(dy), float(dx)
    z_top = float(z_top)

    # ---- per-render tables (row block b of render b) ----
    def kn_reduce(op):
        return torch.stack([coarse_grid_reduce(k, kn_grid_shape, op)
                            for k in k_ext]).reshape(B * kn_ncell)
    kn_max = torch.clamp(kn_reduce("amax"), min=k_ext_null_min)
    kn_min = kn_reduce("amin")
    # the walk's (k_min, max(k_max - k_min, eps)) a coarse cell
    kn_rows = torch.stack([kn_min, torch.clamp(kn_max - kn_min, min=eps)], 1)
    kflat = k_ext.reshape(B * ncell3)
    reff = (torch.as_tensor(r_eff, dtype=dtype, device=dev).reshape(ncell3)
            if r_eff is not None else k_ext.new_zeros(ncell3))
    fields = torch.stack([
        kflat, k_sca_gas.reshape(-1), k_sca_cld.reshape(-1),
        k_sca_aer.reshape(-1), asy_cld.reshape(-1), asy_aer.reshape(-1),
        reff.repeat(B), k_ext.new_zeros(B * ncell3)], dim=1)   # (B*ncell3, 8)
    land = torch.as_tensor(land_use_map, device=dev).reshape(ncol2).to(dtype)
    sfc_fields = torch.stack([surface_albedo.reshape(-1), land.repeat(B)],
                             dim=1)                            # (B*ncol2, 2)
    zl = _tensor(zl_h, dtype, dev)
    # Background rows: (max(k, eps), ssa, z_lo, z_hi) a layer.
    bg_rows = torch.stack([
        torch.clamp(k_ext_bg, min=eps), ssa_bg,
        zl[:-1].expand(B, kbg), zl[1:].expand(B, kbg)], dim=2).reshape(
            B * kbg, 4)
    # Cumulative background optical depth along the sun path
    # (ray_tracer_kernel_bw preamble): bg_tau_cum[k] = sum_{k'>=k} tau/mu.
    dz_bg = torch.abs(zl[1:] - zl[:-1])
    bg_tau = k_ext_bg * dz_bg / mu0_h
    bg_tau_cum = torch.flip(torch.cumsum(torch.flip(bg_tau, (1,)), 1), (1,))
    bg0 = bg_tau_cum[:, 0]                                     # (B,)
    if field:
        tau_lev_flat = sun_tau_levels(k_ext, sun_h, grid_d).reshape(-1)
        # (bg_tau_cum, k_ext_bg, z_lo) a background layer
        bg_field_rows = torch.stack([bg_tau_cum, k_ext_bg,
                                     zl[:-1].expand(B, kbg)], 2).reshape(
                                         B * kbg, 3)
    use_mie_sample = mie_cdf is not None
    use_mie_phase = mie_phase is not None
    mie_b = use_mie_sample and B > 1
    # Scatter types no cell has never win the type draw: their phase
    # samples and values are skipped, which changes no value.
    has_aer = bool((k_sca_aer > 0).any())
    has_cld = bool((k_sca_cld > 0).any())

    # 0-d and (3,) constants: a Python scalar in torch.where is wrapped and
    # cast on every call.
    const = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    i64_row = lambda v: torch.tensor(v, dtype=i64, device=dev)
    ZERO, ONE, EPS = const(0.0), const(1.0), const(eps)
    G_MIN = const(1e-4)
    NUDGE_UP, NUDGE_DN = const(s_min), const(-s_min)
    KN_D, CELL_D = const(list(kn_d)), const([dx, dy, dz])
    SIZE_XY = const([size_x, size_y])
    KN_MAX, CELL_MAX = i64_row([knx - 1, kny - 1, knz - 1]), \
        i64_row([nx - 1, ny - 1, nz - 1])
    KN_STRIDE, CELL_STRIDE = i64_row([1, knx, kny * knx]), \
        i64_row([1, nx, ny * nx])
    ZCOL = torch.tensor([False, False, True], device=dev)
    Z_SFC, Z_TOD = const(eps), const(size_z + s_min_bg)
    Z_IN = const(size_z - s_min)
    SUN = const(sun_h.tolist())
    LAMB_NEE = const(lambertian_phase() * SUN_SOLID_ANGLE)
    # The walk's axis arithmetic with the sun's (host-known) signs: the
    # boundary ahead is cell index + 1 on an axis the sun ray climbs and
    # the cell's lower face otherwise; z always climbs.
    SUN_OFF = i64_row([int(sun_h[0] > 0), int(sun_h[1] > 0), 1])
    SUN_DIV = const([float(sun_h[0]) if sun_h[0] != 0 else eps,
                     float(sun_h[1]) if sun_h[1] != 0 else eps,
                     max(float(sun_h[2]), eps)])
    SUN_NUDGE = const([s_min if s > 0 else -s_min for s in sun_h])
    WALK_TOP = size_z - s_min

    def cell_index(p, d, nmax):
        """(N, k) positions -> (N, k) cell indices, each axis clipped."""
        return torch.minimum(torch.clamp((p / d).to(i64), min=0), nmax)

    def lane_layout(width):
        """Per-lane render index (None for one render)."""
        if B == 1:
            return None
        return torch.arange(B, device=dev).repeat_interleave(width)

    def draw(ks, rows, width):
        """Uniforms of each render's key (zeros for a render with none)."""
        parts = [_uniform(k, (rows, width), dtype, dev) if k is not None
                 else torch.zeros((rows, width), dtype=dtype, device=dev)
                 for k in ks]
        return parts[0] if B == 1 else torch.cat(parts, dim=1)

    # ------------------------------------------------------------------
    def sun_transmission(pos, active, ks, bid):
        """Vectorized transmission_direct_sun (kernels_bw.cu:42-170): the
        walk of every lane of ``active`` toward the sun, in blocks of at
        most WALK_BLOCK sub-steps while any lane is live.  ``ks``: each
        render's walk key (None: the render steps no walk).  Returns the
        transmission a lane and the sub-steps run.

        A lane's transmission is set once, when it reaches the background
        (exp(-(tau_min + the background's tau))); an absorbed lane or one
        still live at ``sun_sub_steps`` keeps 0.  So the walk carries the
        exit's tau_min (inf: none) and takes the exponential once."""
        N = pos.shape[0]
        seg = N // B
        ks = list(ks)
        live = active
        zeros = pos.new_zeros(N)
        tau, tau_min, d_max, kmn = zeros, zeros, zeros, zeros
        kmx = pos.new_ones(N)
        tau_exit = torch.full((N,), math.inf, dtype=dtype, device=dev)
        trans = torch.zeros(N, dtype=torch.bool, device=dev)
        kn_off = None if bid is None else bid * kn_ncell
        cell_off = None if bid is None else bid * ncell3
        sub = 0
        while sub < sun_sub_steps:
            on = live.view(B, seg).any(dim=1).tolist()
            if not any(on):
                break
            for _ in range(min(WALK_BLOCK, sun_sub_steps - sub)):
                ku = [None] * B
                for b in range(B):
                    if on[b] and ks[b] is not None:
                        ks[b], ku[b] = _split(ks[b])
                u = draw(ku, 2, seg)
                in_bg = pos[:, 2] > size_z
                tau_exit = torch.where(live & in_bg, tau_min, tau_exit)
                live = live & ~in_bg

                need = d_max == 0.0
                ijk3 = cell_index(pos, KN_D, KN_MAX)
                s3 = ((ijk3 + SUN_OFF).to(dtype) * KN_D - pos) / SUN_DIV
                dmax_new = torch.minimum(s3[:, :2].abs().amin(dim=1), s3[:, 2])
                ijk_n = (ijk3 * KN_STRIDE).sum(dim=1)
                if kn_off is not None:
                    ijk_n = ijk_n + kn_off
                row = kn_rows[ijk_n]
                d_max = torch.where(need, dmax_new, d_max)
                kmx = torch.where(need, row[:, 1], kmx)
                kmn = torch.where(need, row[:, 0], kmn)

                tau_s = -torch.log(1.0 - u[0] + eps)
                tau = torch.where(trans, tau, tau_s)
                dn = torch.clamp(tau / kmx, min=eps)
                crossing = dn >= d_max
                # crossing: integrate k_min over d_max, move, wrap.
                tmin_c = tau_min + kmn * d_max
                pos_c = pos + SUN[None, :] * d_max[:, None]
                exit_top = pos_c[:, 2] >= WALK_TOP
                pos_top = torch.where(ZCOL, Z_TOD, pos_c)
                pos_cc = pos_c + SUN_NUDGE
                pos_cc = torch.cat([torch.remainder(pos_cc[:, :2], SIZE_XY),
                                    pos_cc[:, 2:]], dim=1)
                tau_c = tau - d_max * kmx
                # collision: move dn, compare against the local k.
                tmin_h = tau_min + kmn * dn
                pos_h = pos + SUN[None, :] * dn[:, None]
                ijk = (cell_index(pos_h, CELL_D, CELL_MAX)
                       * CELL_STRIDE).sum(dim=1)
                if cell_off is not None:
                    ijk = ijk + cell_off
                absorbed = u[1] < (kflat[ijk] - kmn) / kmx

                live = live & (crossing | ~absorbed)
                pos = torch.where(crossing[:, None],
                                  torch.where(exit_top[:, None], pos_top,
                                              pos_cc), pos_h)
                tau = torch.where(crossing, tau_c, tau)
                tau_min = torch.where(crossing, tmin_c, tmin_h)
                d_max = torch.where(crossing, ZERO, d_max - dn)
                trans = crossing
                sub += 1
        exit0 = bg0[0] if bid is None else bg0[bid]
        return torch.exp(-(tau_exit + exit0)), sub

    def sun_trans_field(pos, bg_idx, k_cell, at_sfc, bid):
        """exp(-tau_sun) at ``pos`` from the tilted field: one gather into
        tau_lev (drifted nearest column one level up + k_cell * partial
        path; the undrifted level-0 row for surface events) plus the
        analytic background layers above the domain."""
        z = pos[:, 2]
        s_z = float(max(sun_h[2], ft(1e-4)))
        ck = cell_index(z[:, None], CELL_D[2:], CELL_MAX[2:])[:, 0]
        z_up = (ck + 1).to(dtype) * dz
        t_up = (z_up - z) / s_z
        xs = pos[:, 0] + float(sun_h[0] / ft(s_z)) * (z_up - z)
        ys = pos[:, 1] + float(sun_h[1] / ft(s_z)) * (z_up - z)
        ci = torch.remainder((xs / dx).to(i64), nx)
        cj = torch.remainder((ys / dy).to(i64), ny)
        idx_dom = ((ck + 1) * ny + cj) * nx + ci
        sij = cell_index(pos[:, :2], CELL_D[:2], CELL_MAX[:2])
        idx_sfc = sij[:, 1] * nx + sij[:, 0]
        idx = torch.where(at_sfc, idx_sfc, idx_dom)
        if bid is not None:
            idx = idx + bid * ((nz + 1) * ncol2)
        tau0 = tau_lev_flat[idx]
        b0 = bg0[0] if bid is None else bg0[bid]
        tau_dom = torch.where(at_sfc, tau0, tau0 + k_cell * t_up) + b0
        bgi = torch.clamp(bg_idx, 0, kbg - 1)
        if bid is not None:
            bgi = bgi + bid * kbg
        r = bg_field_rows[bgi]
        tau_bg = r[:, 0] - r[:, 1] * torch.clamp(z - r[:, 2], min=0.0) / s_z
        return torch.exp(-torch.where(z > size_z, tau_bg, tau_dom))

    # ------------------------------------------------------------------
    # Launch states.  Every ray id covers its pixel: ray id = lane +
    # n_lanes * count, pixel = id % npix.  The direct-sun view at launch
    # (reset_photon :257-268) is ONE batched walk over every ray.
    keys = list(keys)
    kinit = []
    u1s, u2s = [], []
    for b in range(B):
        keys[b], kc, ki = _split(keys[b], 3)
        kinit.append(ki)
        k1, k2 = _split(kc)
        u1s.append(_uniform(k1, (n_photons,), dtype, dev))
        u2s.append(_uniform(k2, (n_photons,), dtype, dev))
    u1 = u1s[0] if B == 1 else torch.cat(u1s)
    u2 = u2s[0] if B == 1 else torch.cat(u2s)
    pix_all = (torch.arange(n_photons, device=dev) % npix).repeat(B)
    pos_all, dir_all = _camera_rays_for(camera, pix_all, u1, u2, size, z_top,
                                        dtype)
    camera_shot = torch.full((camera.ny, camera.nx), float(photons_per_pixel),
                             dtype=dtype, device=dev)
    bg_all = torch.clamp(torch.searchsorted(zl, pos_all[:, 2].contiguous(),
                                            right=True) - 1, 0, kbg - 1)
    bid_all = lane_layout(n_photons)
    sees_sun = (dir_all * SUN[None, :]).sum(dim=1) > COS_HALF_ANGLE
    if field:
        ijk0 = (cell_index(pos_all, CELL_D, CELL_MAX) * CELL_STRIDE).sum(1)
        if bid_all is not None:
            ijk0 = ijk0 + bid_all * ncell3
        t_direct = sun_trans_field(pos_all, bg_all, kflat[ijk0],
                                   torch.zeros_like(sees_sun), bid_all)
        pre_sub = 0
    else:
        t_direct, pre_sub = sun_transmission(pos_all, sees_sun, kinit, bid_all)
    pix_g = pix_all if bid_all is None else pix_all + bid_all * npix
    count = torch.zeros(B * npix, dtype=dtype, device=dev).index_add_(
        0, pix_g, torch.where(sees_sun, t_direct, ZERO))

    # Packed launch table (pool mode): (pos3, dir3, pix, bg_idx) a ray id.
    launch_table = None if fifo else torch.cat(
        [pos_all, dir_all, pix_all.to(dtype)[:, None],
         bg_all.to(dtype)[:, None]], dim=1)

    def launch_state_for(pid, u1, u2):
        """Arithmetic launch state for ray ids ``pid`` with fresh
        stratified jitter (statistically equivalent to the pool rays whose
        launch-time sun view was credited in the pre-pass)."""
        pix = pid % npix
        lpos, ldir = _camera_rays_for(camera, pix, u1, u2, size, z_top, dtype)
        lbg = torch.clamp(torch.searchsorted(zl, lpos[:, 2].contiguous(),
                                             right=True) - 1, 0, kbg - 1)
        return lpos, ldir, pix, lbg

    first = (torch.arange(B, device=dev)[:, None] * n_photons
             + torch.arange(n_lanes, device=dev)[None, :]).reshape(-1)
    N = B * n_lanes
    # No respawn: a lane keeps its pixel, so its NEE deposits accumulate
    # in the lane and land in the count once a phase.
    lane_acc = (n_lanes == n_photons) if fifo else (rpl == 1)
    state = dict(
        pos=pos_all[first], direction=dir_all[first],
        weight=torch.ones(N, dtype=dtype, device=dev),
        is_direct=torch.ones(N, dtype=torch.bool, device=dev),
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        tau=torch.zeros(N, dtype=dtype, device=dev),
        d_max=torch.zeros(N, dtype=dtype, device=dev),
        k_null=torch.ones(N, dtype=dtype, device=dev),
        transition=torch.zeros(N, dtype=torch.bool, device=dev),
        bg_idx=bg_all[first], pix=pix_all[first])
    if not fifo:
        state["count"] = torch.zeros(N, dtype=i64, device=dev)
        state["lane_id"] = torch.arange(n_lanes, device=dev).repeat(B)
    if lane_acc:
        state["nee"] = torch.zeros(N, dtype=dtype, device=dev)
    n_rows = 10 if fifo else 8
    del u1, u2, u1s, u2s

    def body(st, count, u, ksun, bid, lane_on, next_pid):
        """One step of every lane.  ``ksun``: each render's walk key
        (None: the render does not step); ``bid``: each lane's render
        (None for one render); ``lane_on``: lanes whose render steps (None:
        all).  Returns the new state, the walk's sub-steps and next_pid."""
        pos, direction, alive = st["pos"], st["direction"], st["alive"]
        width = alive.shape[0] // B
        w = st["weight"]
        tau_sampled = -torch.log(1.0 - u[0] + eps)
        tau = torch.where(st["transition"], st["tau"], tau_sampled)
        in_bg = pos[:, 2] > size_z

        # ============ background 1D region ============
        bgi = st["bg_idx"]
        bg = bg_rows[bgi if bid is None else bgi + bid * kbg]
        kbg_here, ssa_here, z_lo, z_hi = bg.unbind(1)
        dn_bg = torch.clamp(tau / kbg_here, min=eps)
        dirz = direction[:, 2]
        up = dirz > 0
        dmax_bg = torch.abs(torch.where(up, z_hi - pos[:, 2], z_lo - pos[:, 2])
                            / torch.where(dirz == 0, EPS, dirz))
        bg_crossing = dn_bg >= dmax_bg
        # crossing a background layer boundary
        pos_bgc = pos + direction * dmax_bg[:, None]
        z_bgc = torch.where(up, z_hi + s_min_bg, z_lo - s_min_bg)
        enter_domain = z_bgc <= size_z + s_min_bg
        leave_toa = z_bgc >= z_top
        tau_bgc = tau - kbg_here * (dmax_bg + s_min_bg)
        pos_bgc2 = torch.cat([torch.remainder(pos_bgc[:, :2], SIZE_XY),
                              torch.where(enter_domain, Z_IN, z_bgc)[:, None]],
                             dim=1)
        bgi_next = torch.clamp(torch.where(
            enter_domain, bgi, torch.where(up, bgi + 1, bgi - 1)), 0, kbg - 1)
        # background scattering event (Rayleigh)
        pos_bgh = pos + direction * dn_bg[:, None]
        w_bg = w * ssa_here
        w_bg = torch.where(w_bg < W_THRES,
                           torch.where(u[1] > w_bg, ZERO, ONE), w_bg)
        cos_bg = _rayleigh_sample(u[6])

        # ============ dynamic 3D domain ============
        need_grid = st["d_max"] == 0.0
        ijk3 = cell_index(pos, KN_D, KN_MAX)
        lo3 = ijk3.to(dtype) * KN_D
        hi3 = (ijk3 + 1).to(dtype) * KN_D
        s3 = torch.abs(torch.where(direction > 0, hi3 - pos, lo3 - pos)
                       / torch.where(direction == 0, EPS, direction))
        d_new = torch.minimum(s3[:, 0], torch.minimum(s3[:, 1], s3[:, 2]))
        ijk_n = (ijk3 * KN_STRIDE).sum(dim=1)
        if bid is not None:
            ijk_n = ijk_n + bid * kn_ncell
        d_max = torch.where(need_grid, d_new, st["d_max"])
        k_null = torch.where(need_grid, kn_max[ijk_n], st["k_null"])
        dn = torch.clamp(tau / k_null, min=eps)
        crossing = dn >= d_max

        # crossing events
        pos_cross = pos + direction * d_max[:, None]
        hit_sfc = pos_cross[:, 2] < eps
        hit_tod = pos_cross[:, 2] >= size_z
        # surface: albedo, land use, NEE and the reflected direction
        sfc_ij = (cell_index(pos_cross[:, :2], CELL_D[:2], CELL_MAX[:2])
                  * CELL_STRIDE[:2]).sum(dim=1)
        if bid is not None:
            sfc_ij = sfc_ij + bid * ncol2
        sfc_row = sfc_fields[sfc_ij]
        w_sfc = w * sfc_row[:, 0]
        specular_sfc = (sfc_row[:, 1] == 0) & st["is_direct"]
        spec_dir = torch.cat([direction[:, :2], (dirz - 2.0 * dirz)[:, None]],
                             dim=1)
        spec_to_sun = (spec_dir * SUN[None, :]).sum(dim=1) > COS_HALF_ANGLE
        p_sun_sfc = torch.where(specular_sfc, spec_to_sun.to(dtype), LAMB_NEE)
        w_sfc_rr = torch.where(w_sfc < W_THRES,
                               torch.where(u[1] > w_sfc, ZERO, ONE), w_sfc)
        mu_r = torch.sqrt(u[2])
        az_r = 2.0 * math.pi * u[3]
        lamb_dir = torch.stack([mu_r * torch.sin(az_r), mu_r * torch.cos(az_r),
                                torch.sqrt(1.0 - mu_r ** 2 + eps)], dim=1)
        sfc_new_dir = torch.where(specular_sfc[:, None], spec_dir, lamb_dir)
        # TOD exit into the background, or a plain knull-cell pass
        tau_pass = tau - d_max * k_null
        nudge = torch.where(direction > 0, NUDGE_UP, NUDGE_DN)
        pos_pass = pos_cross + nudge
        pos_pass = torch.cat([torch.remainder(pos_pass[:, :2], SIZE_XY),
                              pos_pass[:, 2:]], dim=1)

        # collision events
        pos_col = torch.minimum(torch.maximum(pos + direction * dn[:, None],
                                              lo3 + s_min), hi3 - s_min)
        ijk = (cell_index(pos_col, CELL_D, CELL_MAX) * CELL_STRIDE).sum(dim=1)
        if bid is not None:
            ijk = ijk + bid * ncell3
        cell = fields[ijk]                    # (N, 8) one row gather
        k_here = cell[:, 0]
        ksca_c, ksca_a = cell[:, 2], cell[:, 3]
        k_sca_tot = cell[:, 1] + ksca_c + ksca_a
        ssa_tot = k_sca_tot / torch.clamp(k_here, min=eps)
        f_no_abs = 1.0 - (1.0 - ssa_tot) * (k_here / k_null)
        w_col = w * f_no_abs
        w_col = torch.where(w_col < W_THRES,
                            torch.where(u[1] > w_col, ZERO, ONE), w_col)
        p_scat = ssa_tot / (ssa_tot - 1.0 + k_null / torch.clamp(k_here,
                                                                 min=eps))
        is_null = u[4] >= p_scat

        # scatter type: gas (Rayleigh), cloud (HG or Mie), aerosol (HG)
        sr3 = u[5] * torch.clamp(k_sca_tot, min=eps)
        cos_dom = _rayleigh_sample(u[6])
        t_aer = t_cld = t_hg = None
        if has_aer:
            t_aer = sr3 < ksca_a
            g_eff = torch.clamp(cell[:, 5], max=1.0 - eps)
        if has_cld:
            t_cld = sr3 < ksca_a + ksca_c
            if t_aer is not None:
                t_cld = t_cld & ~t_aer
            g_c = torch.clamp(cell[:, 4], max=1.0 - eps)
            g_eff = g_c if t_aer is None else torch.where(t_aer, g_eff, g_c)
        if t_aer is not None or t_cld is not None:
            t_hg = t_cld if t_aer is None else (
                t_aer if t_cld is None else t_aer | t_cld)
            g_eff = torch.where(t_hg, g_eff, ZERO)
            g_safe = torch.where(torch.abs(g_eff) < 1e-4, G_MIN, g_eff)
            cos_hg = _henyey_sample(g_safe, u[6])
            if use_mie_sample and t_cld is not None:
                cos_mie = _mie_sample(mie_cdf if mie_b else mie_cdf[0],
                                      mie_ang if mie_b else mie_ang[0],
                                      u[6], cell[:, 6])
                cos_hg = (cos_mie if t_aer is None
                          else torch.where(t_aer, cos_hg, cos_mie))
            cos_dom = torch.where(t_hg, cos_hg, cos_dom)

        # ============ masks ============
        m_bg = alive & in_bg
        m_bgc = m_bg & bg_crossing
        m_bgh = m_bg & ~bg_crossing
        m_dom = alive & ~in_bg
        m_cross = m_dom & crossing
        m_sfc = m_cross & hit_sfc
        m_tod = m_cross & hit_tod & ~hit_sfc
        m_pass = m_cross & ~hit_sfc & ~hit_tod
        m_col = m_dom & ~crossing
        col_on = m_col & (w_col > 0.0)
        m_scat_dom = col_on & ~is_null
        m_null = col_on & is_null
        m_scat_bg = m_bgh & (w_bg > 0.0)
        sfc_alive = m_sfc & (w_sfc_rr > 0.0)

        # ============ next-event estimation (scatter + surface) ============
        need_nee = m_scat_dom | m_scat_bg | m_sfc
        if lane_on is not None:
            need_nee = need_nee & lane_on
        cos_sun = torch.clamp((direction * SUN[None, :]).sum(dim=1), -1.0, 1.0)
        p_ray = rayleigh_phase(cos_sun)
        p_dom = p_ray
        if t_hg is not None:
            p_dom = torch.where(t_hg, henyey_phase(g_safe, cos_sun), p_dom)
            if use_mie_phase and t_cld is not None:
                p_mie = _mie_phase_value(
                    mie_phase_ang, mie_phase if B > 1 else mie_phase[0],
                    torch.arccos(cos_sun), cell[:, 6])
                p_dom = torch.where(t_cld, p_mie, p_dom)
        p_dom = p_dom * SUN_SOLID_ANGLE
        p_bg = p_ray * SUN_SOLID_ANGLE
        p_evt = torch.where(m_sfc, p_sun_sfc, torch.where(m_bgh, p_bg, p_dom))
        w_evt = torch.where(m_sfc, w_sfc, torch.where(m_bgh, w_bg, w_col))
        pos_sfc = torch.where(ZCOL, Z_SFC, pos_cross)
        nee_pos = torch.where(m_sfc[:, None], pos_sfc,
                              torch.where(m_bgh[:, None], pos_bgh, pos_col))
        n_sub = 0
        if field:
            t_sun = sun_trans_field(nee_pos, st["bg_idx"], k_here, m_sfc, bid)
        else:
            t_sun, n_sub = sun_transmission(nee_pos, need_nee, ksun, bid)
        dep = torch.where(need_nee, w_evt * p_evt * t_sun, ZERO)
        if lane_acc:
            nee_new = st["nee"] + dep
        else:
            pix = st["pix"] if bid is None else st["pix"] + bid * npix
            count.index_add_(0, pix, dep)

        # ============ merge the new state ============
        new_pos = torch.where(m_bgc[:, None], pos_bgc2,
                    torch.where(m_bgh[:, None], pos_bgh,
                      torch.where(m_col[:, None], pos_col,
                        torch.where(m_sfc[:, None], pos_sfc,
                          torch.where(m_tod[:, None],
                                      torch.where(ZCOL, Z_TOD, pos_cross),
                                      torch.where(m_pass[:, None], pos_pass,
                                                  pos))))))
        # Background and domain scatter events are disjoint per lane: one
        # rotation serves both.
        m_scat = m_scat_dom | m_scat_bg
        scat_dir = _scatter_direction(
            direction, torch.clamp(torch.where(in_bg, cos_bg, cos_dom),
                                   -1.0, 1.0), u[7])
        new_dir = torch.where(sfc_alive[:, None], sfc_new_dir,
                              torch.where(m_scat[:, None], scat_dir, direction))
        new_w = torch.where(m_sfc, w_sfc_rr, torch.where(
            m_col, w_col, torch.where(m_bgh, w_bg, w)))
        died = ((m_sfc & ~sfc_alive) | (m_col & (w_col <= 0.0))
                | (m_bgh & (w_bg <= 0.0))
                | (m_bgc & leave_toa & ~enter_domain))
        new_alive = alive & ~died
        new_direct = st["is_direct"] & ~(sfc_alive & ~specular_sfc) & ~m_scat
        new_dmax = torch.where(m_null, d_max - dn, ZERO)
        new_tau = torch.where(m_pass | m_tod, tau_pass,
                              torch.where(m_bgc, tau_bgc, tau))
        new_bgi = torch.where(m_bgc, bgi_next,
                              torch.where(m_tod, 0, st["bg_idx"]))
        new = dict(st, pos=new_pos, direction=new_dir, weight=new_w,
                   is_direct=new_direct, alive=new_alive, tau=new_tau,
                   d_max=new_dmax, k_null=k_null,
                   transition=m_pass | m_bgc | m_tod, bg_idx=new_bgi)
        new_next = next_pid
        if lane_acc:
            new["nee"] = nee_new
        else:
            # respawn: a lane whose ray died launches its next camera ray
            # (its launch-time sun view was scored in the pre-pass).
            if fifo:
                dying = alive & ~new_alive
                d2 = dying.view(B, width)
                rank = (torch.cumsum(d2, dim=1) - 1).reshape(-1)
                base = next_pid[0] if bid is None else next_pid[bid]
                respawn = dying & (base + rank < n_photons)
                pid = torch.clamp(base + torch.clamp(rank, min=0),
                                  max=n_photons - 1)
                new_next = torch.clamp(next_pid + d2.sum(dim=1),
                                       max=n_photons)
                lpos, ldir, lpix, lbg = launch_state_for(pid, u[8], u[9])
            else:
                respawn = alive & ~new_alive & (st["count"] < rpl - 1)
                new["count"] = torch.where(respawn, st["count"] + 1,
                                           st["count"])
                rid = st["lane_id"] + n_lanes * new["count"]
                launch = launch_table[rid if bid is None
                                      else rid + bid * n_photons]
                lpos, ldir = launch[:, 0:3], launch[:, 3:6]
                lpix = launch[:, 6].to(i64)
                lbg = launch[:, 7].to(i64)
            new.update(
                pos=torch.where(respawn[:, None], lpos, new["pos"]),
                direction=torch.where(respawn[:, None], ldir,
                                      new["direction"]),
                pix=torch.where(respawn, lpix, st["pix"]),
                bg_idx=torch.where(respawn, lbg, new["bg_idx"]),
                weight=torch.where(respawn, ONE, new["weight"]),
                is_direct=new["is_direct"] | respawn,
                alive=new["alive"] | respawn,
                d_max=torch.where(respawn, ZERO, new["d_max"]),
                transition=new["transition"] & ~respawn)
        if lane_on is not None:
            for k, v in new.items():
                on = lane_on.view((-1,) + (1,) * (v.dim() - 1))
                new[k] = torch.where(on, v, st[k])
        return new, n_sub, new_next

    # Staged width compaction, as in the forward tracer: each phase runs
    # at a fixed width until fewer than width/4 lanes of a render are alive
    # (or the fuse), then packs the alive lanes (alive-first stable argsort,
    # per render) into a width/4 state.  The count is width-independent
    # and the launch pool is indexed by the carried lane_id, so the physics
    # is unchanged.
    widths = [n_lanes]
    if compact:
        floor = min(2048, n_lanes)
        while widths[-1] > floor:
            widths.append(max(floor, widths[-1] // 4))

    next_pid = torch.full((B,), n_lanes, dtype=i64, device=dev)
    steps = [0] * B
    sub_total = 0
    phase_steps, phase_ms, phase_sub = [], [], []
    for phase, width in enumerate(widths):
        is_last = phase == len(widths) - 1
        thresh = 0 if is_last else width // 4
        bid = lane_layout(width)
        masks = {}
        t0 = time.perf_counter()
        sub0 = sub_total
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
                ku, ksun = [None] * B, [None] * B
                for b in range(B):
                    if active[b]:
                        keys[b], ku[b], ksun[b] = _split(keys[b], 3)
                u = draw(ku, n_rows, width)
                state, n_sub, new_next = body(state, count, u, ksun, bid,
                                              lane_on, next_pid)
                next_pid = (new_next if all(active) else torch.where(
                    torch.tensor(active, device=dev), new_next, next_pid))
                steps = [s + a for s, a in zip(steps, active)]
                sub_total += n_sub
        if lane_acc:
            # Flush the lane-carried NEE sums once a phase: dead lanes'
            # deposits must land before compaction drops them.
            pix = state["pix"] if bid is None else state["pix"] + bid * npix
            count.index_add_(0, pix, state["nee"])
            state["nee"] = torch.zeros_like(state["nee"])
        phase_ms.append((time.perf_counter() - t0) * 1e3)
        phase_steps.append(list(steps))
        phase_sub.append(sub_total - sub0)
        if not is_last:
            nxt = widths[phase + 1]
            order = torch.argsort((~state["alive"]).view(B, width).to(
                torch.uint8), dim=1, stable=True)[:, :nxt]
            order = (order + torch.arange(B, device=dev)[:, None] * width
                     ).reshape(-1)
            state = {k: v[order] for k, v in state.items()}

    aux = {"steps": steps[0] if B == 1 else steps, "sub_steps": sub_total,
           "prepass_sub_steps": pre_sub, "n_lanes": n_lanes, "rpl": rpl,
           "phase_widths": widths,
           "phase_steps": [s[0] if B == 1 else s for s in phase_steps],
           "phase_sub_steps": phase_sub, "phase_ms": phase_ms,
           "respawn_mode": respawn_mode, "nee_mode": nee_mode}
    return (count.reshape(B, camera.ny, camera.nx), camera_shot), aux


def count_to_radiance(count, toa_src, toa_factor, photons_per_pixel):
    """count_to_flux_2d (Raytracer_bw.cu:275-289)."""
    return count * (toa_src * toa_factor / photons_per_pixel)


def accumulate_clouds(camera: Camera, grid_d, grid_cells,
                      lwp3d, iwp3d, tau_cloud3d):
    """Per-camera-pixel cloud columns along the view ray (the reference's
    ``accumulate_clouds_kernel``, raytracer_kernels_bw.cu:773-889, driven by
    the --cloud-cam flag): deterministic pixel-center rays marched cell by
    cell through the 3D domain, accumulating

    * liwp_cam: path-weighted liquid+ice water (g m-2 equivalents / dz),
    * tauc_cam: path-weighted cloud optical depth / dz,
    * dist_cam: distance to the first cloudy cell (-1 if none met),
    * zen_cam:  the ray zenith angle.

    lwp3d/iwp3d/tau_cloud3d: (nz, ny, nx) tensors (their dtype and device
    are the march's); returns four (ny, nx) images (camera pixel raster).
    The loop condition is read every CHECK_EVERY cells (a dead ray changes
    nothing)."""
    dtype, dev = lwp3d.dtype, lwp3d.device
    nz, ny, nx = grid_cells
    dz, dy, dx = (float(grid_d[0]), float(grid_d[1]), float(grid_d[2]))
    size_x, size_y, size_z = nx * dx, ny * dy, nz * dz
    eps = config.eps(dtype)
    s_eps = max(size_x, size_y, size_z) * eps

    npix = camera.npix
    pixi = torch.arange(npix, device=dev)
    i = ((pixi % camera.nx).to(dtype) + 0.5) / camera.nx
    j = ((pixi // camera.nx).to(dtype) + 0.5) / camera.ny
    if camera.cam_type in (0, 1):
        direction = _view_directions(camera, i, j, dtype)
        pos = _tensor(camera.position, dtype, dev)[None, :].expand(npix, 3)
    else:
        direction = _tensor([0.0, 0.0, -1.0], dtype, dev)[None, :].expand(
            npix, 3)
        pos = torch.stack([i * size_x, j * size_y,
                           torch.full((npix,), size_z - 2 * s_eps,
                                      dtype=dtype, device=dev)], dim=1)

    # Bring rays above the domain down to its top.
    above = (pos[:, 2] >= size_z - s_eps) & (direction[:, 2] < 0)
    ds = torch.abs((pos[:, 2] - size_z)
                   / torch.where(direction[:, 2] == 0, -1.0, direction[:, 2]))
    pos_adj = pos + direction * ds[:, None] - s_eps
    pos = torch.where(above[:, None], pos_adj, pos)
    pos = torch.cat([torch.remainder(pos[:, 0:1], size_x),
                     torch.remainder(pos[:, 1:2], size_y), pos[:, 2:]], 1)

    lw = (lwp3d + iwp3d).reshape(-1)
    tc = tau_cloud3d.reshape(-1)
    i64 = torch.int64
    CELL_D = torch.tensor([dx, dy, dz], dtype=dtype, device=dev)
    CELL_MAX = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)
    STRIDE = torch.tensor([1, nx, ny * nx], device=dev)
    EPS_T = torch.tensor(eps, dtype=dtype, device=dev)
    SIZE_XY = torch.tensor([size_x, size_y], dtype=dtype, device=dev)
    STEP_UP, STEP_DN = (torch.tensor(v, dtype=dtype, device=dev)
                        for v in (s_eps, -s_eps))

    zeros = torch.zeros(npix, dtype=dtype, device=dev)
    liwp, tauc, dist = zeros, zeros, zeros
    reached = torch.zeros(npix, dtype=torch.bool, device=dev)
    alive = (pos[:, 2] <= size_z - s_eps) & (pos[:, 2] >= s_eps)
    max_steps = 4 * (nx + ny + nz)
    step = 0
    while step < max_steps and bool(alive.any()):
        for _ in range(min(CHECK_EVERY, max_steps - step)):
            ijk3 = torch.minimum(torch.clamp((pos / CELL_D).to(i64), min=0),
                                 CELL_MAX)
            ijk = (ijk3 * STRIDE).sum(dim=1)
            lo3 = ijk3.to(dtype) * CELL_D
            hi3 = (ijk3 + 1).to(dtype) * CELL_D
            s3 = torch.abs(torch.where(direction > 0, hi3 - pos, lo3 - pos)
                           / torch.where(direction == 0, EPS_T, direction))
            s = torch.minimum(s3[:, 0], torch.minimum(s3[:, 1], s3[:, 2]))
            m = alive.to(dtype)
            tc_here = tc[ijk]
            liwp = liwp + m * s * lw[ijk]
            tauc = tauc + m * s * tc_here
            dist = dist + m * (1.0 - reached.to(dtype)) * s
            reached = reached | (alive & (tc_here > 0))
            newpos = pos + direction * s[:, None]
            newpos = newpos + torch.where(direction >= 0, STEP_UP, STEP_DN)
            newpos = torch.cat([torch.remainder(newpos[:, :2], SIZE_XY),
                                newpos[:, 2:]], dim=1)
            pos = torch.where(alive[:, None], newpos, pos)
            alive = alive & (pos[:, 2] <= size_z - s_eps) & (pos[:, 2] >= s_eps)
            step += 1

    shape = (camera.ny, camera.nx)
    return ((liwp / dz).reshape(shape), (tauc / dz).reshape(shape),
            torch.where(reached, dist, -1.0).reshape(shape),
            torch.arccos(torch.clamp(direction[:, 2], -1.0, 1.0)).reshape(shape))
