"""TICA (tilted independent column approximation) preprocessing.

The port's own copy of ``rte_rrtmgp_tpu/tools/tica_tilt.py`` (NumPy only).

Full port of the reference's ``src_tilt/tilt_utils.cpp`` pipeline:

* ``tilted_path`` (`:19-176`) — trace the sun ray through the periodic 3D
  grid, producing per-segment cell offsets and tilted interface heights;
* ``tilt_fields``/``create_tilted_columns``(+``_levlay``) (`:516-810`) —
  re-grid every field onto the tilted columns (center start point);
* ``compress_fields`` (`:596-662`) — merge the surplus tilted layers back
  down to the ORIGINAL in-domain layer count: layers below
  ``compress_lay_start_idx`` are kept 1:1, the remainder pair-merged
  (Δp-weighted average for concentrations, ``compress_columns_weighted_avg``
  `:363-428`; level subsampling for p/T, ``compress_columns_p_or_t``
  `:430-514`);
* per-column random-start tilting of the cloud fields with water-path
  conservation (lwp/iwp summed, rel/dei water-weighted;
  ``tica_tilt`` `:872-1112` + ``post_process_output`` `:333-361`);
* ``restore_bkg_profile_bundle`` (`:218-331`) — re-append the untilted
  background profile above the domain so outputs keep the original nlay.

The tilted+compressed columns let a 1D independent-column solver
approximate slant-path radiative transfer at the original grid size (run
the solver with the tilted fields, as ``test_rte_rrtmgp_rt --tica`` does).

Host-side NumPy: this is input preprocessing, not device compute (the
reference runs it on the CPU as well).  Deviation from the reference: the
per-column random start points use a seeded ``numpy`` RNG (reproducible)
instead of a wall-clock-seeded mt19937_64.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def tilted_path(xh, yh, zh, sza: float, azi: float,
                x_start: float = 0.5, y_start: float = 0.5
                ) -> Tuple[List[Tuple[int, int, int]], np.ndarray]:
    """Trace the sun ray upward through the periodic grid.

    Returns (path, zh_tilted): ``path`` is a list of (di, dj, k) cell
    offsets per tilted segment; ``zh_tilted`` the tilted interface heights
    (vertical extent preserved; same algorithm as tilt_utils.cpp:19-176).
    """
    xh = np.asarray(xh, np.float64)
    yh = np.asarray(yh, np.float64)
    zh = np.asarray(zh, np.float64)
    dx, dy = xh[1] - xh[0], yh[1] - yh[0]
    n_x, n_y = len(xh) - 1, len(yh) - 1
    z_top = zh.max()

    i = j = k = 0
    xp = xh[0] + x_start * dx
    yp = yh[0] + y_start * dy
    zp = 0.0

    dir_x = np.sin(sza) * np.sin(azi)
    dir_y = np.sin(sza) * np.cos(azi)
    dir_z = np.cos(sza)
    eps = 1e-8
    BIG = 1e5

    path = [(0, 0, 0)]
    dz_tilted = [0.0]
    z_idx = 0

    guard = 0
    while zp < z_top and guard < 10_000_000:
        guard += 1
        if k + 1 >= len(zh):
            break
        if abs(zp - zh[k + 1]) < eps and dir_z > 0:
            k += 1
            zp = zh[k] if k < len(zh) else zp
            if k + 1 >= len(zh):
                break
            continue
        lz = BIG if abs(dir_z) < eps else (zh[k + 1] - zp) / dir_z

        if abs(dir_y) < eps:
            ly = BIG
        elif dir_y < 0:
            if abs(yp - yh[j]) < eps:
                j = n_y - 1 if j == 0 else j - 1
                yp = yh[j + 1] - eps
                continue
            ly = (yp - yh[j]) / (-dir_y)
        else:
            if abs(yp - yh[j + 1]) < eps:
                j = (j + 1) % n_y
                yp = yh[j] + eps
                continue
            ly = (yh[j + 1] - yp) / dir_y

        if abs(dir_x) < eps:
            lx = BIG
        elif dir_x < 0:
            if abs(xp - xh[i]) < eps:
                i = n_x - 1 if i == 0 else i - 1
                xp = xh[i + 1] - eps
                continue
            lx = (xp - xh[i]) / (-dir_x)
        else:
            if abs(xp - xh[i + 1]) < eps:
                i = (i + 1) % n_x
                xp = xh[i] + eps
                continue
            lx = (xh[i + 1] - xp) / dir_x

        l = min(lx, ly, lz)
        dx0, dy0, dz0 = l * dir_x, l * dir_y, l * dir_z
        xp += dx0
        yp += dy0
        zp += dz0
        dz_tilted[z_idx] += dz0

        crossed = (abs(l - lx) < eps or abs(l - ly) < eps
                   or abs(l - lz) < eps or zp >= zh[k + 1])
        if crossed:
            if abs(l - lz) < eps or zp >= zh[k + 1]:
                k += 1
            if abs(l - ly) < eps:
                j = int(j + np.sign(dy0))
                j = n_y - 1 if j == -1 else j % n_y
                yp = yh[j + 1] if dy0 < 0 else yh[j]
            if abs(l - lx) < eps:
                i = int(i + np.sign(dx0))
                i = n_x - 1 if i == -1 else i % n_x
                xp = xh[i + 1] if dx0 < 0 else xh[i]
            if k + 1 <= len(zh) - 1 and zp < z_top:
                path.append((i, j, k))
                dz_tilted.append(0.0)
                z_idx += 1

    zh_t = np.concatenate([[0.0], np.cumsum(dz_tilted)])
    return path, zh_t


def tilt_field(var: np.ndarray, path, n_x: int, n_y: int) -> np.ndarray:
    """Gather a (ncol, nlay) field onto tilted columns.

    Column icol = iy*n_x + ix samples cell ((ix+di) % n_x, (iy+dj) % n_y, k)
    for each path segment (create_tilted_columns, tilt_utils.cpp:662-686).
    Returns (ncol, n_tilt).
    """
    ncol, nlay = var.shape
    assert ncol == n_x * n_y
    ix = np.arange(ncol) % n_x
    iy = np.arange(ncol) // n_x
    out = np.empty((ncol, len(path)), var.dtype)
    for s, (di, dj, k) in enumerate(path):
        cols = ((iy + dj) % n_y) * n_x + (ix + di) % n_x
        out[:, s] = var[cols, min(k, nlay - 1)]
    return out


def compress_start_index(n_z_tilt: int, n_z_in: int) -> int:
    """First tilted layer index to merge 2:1 so the compressed column has
    exactly ``n_z_in`` layers (tilt_utils.cpp:860-870: ``idx_hold``
    arithmetic; raises when the sun is too low for the scheme)."""
    idx_hold = 2 * (n_z_tilt - n_z_in)
    if (n_z_tilt - idx_hold) % 2 != 0:
        idx_hold -= 1
    start = n_z_tilt - idx_hold
    if start < 0:
        raise ValueError("compress_lay_start_idx is negative - SZA too high")
    return start


def compress_columns_weighted_avg(var: np.ndarray, p_lev: np.ndarray,
                                  start: int, n_out: int) -> np.ndarray:
    """Δp-weighted pair-merge of tilted layers [start, n_tilt) down to
    ``n_out`` total layers (``compress_columns_weighted_avg``,
    tilt_utils.cpp:363-428).  ``var``: (ncol, n_tilt) concentration-like
    field; ``p_lev``: (ncol, n_tilt+1) tilted level pressures."""
    ncol, n_tilt = var.shape
    out = np.empty((ncol, n_out), var.dtype)
    out[:, :start] = var[:, :start]
    for ilay in range(start, n_out):
        i_in = start + 2 * (ilay - start)
        if ilay < n_out - 1:
            k = 2
        else:
            k = 2 if (i_in + 1) == (n_tilt - 1) else 3
        dp = np.abs(p_lev[:, i_in:i_in + k] - p_lev[:, i_in + 1:i_in + k + 1])
        w_sum = dp.sum(axis=1)
        t_sum = (var[:, i_in:i_in + k] * dp).sum(axis=1)
        fallback = var[:, i_in:i_in + k].mean(axis=1)
        out[:, ilay] = np.where(w_sum > 1e-6,
                                t_sum / np.maximum(w_sum, 1e-300), fallback)
    return out


def compress_columns_p_or_t(var_lev: np.ndarray, var_lay: np.ndarray,
                            start: int, n_out_lay: int, n_tilt: int):
    """Compress a tilted LEVEL profile by subsampling every second level in
    the merged region (``compress_columns_p_or_t``, tilt_utils.cpp:430-514).
    Returns (lev (ncol, n_out_lay+1), lay (ncol, n_out_lay)).

    Deviation from the reference: the reference approximates every layer
    value by the level BELOW it (``var_tmp_lay[out] = var_lev[out]`` for
    the untouched region and ``i_lev_to_lay_in = start + 2*off - 1`` in the
    merged region), which duplicates pressures between adjacent layers and
    breaks strict monotonicity.  Here untouched layers keep their proper
    tilted layer values and merged layers take the midpoint level of the
    merged pair — same grid, strictly monotone output."""
    ncol = var_lev.shape[0]
    lev = np.empty((ncol, n_out_lay + 1), var_lev.dtype)
    lay = np.empty((ncol, n_out_lay), var_lev.dtype)
    lev[:, :start + 1] = var_lev[:, :start + 1]
    lay[:, :start] = var_lay[:, :start]
    for ilev in range(start + 1, n_out_lay + 1):
        i_in = n_tilt if ilev == n_out_lay \
            else (start + 2) + 2 * (ilev - (start + 1))
        lev[:, ilev] = var_lev[:, i_in]
    for ilay in range(start, n_out_lay):
        i_in = min(start + 2 * (ilay - start) + 1, n_tilt - 1)
        lay[:, ilay] = var_lev[:, i_in]
    return lev, lay


def restore_bkg_profile(var_out: np.ndarray, var_full: np.ndarray,
                        bkg_start: int) -> np.ndarray:
    """Append the untilted background profile (layers >= bkg_start of the
    original array) above the compressed in-domain layers
    (``restore_bkg_profile``, tilt_utils.cpp:178-216)."""
    return np.concatenate([var_out, var_full[:, bkg_start:]], axis=1)


def interp_to_heights(var_lay: np.ndarray, z_in: np.ndarray,
                      z_out: np.ndarray, log: bool = False) -> np.ndarray:
    """Per-column linear (or log-linear) interpolation in height."""
    out = np.empty((var_lay.shape[0], len(z_out)), var_lay.dtype)
    for c in range(var_lay.shape[0]):
        v = np.log(var_lay[c]) if log else var_lay[c]
        w = np.interp(z_out, z_in, v)
        out[c] = np.exp(w) if log else w
    return out


CLOUD_PAIRS = (("lwp", "rel"), ("iwp", "dei"))


def tilt_cloud_columns(fields: Dict[str, np.ndarray], xh, yh, zh,
                       sza: float, azi: float, n_x: int, n_y: int,
                       rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Per-column random-start tilting of the cloud fields with water-path
    conservation (tilt_utils.cpp:872-1112 + post_process_output).

    Each column traces its OWN tilted path from a random start point inside
    its base cell; water paths are converted to densities, gathered along
    the path (times the tilted segment length, conserving the column water
    path), then pair-merged back to nz layers: lwp/iwp summed, rel/dei
    water-weighted averaged."""
    nz = len(zh) - 1
    ncol = n_x * n_y
    dz_in = np.diff(np.asarray(zh, np.float64))
    pairs = [(w, r if r in fields else None)
             for w, r in CLOUD_PAIRS if w in fields]
    dens = {w: np.asarray(fields[w], np.float64)[:, :nz] / dz_in
            for w, _ in pairs}
    radii = {r: np.asarray(fields[r], np.float64)[:, :nz]
             for _, r in pairs if r is not None}
    out = {k: np.empty((ncol, nz)) for pair in pairs for k in pair
           if k is not None}

    for icol in range(ncol):
        path, zh_t = tilted_path(xh, yh, zh, sza, azi,
                                 x_start=rng.uniform(0.001, 0.999),
                                 y_start=rng.uniform(0.001, 0.999))
        n_t = len(path)
        start = compress_start_index(n_t, nz)
        dz_t = np.diff(zh_t)
        ix, iy = icol % n_x, icol // n_x
        cols = np.array([((iy + dj) % n_y) * n_x + (ix + di) % n_x
                         for di, dj, _ in path])
        ks = np.array([min(k, nz - 1) for _, _, k in path])

        for wname, rname in pairs:
            w_t = dens[wname][cols, ks] * dz_t       # water path per segment
            r_t = radii[rname][cols, ks] if rname else None
            w_out = np.empty(nz)
            r_out = np.empty(nz) if rname else None
            w_out[:start] = w_t[:start]
            if rname:
                r_out[:start] = r_t[:start]
            for ilay in range(start, nz):
                i_in = start + 2 * (ilay - start)
                if ilay < nz - 1:
                    k = 2
                else:
                    k = 2 if (i_in + 1) == (n_t - 1) else 3
                w_seg = w_t[i_in:i_in + k]
                w_sum = w_seg.sum()
                w_out[ilay] = w_sum
                if rname:
                    r_out[ilay] = ((r_t[i_in:i_in + k] * w_seg).sum() / w_sum
                                   if w_sum > 1e-6
                                   else r_t[i_in:i_in + k].mean())
            out[wname][icol] = w_out
            if rname:
                out[rname][icol] = r_out
    return out


def tica_tilt(sza: float, azi: float, n_x: int, n_y: int,
              xh, yh, zh, z, fields_lay: Dict[str, np.ndarray],
              p_lay: np.ndarray, t_lay: np.ndarray,
              p_lev: np.ndarray, t_lev: np.ndarray,
              rng_seed: int = 0) -> dict:
    """Tilt a 3D case for slant-path 1D solving — full reference pipeline
    (tilt -> compress back to the original layer count -> per-column cloud
    tilting -> background restore; ``tica_tilt``, tilt_utils.cpp:813-1176).

    ``zh``/``z`` are the 3D-domain interface/center heights (nz+1 / nz);
    layers above the domain (``p_lay[:, nz:]``) are kept untilted and
    re-appended (restore_bkg_profile), so every output keeps the input's
    (ncol, nlay) shape and ``n_tilt`` equals nz.  ``fields_lay`` maps
    name -> (ncol, nlay) cell fields; lwp/iwp/rel/dei get the per-column
    water-conserving treatment, everything else the center-path tilt +
    Δp-weighted compression.
    """
    nz = len(z)
    ncol, nlay = p_lay.shape
    path, zh_t = tilted_path(xh, yh, zh, sza, azi)
    n_tilt_raw = len(path)
    z_t = 0.5 * (zh_t[1:] + zh_t[:-1])
    start = compress_start_index(n_tilt_raw, nz)

    # p/t: interpolate the tilted column's thermodynamic profile onto the
    # tilted heights (create_tilted_columns_levlay), then compress the
    # level profiles (compress_columns_p_or_t).
    p_lev_t = interp_to_heights(p_lev[:, :nz + 1], zh, zh_t, log=True)
    t_lev_t = interp_to_heights(t_lev[:, :nz + 1], zh, zh_t, log=False)
    p_lay_t = interp_to_heights(p_lay[:, :nz], z, z_t, log=True)
    t_lay_t = interp_to_heights(t_lay[:, :nz], z, z_t, log=False)
    p_lev_c, p_lay_c = compress_columns_p_or_t(p_lev_t, p_lay_t, start, nz,
                                               n_tilt_raw)
    t_lev_c, t_lay_c = compress_columns_p_or_t(t_lev_t, t_lay_t, start, nz,
                                               n_tilt_raw)
    # Guard strict monotonicity (tilt_fields' post-check, :577-593).
    for lev in (p_lev_c,):
        for ilev in range(1, lev.shape[1]):
            eq = lev[:, ilev] >= lev[:, ilev - 1]
            lev[eq, ilev] = lev[eq, ilev - 1] * 0.99999

    cloud_names = {k for pair in CLOUD_PAIRS for k in pair}
    rng = np.random.default_rng(rng_seed)
    clouds_in = {k: v for k, v in fields_lay.items() if k in cloud_names}
    cloud_out = (tilt_cloud_columns(clouds_in, xh, yh, zh, sza, azi,
                                    n_x, n_y, rng) if clouds_in else {})

    out_fields = {}
    for name, var in fields_lay.items():
        if name in cloud_out:
            dom = cloud_out[name].astype(var.dtype)
        else:
            dom_t = tilt_field(var[:, :nz], path, n_x, n_y)
            dom = compress_columns_weighted_avg(dom_t, p_lev_t, start, nz)
        out_fields[name] = restore_bkg_profile(dom, var, nz)

    return dict(path=path, zh_tilted=zh_t, z_tilted=z_t, n_tilt=nz,
                compress_start=start, n_tilt_raw=n_tilt_raw,
                p_lay=restore_bkg_profile(p_lay_c, p_lay, nz),
                t_lay=restore_bkg_profile(t_lay_c, t_lay, nz),
                p_lev=restore_bkg_profile(p_lev_c, p_lev, nz + 1),
                t_lev=restore_bkg_profile(t_lev_c, t_lev, nz + 1),
                fields=out_fields)
