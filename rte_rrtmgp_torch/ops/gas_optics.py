"""RRTMGP gas optics in PyTorch.

Port of the reference gas-optics kernels
(``src_kernels_cuda/gas_optics_rrtmgp_kernels.cu``):

* :func:`interpolation` — ``interpolation_kernel`` (:317-395): per cell the
  temperature / pressure / binary-species-eta indices and weights, kept in
  the flat component-major layout (flavor fastest) that the gas-optics
  kernel reads;
* the major-gas trilinear k-table interpolation (:398-443), the Planck
  fraction (:262-271), the Rayleigh table (:674-718) and the ragged
  minor-gas intervals (:458-579).  They run on the card in one of two forms:

  - per-cell weights, resolved per g-point in the kernel
    ``csrc/gas_optics_interp.cu``, which also scales the minor intervals
    and the Rayleigh k from the cells' inputs: ONE launch per spectral
    chunk through :func:`tau_majmin_and_pfrac` /
    :func:`tau_majmin_and_rayleigh` (the default, ``cellw``);
    :func:`majmin_cells_plain` (:func:`minor_scaling`, then
    :func:`majmin_plain`) is its twin;
  - per-g weight PLANES built here (:func:`_fused_inputs`,
    :func:`_minor_prep`) and read by ``csrc/interp_rows.cu``: the
    ``cellw=False`` step and the single-quantity functions
    :func:`tau_major`, :func:`planck_fraction`, :func:`tau_minor` and
    :func:`tau_rayleigh` on float32 CUDA tensors (for CPU or float64
    tensors those four run their plain bodies); :func:`interp_rows_plain`
    is the kernel's twin;
* the Planck sources (:196-314) — also on layer-major planes
  (:func:`planck_source_lm`) — the Rayleigh/absorption combination
  (:721-746), the column amounts (``src/Gas_optics_rrtmgp.cpp:764-792``)
  and the top-level :func:`gas_optics_lw` / :func:`gas_optics_sw`.

Everything is shape-polymorphic in (ncol, nlay).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import config
from ..models.kdist import KDist
from ..models.types import OpticalProps1scl, OpticalProps2str, SourceFuncLW
from .fluxes import expand_bands_to_gpt
from .kernels import gas_optics_interp as _b1
from .kernels import interp_rows as _b45
from .kernels._checks import takes_twin


@dataclasses.dataclass(frozen=True)
class Interp:
    """Interpolation indices/weights (all indices 0-based lower corners).

    Per-flavor arrays are flat in the last axis, component-major with the
    flavor fastest: (nflav, 2, 2, 2) becomes one axis of 8*nflav."""

    jtemp0: torch.Tensor    # (ncol, nlay) int32 in [0, ntemp-2]
    jpress0: torch.Tensor   # (ncol, nlay) int32: 0-based row of jpress (1-based) - 1
    fpress: torch.Tensor    # (ncol, nlay) pressure interpolation fraction
    tropo: torch.Tensor     # (ncol, nlay) bool
    itropo01: torch.Tensor  # (ncol, nlay) int32: 0 troposphere / 1 upper
    jeta0: torch.Tensor     # (ncol, nlay, 2*nflav) int32; index itemp*F + f
    col_mix: torch.Tensor   # (ncol, nlay, 2*nflav); index itemp*F + f
    fminor: torch.Tensor    # (ncol, nlay, 4*nflav); index (itemp*2 + deta)*F + f
    fmajor: torch.Tensor    # (ncol, nlay, 8*nflav); index (itemp*4+dp*2+deta)*F + f


def interpolation(kd: KDist, play, tlay, col_gas) -> Interp:
    """Vectorized port of interpolation_kernel (:317-395)."""
    dtype = play.dtype
    ntemp, neta, npres = kd.ntemp, kd.neta, kd.press_ref_log.shape[0]
    tiny = config.tiny(dtype)

    jtemp = torch.clamp(
        ((tlay - (kd.temp_ref_min - kd.temp_ref_delta)) / kd.temp_ref_delta)
        .to(torch.int32), 1, ntemp - 1)
    ftemp = (tlay - kd.temp_ref[(jtemp - 1).long()]) / kd.temp_ref_delta

    log_play = torch.log(play)
    # press_ref_log[:1], not [0]: a 0-dim tensor would not promote float32
    # inputs against float64 tables as jnp does.
    locpress = 1.0 + (log_play - kd.press_ref_log[:1]) / kd.press_ref_log_delta
    jpress = torch.clamp(locpress.to(torch.int32), 1, npres - 1)
    fpress = locpress - jpress.to(dtype)

    tropo = log_play > kd.press_ref_trop_log
    itropo01 = torch.where(tropo, 0, 1).to(torch.int32)

    # --- per-flavor binary-species mixing ---
    gas1 = [f[0] for f in kd.flavor]
    gas2 = [f[1] for f in kd.flavor]
    cg1 = col_gas[:, :, gas1]   # (ncol, nlay, nflav)
    cg2 = col_gas[:, :, gas2]

    # eta ratio vmr1/vmr2 at (itropo, jtemp0 + itemp), precomputed per
    # flavor at load time (KDist.ratio_rows, rows = itropo*ntemp + jtemp).
    rows = (itropo01 * ntemp + (jtemp - 1)).long()
    ratio = torch.stack([kd.ratio_rows[rows], kd.ratio_rows[rows + 1]],
                        dim=-1)                                   # (...,F,2)

    col_mix = cg1[..., None] + ratio * cg2[..., None]             # (...,F,2)
    eta = torch.where(col_mix > 2.0 * tiny, cg1[..., None] / col_mix,
                      torch.full((), 0.5, dtype=dtype, device=play.device))

    loceta = eta * (neta - 1)
    jeta = torch.clamp(loceta.to(torch.int32) + 1, max=neta - 1)  # 1-based
    feta = torch.remainder(loceta, 1.0)
    ftt = torch.stack([1.0 - ftemp, ftemp], dim=-1)[:, :, None, :]

    fminor = torch.stack([(1.0 - feta) * ftt, feta * ftt], dim=-1)
    fp = fpress[:, :, None, None, None]
    fmajor = torch.stack([(1.0 - fp) * fminor, fp * fminor], dim=-2)

    ncol, nlay = play.shape
    # Component-major flat layout: flavor is the fastest index.
    flat = lambda a: torch.movedim(a, 2, -1).reshape(ncol, nlay, -1)
    return Interp(
        jtemp0=(jtemp - 1).contiguous(),
        jpress0=(jpress - 1).contiguous(),
        fpress=fpress,
        tropo=tropo,
        itropo01=itropo01,
        jeta0=flat(jeta - 1).contiguous(),
        col_mix=flat(col_mix).contiguous(),
        fminor=flat(fminor).contiguous(),
        fmajor=flat(fmajor).contiguous(),
    )


@functools.lru_cache(maxsize=64)
def gpoint_flavor_tensor(gpoint_flavor: tuple, device: torch.device):
    """(2, G) int32 flavor of each g-point, troposphere row then upper."""
    return torch.tensor(gpoint_flavor, dtype=torch.int32, device=device)


def _per_g(x, comp: int, nflav: int, gf):
    """Component ``comp`` of a flat per-flavor array, resolved to each
    g-point's flavor: (ncol, nlay, k*F) -> (ncol, nlay, G)."""
    return torch.gather(x[:, :, comp * nflav:(comp + 1) * nflav], 2, gf)


def _slab_rows(kd: KDist, interp: Interp):
    """Row indices into kmajor_rows/planck_rows: (ncol, nlay, 2itemp, 2press),
    r = (jpress0 + itropo + dp) * ntemp + (jtemp0 + i)."""
    T = kd.ntemp
    base = (interp.jpress0 + interp.itropo01) * T + interp.jtemp0
    di = torch.arange(2, device=base.device)[:, None]
    dp = torch.arange(2, device=base.device)[None, :] * T
    return base.long()[:, :, None, None] + di + dp


def _interp3d_rows(kd: KDist, table_rows, interp: Interp, scale_by_colmix):
    """Trilinear interpolation over a row-layout table
    ((npress+1)*ntemp, neta, ngpt): the math of
    gas_optical_depths_major_kernel (:398-443) / Planck_source_kernel's
    pfrac (:262-271)."""
    F = kd.nflav
    G = table_rows.shape[2]
    gf = gpoint_flavor_tensor(kd.gpoint_flavor, table_rows.device).long()[
        interp.itropo01.long()]                                   # (C,L,G)
    rows = _slab_rows(kd, interp)                                 # (C,L,2,2)
    g_ar = torch.arange(G, device=table_rows.device)
    out = 0.0
    for i in range(2):
        je = _per_g(interp.jeta0, i, F, gf).long()
        acc = 0.0
        for dp in range(2):
            r = rows[:, :, i, dp, None]
            w0 = _per_g(interp.fmajor, i * 4 + dp * 2, F, gf)
            w1 = _per_g(interp.fmajor, i * 4 + dp * 2 + 1, F, gf)
            acc = acc + (w0 * table_rows[r, je, g_ar]
                         + w1 * table_rows[r, je + 1, g_ar])
        if scale_by_colmix:
            out = out + _per_g(interp.col_mix, i, F, gf) * acc
        else:
            out = out + acc
    return out


def _krayl_interp(kd: KDist, interp: Interp):
    """Rayleigh k (before the column-amount factor): 2 temperature corners
    x 2 eta on krayl_rows (rows itropo*ntemp + jtemp)."""
    F = kd.nflav
    table = kd.krayl_rows
    G = table.shape[2]
    gf = gpoint_flavor_tensor(kd.gpoint_flavor, table.device).long()[
        interp.itropo01.long()]
    base = (interp.itropo01 * kd.ntemp + interp.jtemp0).long()[:, :, None]
    g_ar = torch.arange(G, device=table.device)
    kloc = 0.0
    for i in range(2):
        je = _per_g(interp.jeta0, i, F, gf).long()
        w0 = _per_g(interp.fminor, i * 2, F, gf)
        w1 = _per_g(interp.fminor, i * 2 + 1, F, gf)
        kloc = kloc + (w0 * table[base + i, je, g_ar]
                       + w1 * table[base + i, je + 1, g_ar])
    return kloc


def _cells(x, order: str):
    """(C, L, ...) -> (N, ...) in the requested cell order: "cm" column-major
    (cell c*L + l, a plain reshape), "lm" layer-major (cell l*C + c, the
    layer-major solvers' operand order)."""
    if order == "lm":
        x = x.transpose(0, 1)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def layer_major(x):
    """(ncol, nlay, ...) -> (nlay, ncol, ...) contiguous; an :class:`Interp`
    field by field.  The default gas-optics kernel run on layer-major
    inputs writes (nlay, ncol, G) = the layer-major (N, G) planes."""
    if isinstance(x, Interp):
        return Interp(**{f.name: layer_major(getattr(x, f.name))
                         for f in dataclasses.fields(Interp)})
    return x.transpose(0, 1).contiguous()


def _gflav(kd: KDist, interp: Interp):
    """(C, L, G) flavor of each g-point in each cell's atmosphere."""
    return gpoint_flavor_tensor(kd.gpoint_flavor, interp.itropo01.device
                                ).long()[interp.itropo01.long()]


def _kernel_resolves(kd: KDist, interp: Interp, gf=None):
    """The shared per-g weight planes of the plane-path kernel: the eta
    indices ``jes`` (2, int32) and the fminor weights ``fms`` (4, in
    itemp*2 + deta order), each (N, G) — gathers of each g-point's flavor
    (the JAX package resolves them with one-hot matmuls)."""
    F = kd.nflav
    gf = _gflav(kd, interp) if gf is None else gf
    G = gf.shape[2]
    jes = tuple(_per_g(interp.jeta0, i, F, gf).reshape(-1, G)
                for i in range(2))
    fms = tuple(_per_g(interp.fminor, c, F, gf).reshape(-1, G)
                for c in range(4))
    return jes, fms


def _fused_inputs(kd: KDist, interp: Interp, with_colmix: bool):
    """(rows (N, 4) int32, jes, fms, fp (N,), cms) for the 4-corner tables;
    ``cms`` (the two col_mix planes) only ``with_colmix``."""
    F = kd.nflav
    gf = _gflav(kd, interp)
    G = gf.shape[2]
    rows = _slab_rows(kd, interp).reshape(-1, 4).to(torch.int32)
    jes, fms = _kernel_resolves(kd, interp, gf)
    fp = interp.fpress.reshape(-1)
    cms = None
    if with_colmix:
        cms = tuple(_per_g(interp.col_mix, i, F, gf).reshape(-1, G)
                    for i in range(2))
    return rows, jes, fms, fp, cms


def _ray_rows(kd: KDist, interp: Interp):
    """(N, 2) int32 rows itropo*ntemp + jtemp0 + itemp of krayl_rows."""
    base = (interp.itropo01 * kd.ntemp + interp.jtemp0)[:, :, None]
    it = torch.arange(2, dtype=torch.int32, device=base.device)
    return (base + it).reshape(-1, 2).to(torch.int32)


def interp_rows_plain(tables, rows_list, jes, fms, fp, cms_list):
    """Plain twin of the weight-plane kernel (``csrc/interp_rows.cu``), in
    its operation order: per temperature pair i, the pressure pair blended
    first for 4-corner rows, s_e = (1-fp)*T[r_i0, je_i+e] + fp*T[r_i1,
    je_i+e], then pair = fm[2i]*s_0 + fm[2i+1]*s_1 (times cm_i), summed
    over i.  Returns one (N, G) plane per table."""
    G = jes[0].shape[1]
    g_ar = torch.arange(G, device=jes[0].device)
    je = [j.long() for j in jes]
    outs = []
    for table, rows, cms in zip(tables, rows_list, cms_list):
        rows = rows.long()
        acc = 0.0
        for i in range(2):
            if rows.shape[1] == 4:
                omf, f = (1.0 - fp)[:, None], fp[:, None]
                r0, r1 = rows[:, 2 * i, None], rows[:, 2 * i + 1, None]
                s0 = omf * table[r0, je[i], g_ar] + f * table[r1, je[i], g_ar]
                s1 = (omf * table[r0, je[i] + 1, g_ar]
                      + f * table[r1, je[i] + 1, g_ar])
            else:
                r = rows[:, i, None]
                s0, s1 = table[r, je[i], g_ar], table[r, je[i] + 1, g_ar]
            pair = fms[2 * i] * s0 + fms[2 * i + 1] * s1
            if cms is not None:
                pair = pair * cms[i]
            acc = acc + pair
        outs.append(acc)
    return outs


def _interp3d_rows_planes(kd: KDist, table_rows, interp: Interp,
                          scale_by_colmix):
    """:func:`_interp3d_rows` through the weight-plane kernel (one launch)."""
    C, L = interp.tropo.shape
    rows, jes, fms, fp, cms = _fused_inputs(kd, interp, scale_by_colmix)
    out = _b45.interp_rows(table_rows, rows, jes, fms, fp=fp, cms=cms)
    return out.reshape(C, L, -1)


def tau_major(kd: KDist, interp: Interp):
    """tau from major gases: (ncol, nlay, ngpt).  float32 CUDA tensors: one
    launch of the weight-plane kernel; CPU tensors, or float64 tables or
    weights: the plain body."""
    if takes_twin(kd.kmajor_rows, interp.fmajor):
        return _interp3d_rows(kd, kd.kmajor_rows, interp, scale_by_colmix=True)
    return _interp3d_rows_planes(kd, kd.kmajor_rows, interp, True)


def planck_fraction(kd: KDist, interp: Interp):
    """Planck fraction per g-point: (ncol, nlay, ngpt).  Dispatches as
    :func:`tau_major`."""
    if takes_twin(kd.planck_rows, interp.fmajor):
        return _interp3d_rows(kd, kd.planck_rows, interp,
                              scale_by_colmix=False)
    return _interp3d_rows_planes(kd, kd.planck_rows, interp, False)


def tau_major_and_pfrac(kd: KDist, interp: Interp):
    """kmajor and planck_frac over the same weight planes: ONE launch of
    the weight-plane kernel.  Returns (tau_major, pfrac), each
    (ncol, nlay, ngpt)."""
    C, L = interp.tropo.shape
    rows, jes, fms, fp, cms = _fused_inputs(kd, interp, True)
    tau, pfrac = _b45.interp_rows_multi(
        [kd.kmajor_rows, kd.planck_rows], [rows, rows], jes, fms, fp,
        [cms, None])
    return tau.reshape(C, L, -1), pfrac.reshape(C, L, -1)


def tau_major_and_rayleigh(kd: KDist, interp: Interp, col_gas, col_dry):
    """kmajor (4 corners) and krayl (2 corners) over the same weight
    planes: ONE launch of the weight-plane kernel.  Returns (tau_major,
    tau_rayleigh)."""
    C, L = interp.tropo.shape
    rows, jes, fms, fp, cms = _fused_inputs(kd, interp, True)
    tau, kloc = _b45.interp_rows_multi(
        [kd.kmajor_rows, kd.krayl_rows], [rows, _ray_rows(kd, interp)], jes,
        fms, fp, [cms, None])
    fac = (col_gas[:, :, kd.idx_h2o] + col_dry)[:, :, None]
    return tau.reshape(C, L, -1), kloc.reshape(C, L, -1) * fac


def _spec_scaling(kd, spec, maskf, play, tlay, col_gas):
    """Per-interval scaling column (gas_optical_depths_minor_kernel
    :494-519), with the atmosphere mask folded in."""
    dtype = play.dtype
    scaling = col_gas[:, :, spec.idx_minor]
    if spec.scales_with_density:
        scaling = scaling * (0.01 * play / tlay)
        if spec.idx_scaling > 0:
            # Guard degenerate layers (col_dry == 0, e.g. duplicated
            # pressure levels at the model top) against 0/0 -> NaN.
            vmr_fact = 1.0 / torch.clamp(col_gas[:, :, 0], min=config.tiny(dtype))
            dry_fact = 1.0 / (1.0 + col_gas[:, :, kd.idx_h2o] * vmr_fact)
            sx = col_gas[:, :, spec.idx_scaling] * vmr_fact * dry_fact
            scaling = scaling * ((1.0 - sx) if spec.scale_by_complement
                                 else sx)
    return scaling * maskf


def minor_specs(kd: KDist):
    """The chunk's minor intervals in kernel order: lower then upper, each
    in spec order, as (atmosphere 0/1, spec) pairs."""
    return ([(0, s) for s in kd.minor_lower]
            + [(1, s) for s in kd.minor_upper])


def minor_scaling(kd: KDist, interp: Interp, play, tlay, col_gas):
    """(ncol, nlay, nspec) scaling of every minor interval of the chunk in
    :func:`minor_specs` order, the atmosphere mask folded in (zero where
    the cell lies in the other atmosphere).  The twin's input: the
    gas-optics kernel computes the same values per cell itself."""
    masks = (interp.tropo.to(play.dtype), (~interp.tropo).to(play.dtype))
    cols = [_spec_scaling(kd, spec, masks[atm], play, tlay, col_gas)
            for atm, spec in minor_specs(kd)]
    if not cols:
        return play.new_zeros(play.shape + (0,))
    return torch.stack(cols, dim=-1).contiguous()


def _add_minor(kd: KDist, interp: Interp, sc, tau):
    """Add every minor interval's contribution ltau * sc into ``tau``, in
    :func:`minor_specs` order (2 temperature x 2 eta corners on the
    (ntemp, neta, ncontrib) tables)."""
    F = kd.nflav
    jt = interp.jtemp0.long()[:, :, None]
    fm = interp.fminor
    tau = tau.clone()
    tables = (kd.kminor_lower_trows, kd.kminor_upper_trows)
    for k, (atm, spec) in enumerate(minor_specs(kd)):
        tbl = tables[atm]
        f = spec.flavor
        ng = spec.gpt_end - spec.gpt_start
        cols = torch.arange(spec.kminor_start, spec.kminor_start + ng,
                            device=tbl.device)
        je0 = interp.jeta0[:, :, f].long()[:, :, None]
        je1 = interp.jeta0[:, :, F + f].long()[:, :, None]
        ltau = ((fm[:, :, 0 * F + f, None] * tbl[jt, je0, cols]
                 + fm[:, :, 1 * F + f, None] * tbl[jt, je0 + 1, cols])
                + (fm[:, :, 2 * F + f, None] * tbl[jt + 1, je1, cols]
                   + fm[:, :, 3 * F + f, None] * tbl[jt + 1, je1 + 1, cols]))
        tau[:, :, spec.gpt_start:spec.gpt_end] += ltau * sc[:, :, k, None]
    return tau


def majmin_plain(kd: KDist, interp: Interp, sc, rayleigh: bool):
    """The gas-optics kernel's interpolation for one spectral chunk, given
    the minor scalings ``sc`` (:func:`minor_scaling`): returns
    (tau_major*col_mix + minor, pfrac) or, with ``rayleigh``,
    (tau_abs, krayl before the column-amount factor)."""
    tau = _add_minor(kd, interp, sc,
                     _interp3d_rows(kd, kd.kmajor_rows, interp, True))
    second = (_krayl_interp(kd, interp) if rayleigh
              else _interp3d_rows(kd, kd.planck_rows, interp, False))
    return tau, second


def majmin_cells_plain(kd: KDist, interp: Interp, play, tlay, col_gas,
                       rayleigh: bool):
    """Plain twin of the gas-optics kernel (the wrapper's signature):
    :func:`majmin_plain` over :func:`minor_scaling`, and in the SW the
    Rayleigh k times its column amount, water vapour plus the dry column
    (which :func:`build_col_gas` puts at index 0).  Returns (tau, pfrac)
    or (tau_abs, tau_rayleigh)."""
    tau, second = majmin_plain(
        kd, interp, minor_scaling(kd, interp, play, tlay, col_gas), rayleigh)
    if rayleigh:
        second = second * (col_gas[:, :, kd.idx_h2o]
                           + col_gas[:, :, 0])[:, :, None]
    return tau, second


@functools.lru_cache(maxsize=256)
def _minor_index(ordered: tuple, device: torch.device):
    """Per minor contributor ct (the concatenated contributor axis of
    :func:`_minor_prep`): its interval's flavor and the interval's index in
    ``ordered``, each (CT,) long."""
    flav, spec = [], []
    for k, s in enumerate(ordered):
        flav += [s.flavor] * (s.gpt_end - s.gpt_start)
        spec += [k] * (s.gpt_end - s.gpt_start)
    as_t = lambda v: torch.tensor(v, dtype=torch.long, device=device)
    return as_t(flav), as_t(spec)


def _minor_prep(kd: KDist, interp: Interp, play, tlay, col_gas,
                order: str = "cm"):
    """Inputs of the minor pass of the weight-plane kernel, both
    atmospheres and all intervals: the kernel's "g" axis is the
    concatenated contributor axis CT.  Returns None when the chunk has no
    minor interval, else (tbl (ntemp, neta, CT), rows (N, 2) int32,
    flav (CT,), spec (CT,), sc (N, nspec), ordered, CT): each contributor's
    flavor and interval (the places of the JAX package's one-hot ``Mf`` /
    ``Ms``), and the per-interval scaling with the atmosphere mask folded
    in; ``rows`` and ``sc`` in ``order`` (:func:`_cells`)."""
    dtype = play.dtype
    atmos = [(kd.minor_lower, kd.kminor_lower_trows, interp.tropo),
             (kd.minor_upper, kd.kminor_upper_trows, ~interp.tropo)]
    cols, scal_cols, ordered = [], [], []
    for specs, kminor_trows, mask in atmos:
        maskf = mask.to(dtype)
        for spec in specs:
            ng = spec.gpt_end - spec.gpt_start
            cols.append(kminor_trows[:, :, spec.kminor_start:
                                     spec.kminor_start + ng])
            scal_cols.append(_spec_scaling(kd, spec, maskf, play, tlay,
                                           col_gas))
            ordered.append(spec)
    if not ordered:
        return None
    tbl = torch.cat(cols, dim=2)
    flav, spec_idx = _minor_index(tuple(ordered), tbl.device)
    it = torch.arange(2, dtype=torch.int32, device=tbl.device)
    rows = _cells(interp.jtemp0[:, :, None] + it, order).to(torch.int32)
    sc = _cells(torch.stack(scal_cols, dim=2), order)
    return tbl, rows, flav, spec_idx, sc, tuple(ordered), tbl.shape[2]


def _minor_stitch(tau, upd_all, ordered):
    """Add the per-contributor minor planes ``upd_all`` (..., CT) into
    ``tau`` (..., G), interval by interval in ``ordered`` order (lower
    atmosphere, then upper, each in spec order): per g-point the addition
    order of the sequential reference loop."""
    tau = tau.clone()
    off = 0
    for spec in ordered:
        ng = spec.gpt_end - spec.gpt_start
        tau[..., spec.gpt_start:spec.gpt_end] += upd_all[..., off:off + ng]
        off += ng
    return tau


def _tau_minor_planes(kd: KDist, interp: Interp, play, tlay, col_gas, tau):
    """Minor-gas optical depth through the weight-plane kernel: one launch
    over the contributor axis (flavor planes placed per contributor, 2
    temperature x 2 eta corners on the (ntemp, neta, CT) table), times the
    interval's scaling, added into ``tau`` in interval order."""
    prep = _minor_prep(kd, interp, play, tlay, col_gas)
    if prep is None:
        return tau
    tbl, rows, flav, spec_idx, sc, ordered, CT = prep
    F = kd.nflav
    plane = lambda x, comp: x[:, :, comp * F:(comp + 1) * F].index_select(
        2, flav).reshape(-1, CT)
    jes = tuple(plane(interp.jeta0, i) for i in range(2))
    fms = tuple(plane(interp.fminor, c) for c in range(4))
    ltau = _b45.interp_rows(tbl, rows, jes, fms)
    upd = (ltau * sc.index_select(1, spec_idx)).reshape(tau.shape[:-1] + (CT,))
    return _minor_stitch(tau, upd, ordered)


def tau_minor(kd: KDist, interp: Interp, play, tlay, col_gas, tau):
    """Minor-gas optical depth, both atmospheres; adds into ``tau``.
    Dispatches as :func:`tau_major`."""
    if takes_twin(tau, kd.kminor_lower_trows, interp.fminor):
        return _add_minor(kd, interp,
                          minor_scaling(kd, interp, play, tlay, col_gas), tau)
    return _tau_minor_planes(kd, interp, play, tlay, col_gas, tau)


def tau_majmin_and_pfrac(kd: KDist, interp: Interp, play, tlay, col_gas,
                         cellw: bool = True):
    """kmajor + MINOR + planck fraction for one spectral chunk.  Returns
    (tau, pfrac), each (ncol, nlay, ngpt).  ``cellw``: one launch of the
    per-cell-weight kernel; otherwise the weight-plane kernel twice (the
    fused kmajor+planck pass, then the minor pass)."""
    if cellw:
        return _b1.gas_optics_interp(kd, interp, play, tlay, col_gas,
                                     rayleigh=False)
    tau, pfrac = tau_major_and_pfrac(kd, interp)
    return _tau_minor_planes(kd, interp, play, tlay, col_gas, tau), pfrac


def tau_majmin_and_rayleigh(kd: KDist, interp: Interp, play, tlay, col_gas,
                            col_dry=None, cellw: bool = True):
    """kmajor + MINOR + krayl for one spectral chunk.  Returns (tau_abs,
    tau_rayleigh).  ``cellw``: as :func:`tau_majmin_and_pfrac`; the kernel
    reads the dry column in ``col_gas``, and only the weight-plane path
    needs ``col_dry``."""
    if cellw:
        return _b1.gas_optics_interp(kd, interp, play, tlay, col_gas,
                                     rayleigh=True)
    tau, ray = tau_major_and_rayleigh(kd, interp, col_gas, col_dry)
    return _tau_minor_planes(kd, interp, play, tlay, col_gas, tau), ray


def tau_rayleigh(kd: KDist, interp: Interp, col_gas, col_dry):
    """Rayleigh scattering optical depth (compute_tau_rayleigh_kernel
    :674-718).  Dispatches as :func:`tau_major`."""
    fac = (col_gas[:, :, kd.idx_h2o] + col_dry)[:, :, None]
    if takes_twin(kd.krayl_rows, interp.fminor):
        return _krayl_interp(kd, interp) * fac
    C, L = interp.tropo.shape
    jes, fms = _kernel_resolves(kd, interp)
    kloc = _b45.interp_rows(kd.krayl_rows, _ray_rows(kd, interp), jes, fms)
    return kloc.reshape(C, L, -1) * fac


def combine_abs_and_rayleigh(tau_abs, tau_ray):
    """combine_abs_and_rayleigh_kernel (:721-746): tau, ssa, g."""
    eps = config.eps(tau_abs.dtype)
    tau = tau_abs + tau_ray
    ssa = torch.where(tau > 2.0 * eps,
                      tau_ray / torch.where(tau == 0.0, 1.0, tau), 0.0)
    return tau, ssa, torch.zeros_like(tau)


def _interp1d_planck(temp, kd: KDist):
    """interpolate1D over totplnk (gas_optics_rrtmgp_kernels.cu:1-13),
    returning band Planck radiance expanded to g-points: temp.shape + (ngpt,)."""
    nT = kd.totplnk.shape[0]
    dtype = temp.dtype
    val0 = (temp - kd.temp_ref_min) / kd.totplnk_delta
    ival = val0.to(torch.int32)
    frac = val0 - ival.to(dtype)
    idx = torch.clamp(ival + 1, 1, nT - 1).long()
    lo = kd.totplnk[idx - 1]
    hi = kd.totplnk[idx]
    b = lo + frac[..., None] * (hi - lo)   # (..., nbnd)
    return expand_bands_to_gpt(b, kd.gpt2band)


def planck_source(kd: KDist, interp: Interp, tlay, tlev, tsfc,
                  sfc_lay: int, pfrac=None) -> SourceFuncLW:
    """Planck_source_kernel (:196-314).  ``sfc_lay`` is the 0-based layer
    adjacent to the surface.  ``pfrac`` may come from
    :func:`tau_majmin_and_pfrac`."""
    if pfrac is None:
        pfrac = planck_fraction(kd, interp)

    lay_src = pfrac * _interp1d_planck(tlay, kd)

    blev = _interp1d_planck(tlev, kd)  # (ncol, nlay+1, ngpt)
    nlay = tlay.shape[1]
    lev_inner = torch.sqrt(pfrac[:, 1:] * pfrac[:, :-1]) * blev[:, 1:nlay]
    lev_src = torch.cat([
        pfrac[:, :1] * blev[:, :1],
        lev_inner,
        pfrac[:, nlay - 1:nlay] * blev[:, nlay:nlay + 1],
    ], dim=1)

    bsfc = _interp1d_planck(tsfc, kd)                       # (ncol, ngpt)
    bsfc2 = _interp1d_planck(tsfc + config.DELTA_TSURF, kd)
    sfc_src = pfrac[:, sfc_lay] * bsfc
    sfc_src_jac = pfrac[:, sfc_lay] * (bsfc2 - bsfc)
    return SourceFuncLW(sfc_src=sfc_src, sfc_src_jac=sfc_src_jac,
                        lay_src=lay_src, lev_src=lev_src)


def planck_source_lm(kd: KDist, tlay, tlev, tsfc, sfc_lay: int, pfrac_lm,
                     ncol: int) -> SourceFuncLW:
    """:func:`planck_source` on layer-major planes: ``pfrac_lm`` is
    (nlay*ncol, G) with cell (c, l) at row l*ncol + c; ``tlay``/``tlev``
    keep their (ncol, nlay[+1]) shapes.  The vertical neighbour of a row is
    ncol rows away.  ``lev_src`` comes back as the pieces (lev0 (ncol, G),
    inner ((nlay-1)*ncol, G), lev_last (ncol, G)) that the layer-major LW
    solver reads, with no (nlev*ncol, G) concatenation."""
    C = ncol
    nlay = tlay.shape[1]
    lay_src = pfrac_lm * _interp1d_planck(_cells(tlay, "lm"), kd)

    blev = _interp1d_planck(_cells(tlev, "lm"), kd)      # ((nlay+1)*C, G)
    lev_inner = torch.sqrt(pfrac_lm[C:] * pfrac_lm[:-C]) * blev[C:nlay * C]
    lev_src = (pfrac_lm[:C] * blev[:C],
               lev_inner,
               pfrac_lm[(nlay - 1) * C:] * blev[nlay * C:])

    bsfc = _interp1d_planck(tsfc, kd)                    # (ncol, G)
    bsfc2 = _interp1d_planck(tsfc + config.DELTA_TSURF, kd)
    pf_sfc = pfrac_lm[sfc_lay * C:(sfc_lay + 1) * C]
    sfc_src = pf_sfc * bsfc
    sfc_src_jac = pf_sfc * (bsfc2 - bsfc)
    return SourceFuncLW(sfc_src=sfc_src, sfc_src_jac=sfc_src_jac,
                        lay_src=lay_src, lev_src=lev_src)


def build_col_gas(vmr, col_dry):
    """(ncol, nlay, ngas) vmr + (ncol, nlay) col_dry -> col_gas with the dry
    column at index 0 (the reference's offset-indexed array,
    ``src/Gas_optics_rrtmgp.cpp:1152-1160``)."""
    return torch.cat([col_dry[:, :, None], vmr * col_dry[:, :, None]], dim=2)


def get_col_dry(vmr_h2o, plev):
    """Hydrostatic dry-air column (src/Gas_optics_rrtmgp.cpp:764-792)."""
    delta_plev = torch.abs(plev[:, :-1] - plev[:, 1:])
    m_air = (config.M_DRY + config.M_H2O * vmr_h2o) / (1.0 + vmr_h2o)
    col = 10.0 * delta_plev * config.AVOGADRO / (
        1000.0 * m_air * 100.0 * config.GRAV)
    return col / (1.0 + vmr_h2o)


# ---------------------------------------------------------------------------
# Top-level gas optics (the reference's Gas_optics_rrtmgp::gas_optics).
# ---------------------------------------------------------------------------

def gas_optics_lw(kd: KDist, play, plev, tlay, tlev, tsfc, vmr, col_dry,
                  sfc_lay: int):
    """LW overload (src/Gas_optics_rrtmgp.cpp:796-849): returns
    (OpticalProps1scl, SourceFuncLW).  On the card the major, minor and
    Planck-fraction interpolations are one weight-plane launch each."""
    col_gas = build_col_gas(vmr, col_dry)
    interp = interpolation(kd, play, tlay, col_gas)
    tau = tau_major(kd, interp)
    tau = tau_minor(kd, interp, play, tlay, col_gas, tau)
    sources = planck_source(kd, interp, tlay, tlev, tsfc, sfc_lay)
    return OpticalProps1scl(tau=tau), sources


def gas_optics_sw(kd: KDist, play, plev, tlay, vmr, col_dry):
    """SW overload (src/Gas_optics_rrtmgp.cpp:853-898): returns
    (OpticalProps2str, toa_src (ncol, ngpt))."""
    col_gas = build_col_gas(vmr, col_dry)
    interp = interpolation(kd, play, tlay, col_gas)
    tau_abs = tau_major(kd, interp)
    tau_abs = tau_minor(kd, interp, play, tlay, col_gas, tau_abs)
    tau_ray = tau_rayleigh(kd, interp, col_gas, col_dry)
    tau, ssa, g = combine_abs_and_rayleigh(tau_abs, tau_ray)
    toa_src = kd.solar_source[None, :].expand(play.shape[0], kd.ngpt)
    return OpticalProps2str(tau=tau, ssa=ssa, g=g), toa_src
