"""Top-level radiation solvers (the reference's driver layer).

``RadiationSolverLW`` / ``RadiationSolverSW`` mirror
``Radiation_solver_longwave/shortwave::solve``
(``src_test/Radiation_solver.cpp:384-916``):

* **Spectral chunking** (``gpt_chunk``) bounds memory: the pipeline runs per
  g-point chunk via ``KDist.slice_gpt`` and accumulates broadband / by-band
  fluxes (the reference rt path's per-g-point streaming,
  ``src_test/Radiation_solver_rt.cu:760``).
* **Orientation canonicalized.**  Solvers run with the top of the
  atmosphere at layer index 0; inputs in the opposite orientation are
  flipped in and the outputs flipped back.

Three layouts of the same function, chosen by ``cellw`` and
``layer_major`` (``None``: the environment, then the tuned winner for the
tables' device, then the default; ``config.cellw_enabled`` /
``config.layer_major_enabled``).  On the card every chunk makes

* default (cellw on, layer-major off): one launch of the per-cell-weight
  gas-optics kernel, then one LW sweep launch per Gauss angle or one SW
  two-stream launch (broadband output; by-band output runs the plain
  PyTorch solvers, as the JAX package runs ``lax.scan`` there, and
  ``with_fluxes=False`` no solver at all);
* ``cellw=False``: one launch of the weight-plane kernel for the major
  gases (with planck_frac or krayl) and one for the minor gases when the
  chunk has minor intervals, then the same solver launches;
* ``layer_major=True`` (with cellw on, fluxes and broadband output only,
  and a k-distribution with minor intervals; otherwise the default layout): the
  per-cell-weight kernel on layer-major inputs, so every (N, G) plane has
  cell (c, l) at row l*ncol + c, then the layer-major solver kernels.

With ``clear_sky=True`` (broadband fluxes only) each chunk is solved twice
on one gas-optics pass: on its gas-only optics before the clouds are
added (``*_clrsky_flux_*`` outputs), then on the all-sky optics, as a GCM
computes its clear-sky diagnostics; the two solves share the chunk's
surface and top-of-atmosphere inputs.

The SW's broadband solve (no optical output) hands the gas optics
(tau_abs, tau_rayleigh) and the per-band cloud and aerosol optics to the
SW kernel, which combines them itself (``rte_sw``'s fused entries; their
twin, for float64 and the CPU, is the plain chain): no tau, ssa or g
plane is written, and the clear-sky solve is the same entry with no
increment.  By-band or optical output combines them in plain PyTorch
first (stages ``sw_combine``, ``sw_*_increment``).

Each stage of the pipeline (``STAGES``: inputs, column gas, cloud and
aerosol optics, interpolation, gas optics, Planck sources, optics
combination, solve, fluxes, the clear-sky solve and fluxes) runs inside a
``torch.profiler`` range of its name while a profiler runs, so a profile
of any solve gives the card's time by stage
(``tools/profile_stages.py``).

All tensors live on the tables' device.  ``dtype`` follows the JAX
package's rule: ``None`` is the dtype of ``p_lay`` as given (float64 for a
NumPy float64 array, as JAX has it with x64 on); an explicit dtype casts
every input, the packed vmr and ``col_dry`` and leaves the tables as they
are, so mixed operands promote as ``jnp`` promotes them.  A kernel
launches only when all its operands are float32 CUDA tensors.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from .. import config
from ..ops.kernels import _build
from ..ops import (aerosol_optics as aero_ops, cloud_optics as cloud_ops,
                   fluxes as flux_ops, gas_optics as gas_ops,
                   optics_ops, rte_lw, rte_sw)
from .aerosol_lut import AerosolLUT
from .cloud_lut import CloudLUT
from .gas_concs import GasConcs
from .kdist import KDist


def _chunks(ngpt: int, gpt_chunk: Optional[int]):
    step = gpt_chunk or ngpt
    return [(g0, min(g0 + step, ngpt)) for g0 in range(0, ngpt, step)]


def _flip_lay(a):
    return torch.flip(a, dims=(1,))


# The pipeline's stages, each a named torch.profiler range while a profiler
# runs (``tools/profile_stages.py`` reads the card's time by range).
STAGES = tuple(f"{s}_{n}" for s in ("lw", "sw") for n in (
    "inputs", "col_gas", "cloud_optics", "interpolation", "layer_major",
    "gas_optics", "solve", "fluxes", "solve_clrsky", "fluxes_clrsky")) + (
    "lw_planck", "lw_cloud_add", "sw_aerosol_optics", "sw_combine",
    "sw_cloud_increment", "sw_aerosol_increment")


def _stage(name: str):
    """The range of stage ``name`` for torch.profiler; nothing (no cost but
    one check) while no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _layouts(kd: KDist, cellw, layer_major, broadband_only: bool):
    """(cellw, lm): ``None`` resolved for the tables' device (environment,
    then the tuned winner, then the default); layer-major applies only with
    cellw on, fluxes wanted and broadband output only, and a k-distribution
    with minor intervals (the JAX package's predicate)."""
    cellw = config.cellw_enabled(kd.device) if cellw is None else bool(cellw)
    layer_major = (config.layer_major_enabled(kd.device) if layer_major is None
                   else bool(layer_major))
    lm = (layer_major and cellw and broadband_only
          and bool(kd.minor_lower or kd.minor_upper))
    return cellw, lm


def _refuse_clear_sky(clear_sky: bool, output_bnd_fluxes: bool,
                      output_optical: bool, with_fluxes: bool) -> None:
    """The clear-sky fluxes are broadband fluxes beside the all-sky ones:
    refuse ``clear_sky`` with by-band or optical output, or with no
    fluxes."""
    if not clear_sky:
        return
    bad = [k for k, v in (("output_bnd_fluxes=True", output_bnd_fluxes),
                          ("output_optical=True", output_optical),
                          ("with_fluxes=False", not with_fluxes)) if v]
    if bad:
        raise ValueError(f"clear_sky=True with {' and '.join(bad)}: the "
                         "clear-sky fluxes are broadband fluxes only")


def _solve_lw_impl(kd: KDist, cloud_lut, p_lay, p_lev, t_lay, t_lev, t_sfc,
                   vmr, col_dry, emis_sfc, lwp, iwp, rel, dei,
                   *, top_at_1: bool, gpt_chunk, output_bnd_fluxes: bool,
                   n_gauss_angles: int, with_clouds: bool,
                   output_optical: bool = False, with_fluxes: bool = True,
                   cellw: Optional[bool] = None,
                   layer_major: Optional[bool] = None,
                   clear_sky: bool = False):
    _refuse_clear_sky(clear_sky, output_bnd_fluxes, output_optical,
                      with_fluxes)
    with _stage("lw_inputs"):
        if not top_at_1:
            p_lay, t_lay, vmr, col_dry = map(_flip_lay,
                                             (p_lay, t_lay, vmr, col_dry))
            p_lev, t_lev = map(_flip_lay, (p_lev, t_lev))
            if with_clouds:
                lwp, iwp, rel, dei = map(_flip_lay, (lwp, iwp, rel, dei))
    ncol, nlay = p_lay.shape
    nlev = nlay + 1
    nbnd = kd.nbnd
    dtype = p_lay.dtype

    with _stage("lw_col_gas"):
        col_gas = gas_ops.build_col_gas(vmr, col_dry)
    cld = None
    if with_clouds:
        with _stage("lw_cloud_optics"):
            cld = cloud_ops.cloud_optics_1scl(cloud_lut, lwp, iwp, rel, dei)

    new = lambda *shape: torch.zeros(shape, dtype=dtype, device=p_lay.device)
    with _stage("lw_fluxes"):
        flux_up, flux_dn = new(ncol, nlev), new(ncol, nlev)
        bnd_up = new(ncol, nlev, nbnd) if output_bnd_fluxes else None
        bnd_dn = new(ncol, nlev, nbnd) if output_bnd_fluxes else None
    if clear_sky:
        with _stage("lw_fluxes_clrsky"):
            clr = [new(ncol, nlev), new(ncol, nlev)]   # up, dn

    with _stage("lw_interpolation"):
        interp = gas_ops.interpolation(kd, p_lay, t_lay, col_gas)
    optical = {k: [] for k in ("lw_tau", "lay_source", "lev_source",
                               "sfc_source")} if output_optical else None
    cellw, lm = _layouts(kd, cellw, layer_major, with_fluxes
                         and not output_bnd_fluxes and not output_optical)
    if lm:
        # Layer-major: the gas-optics kernel runs on (nlay, ncol) inputs and
        # writes (nlay, ncol, G) = the (N, G) planes the solver reads.
        with _stage("lw_layer_major"):
            lm_in = tuple(map(gas_ops.layer_major,
                              (interp, p_lay, t_lay, col_gas)))
            cld_tau = gas_ops._cells(cld.tau, "lm") if with_clouds else None
    elif with_clouds:
        cld_tau = cld.tau

    def surface(kdc, src):
        """The chunk's surface emissivity and sources by g-point, and its
        incident flux: the solve's inputs besides the optics."""
        emis_gpt = flux_ops.expand_bands_to_gpt(emis_sfc, kdc.gpt2band)
        inc = new(ncol, kdc.ngpt)
        if lm:
            return emis_gpt, src.sfc_src, src.sfc_src_jac, inc
        return (emis_gpt, src.sfc_src.contiguous(),
                src.sfc_src_jac.contiguous(), inc)

    def sweep(tau, src, bc):
        if lm:
            up, dn, _ = rte_lw.lw_solver_noscat_broadband_lm(
                tau, src.lay_src, src.lev_src, *bc, ncol=ncol,
                n_gauss_angles=n_gauss_angles)
        else:
            # Broadband only: the sweep kernel sums over g-points itself
            # and never materializes (ncol, nlev, ngpt).
            solver = (rte_lw.lw_solver_noscat if output_bnd_fluxes
                      else rte_lw.lw_solver_noscat_broadband)
            up, dn, _ = solver(tau, src.lay_src, src.lev_src, *bc,
                               n_gauss_angles=n_gauss_angles)
        return up, dn

    def solve_clear_sky(kdc, tau, src):
        """Solve the chunk's gas-only optics into the clear-sky
        accumulators; returns the surface inputs for the all-sky solve.
        Its fluxes are freed here, before the clouds are added."""
        with _stage("lw_solve_clrsky"):
            bc = surface(kdc, src)
            fluxes = sweep(tau, src, bc)
        with _stage("lw_fluxes_clrsky"):
            for acc, f in zip(clr, fluxes):
                acc += f
            _build.CLRSKY_GPTS["driver"] += kdc.ngpt
        return bc

    for g0, g1 in _chunks(kd.ngpt, gpt_chunk):
        kdc = kd.slice_gpt(g0, g1)
        with _stage("lw_gas_optics"):
            if lm:
                tau, pfrac = (a.reshape(nlay * ncol, g1 - g0) for a in
                              gas_ops.tau_majmin_and_pfrac(kdc, *lm_in))
            else:
                tau, pfrac = gas_ops.tau_majmin_and_pfrac(
                    kdc, interp, p_lay, t_lay, col_gas, cellw=cellw)
        with _stage("lw_planck"):
            if lm:
                src = gas_ops.planck_source_lm(
                    kdc, t_lay, t_lev, t_sfc, sfc_lay=nlay - 1,
                    pfrac_lm=pfrac, ncol=ncol)
            else:
                src = gas_ops.planck_source(kdc, interp, t_lay, t_lev, t_sfc,
                                            sfc_lay=nlay - 1, pfrac=pfrac)
        bc = solve_clear_sky(kdc, tau, src) if clear_sky else None
        if with_clouds:
            with _stage("lw_cloud_add"):
                tau = tau + flux_ops.expand_bands_to_gpt(cld_tau,
                                                         kdc.gpt2band)
        if output_optical:
            optical["lw_tau"].append(tau)
            optical["lay_source"].append(src.lay_src)
            optical["lev_source"].append(src.lev_src)
            optical["sfc_source"].append(src.sfc_src)
        if not with_fluxes:
            continue

        with _stage("lw_solve"):
            up, dn = sweep(tau, src, bc or surface(kdc, src))
        with _stage("lw_fluxes"):
            if not output_bnd_fluxes:
                flux_up = flux_up + up
                flux_dn = flux_dn + dn
                continue
            flux_up = flux_up + flux_ops.sum_broadband(up)
            flux_dn = flux_dn + flux_ops.sum_broadband(dn)
            bnd_up = bnd_up + flux_ops.sum_byband(up, kdc.gpt2band, nbnd)
            bnd_dn = bnd_dn + flux_ops.sum_byband(dn, kdc.gpt2band, nbnd)

    with _stage("lw_fluxes"):
        out = {}
        if with_fluxes:
            out.update(lw_flux_up=flux_up, lw_flux_dn=flux_dn,
                       lw_flux_net=flux_dn - flux_up)
        if clear_sky:
            up, dn = clr
            out.update(lw_clrsky_flux_up=up, lw_clrsky_flux_dn=dn,
                       lw_clrsky_flux_net=dn - up)
        if output_bnd_fluxes:
            out.update(lw_bnd_flux_up=bnd_up, lw_bnd_flux_dn=bnd_dn,
                       lw_bnd_flux_net=bnd_dn - bnd_up)
        if output_optical:
            out.update({k: torch.cat(v, dim=-1) for k, v in optical.items()})
        if not top_at_1:
            # Flip back everything with a vertical axis 1 (sfc_source is
            # (ncol, ngpt) — no vertical axis).
            out = {k: (v if k == "sfc_source" else _flip_lay(v))
                   for k, v in out.items()}
    return out


def _solve_sw_impl(kd: KDist, cloud_lut, aerosol_lut,
                   p_lay, p_lev, t_lay, vmr, col_dry,
                   sfc_alb_dir, sfc_alb_dif, tsi_scaling, mu0,
                   lwp, iwp, rel, dei, rh, aermr,
                   *, top_at_1: bool, gpt_chunk, output_bnd_fluxes: bool,
                   with_clouds: bool, with_aerosols: bool,
                   delta_cloud: bool, delta_aerosol: bool,
                   output_optical: bool = False, with_fluxes: bool = True,
                   cellw: Optional[bool] = None,
                   layer_major: Optional[bool] = None,
                   clear_sky: bool = False):
    _refuse_clear_sky(clear_sky, output_bnd_fluxes, output_optical,
                      with_fluxes)
    with _stage("sw_inputs"):
        if not top_at_1:
            p_lay, t_lay, vmr, col_dry = map(_flip_lay,
                                             (p_lay, t_lay, vmr, col_dry))
            p_lev = _flip_lay(p_lev)
            if with_clouds:
                lwp, iwp, rel, dei = map(_flip_lay, (lwp, iwp, rel, dei))
            if with_aerosols:
                rh, aermr = map(_flip_lay, (rh, aermr))
        # Night columns would produce NaNs in exp(-tau/mu0); compute them
        # with a safe mu0 and zero their fluxes at the end.
        mu0_safe = torch.where(mu0 > 0.0, mu0, 1.0).contiguous()
    ncol, nlay = p_lay.shape
    nlev = nlay + 1
    nbnd = kd.nbnd
    dtype = p_lay.dtype

    with _stage("sw_col_gas"):
        col_gas = gas_ops.build_col_gas(vmr, col_dry)

    cld = aer = None
    if with_clouds:
        with _stage("sw_cloud_optics"):
            cld = cloud_ops.cloud_optics_2str(cloud_lut, lwp, iwp, rel, dei)
            if delta_cloud:
                cld = optics_ops.delta_scale(cld)
    if with_aerosols:
        with _stage("sw_aerosol_optics"):
            aer = aero_ops.aerosol_optics_2str(aerosol_lut, aermr, rh, p_lev)
            if delta_aerosol:
                aer = optics_ops.delta_scale(aer)

    new = lambda *shape: torch.zeros(shape, dtype=dtype, device=p_lay.device)
    with _stage("sw_fluxes"):
        flux_up, flux_dn, flux_dir = (new(ncol, nlev), new(ncol, nlev),
                                      new(ncol, nlev))
        bnd = ({k: new(ncol, nlev, nbnd) for k in ("up", "dn", "dir")}
               if output_bnd_fluxes else None)
    if clear_sky:
        with _stage("sw_fluxes_clrsky"):
            clr = [new(ncol, nlev) for _ in range(3)]   # up, dn, dir

    with _stage("sw_interpolation"):
        interp = gas_ops.interpolation(kd, p_lay, t_lay, col_gas)
    optical = {k: [] for k in ("sw_tau", "ssa", "g", "toa_source")} \
        if output_optical else None
    cellw, lm = _layouts(kd, cellw, layer_major, with_fluxes
                         and not output_bnd_fluxes and not output_optical)
    if lm:
        with _stage("sw_layer_major"):
            lm_in = tuple(map(gas_ops.layer_major,
                              (interp, p_lay, t_lay, col_gas)))
            to_lm2 = lambda o: optics_ops.OpticalProps2str(
                tau=gas_ops._cells(o.tau, "lm"),
                ssa=gas_ops._cells(o.ssa, "lm"), g=gas_ops._cells(o.g, "lm"))
            cld = to_lm2(cld) if with_clouds else cld
            aer = to_lm2(aer) if with_aerosols else aer

    def toa_source(kdc):
        return (kdc.solar_source[None, :] * tsi_scaling[:, None]).to(dtype)

    def albedos(kdc):
        return tuple(flux_ops.expand_bands_to_gpt(a, kdc.gpt2band)
                     for a in (sfc_alb_dir, sfc_alb_dif))

    def two_stream(op, toa, alb_dir, alb_dif):
        if lm:
            return rte_sw.sw_solver_2stream_broadband_lm(
                op.tau, op.ssa, op.g, mu0_safe, alb_dir, alb_dif, toa,
                ncol=ncol)
        solver = (rte_sw.sw_solver_2stream if output_bnd_fluxes
                  else rte_sw.sw_solver_2stream_broadband)
        return solver(op.tau, op.ssa, op.g, mu0_safe, alb_dir, alb_dif, toa)

    def two_stream_gas(tau_abs, tau_ray, incs, kdc, toa, alb_dir, alb_dif):
        """The broadband solve from the gas optics and the per-band
        increments ``incs``: the SW kernel forms tau, ssa and g itself."""
        if lm:
            return rte_sw.sw_solver_2stream_fused_broadband_lm(
                tau_abs, tau_ray, incs, kdc.gpt2band, mu0_safe, alb_dir,
                alb_dif, toa, ncol=ncol)
        return rte_sw.sw_solver_2stream_fused_broadband(
            tau_abs, tau_ray, incs, kdc.gpt2band, mu0_safe, alb_dir, alb_dif,
            toa)

    def solve_clear_sky(kdc, solve):
        """Solve the chunk's gas-only optics (``solve`` of the boundary
        inputs) into the clear-sky accumulators; returns the TOA source and
        albedos for the all-sky solve.  Its fluxes are freed here, before
        the clouds are added."""
        with _stage("sw_solve_clrsky"):
            bc = (toa_source(kdc), *albedos(kdc))
            fluxes = solve(*bc)
        with _stage("sw_fluxes_clrsky"):
            for acc, f in zip(clr, fluxes):
                acc += f
            _build.CLRSKY_GPTS["driver"] += kdc.ngpt
        return bc

    # Broadband fluxes with no optical output: the SW kernel combines the
    # gas optics and adds the increments (clouds, then aerosols) itself
    # (float64 and the CPU: the entry's twin, the plain chain), so the
    # ranges sw_combine and sw_*_increment are not entered.  By-band or
    # optical output needs the tau, ssa and g planes: the chain below.
    fused = with_fluxes and not output_bnd_fluxes and not output_optical
    incs = tuple(o for o in (cld, aer) if o is not None)
    for g0, g1 in _chunks(kd.ngpt, gpt_chunk):
        kdc = kd.slice_gpt(g0, g1)
        with _stage("sw_gas_optics"):
            if lm:
                tau_abs, tau_ray = (a.reshape(nlay * ncol, g1 - g0) for a in
                                    gas_ops.tau_majmin_and_rayleigh(kdc, *lm_in))
            else:
                tau_abs, tau_ray = gas_ops.tau_majmin_and_rayleigh(
                    kdc, interp, p_lay, t_lay, col_gas, col_dry, cellw=cellw)
        if fused:
            bc = (solve_clear_sky(kdc, functools.partial(
                two_stream_gas, tau_abs, tau_ray, (), kdc))
                  if clear_sky else None)
            with _stage("sw_solve"):
                bc = bc or (toa_source(kdc), *albedos(kdc))
                up, dn, fdir = two_stream_gas(tau_abs, tau_ray, incs, kdc,
                                              *bc)
        else:
            with _stage("sw_combine"):
                tau, ssa, g = gas_ops.combine_abs_and_rayleigh(tau_abs,
                                                               tau_ray)
                op = optics_ops.OpticalProps2str(tau=tau, ssa=ssa, g=g)
            bc = (solve_clear_sky(kdc, functools.partial(two_stream, op))
                  if clear_sky else None)
            if with_clouds:
                with _stage("sw_cloud_increment"):
                    op = optics_ops.increment_2str_by_2str_bybnd(
                        op, cld, kdc.gpt2band)
            if with_aerosols:
                with _stage("sw_aerosol_increment"):
                    op = optics_ops.increment_2str_by_2str_bybnd(
                        op, aer, kdc.gpt2band)

            with _stage("sw_solve"):
                if bc is None:
                    toa = toa_source(kdc)
                    if output_optical:
                        optical["sw_tau"].append(op.tau)
                        optical["ssa"].append(op.ssa)
                        optical["g"].append(op.g)
                        optical["toa_source"].append(toa)
                    if not with_fluxes:
                        continue
                    bc = (toa, *albedos(kdc))
                up, dn, fdir = two_stream(op, *bc)
        with _stage("sw_fluxes"):
            if not output_bnd_fluxes:
                flux_up = flux_up + up
                flux_dn = flux_dn + dn
                flux_dir = flux_dir + fdir
                continue
            flux_up = flux_up + flux_ops.sum_broadband(up)
            flux_dn = flux_dn + flux_ops.sum_broadband(dn)
            flux_dir = flux_dir + flux_ops.sum_broadband(fdir)
            bnd["up"] = bnd["up"] + flux_ops.sum_byband(up, kdc.gpt2band, nbnd)
            bnd["dn"] = bnd["dn"] + flux_ops.sum_byband(dn, kdc.gpt2band, nbnd)
            bnd["dir"] = bnd["dir"] + flux_ops.sum_byband(fdir, kdc.gpt2band,
                                                          nbnd)

    with _stage("sw_fluxes"):
        # Night columns (mu0 <= 0) get zero SW fluxes.
        day = (mu0 > 0.0).to(dtype)[:, None]
        out = {}
        if with_fluxes:
            out.update(sw_flux_up=flux_up * day, sw_flux_dn=flux_dn * day,
                       sw_flux_dn_dir=flux_dir * day,
                       sw_flux_net=(flux_dn - flux_up) * day)
        if clear_sky:
            up, dn, fdir = clr
            out.update(sw_clrsky_flux_up=up * day, sw_clrsky_flux_dn=dn * day,
                       sw_clrsky_flux_dn_dir=fdir * day,
                       sw_clrsky_flux_net=(dn - up) * day)
        if output_bnd_fluxes:
            d3 = day[:, :, None]
            out.update(sw_bnd_flux_up=bnd["up"] * d3,
                       sw_bnd_flux_dn=bnd["dn"] * d3,
                       sw_bnd_flux_dn_dir=bnd["dir"] * d3,
                       sw_bnd_flux_net=(bnd["dn"] - bnd["up"]) * d3)
        if output_optical:
            out.update({k: torch.cat(v, dim=-1) for k, v in optical.items()})
        if not top_at_1:
            out = {k: (v if k == "toa_source" else _flip_lay(v))
                   for k, v in out.items()}
    return out


class _SolverBase:
    def __init__(self, kdist: KDist, cloud_lut: Optional[CloudLUT] = None,
                 aerosol_lut: Optional[AerosolLUT] = None):
        self.kdist = kdist
        self.cloud_lut = cloud_lut
        self.aerosol_lut = aerosol_lut

    def _validate(self, p_lay, p_lev, t_lay, t_lev=None, t_sfc=None,
                  col_dry=None):
        """Host-side input range checks against the k-table bounds — the
        reference throws std::range_error on out-of-range inputs
        (src/Gas_optics_rrtmgp.cpp:813-827)."""
        kd = self.kdist

        def outside(a, lo, hi, name):
            a = _host(a)
            if a.size and ((a < lo).any() or (a > hi).any()):
                raise ValueError(
                    f"{name} is out of range [{lo:g}, {hi:g}] "
                    f"(min {a.min():g}, max {a.max():g})")

        outside(p_lay, kd.press_ref_min, kd.press_ref_max, "p_lay")
        outside(p_lev, kd.press_ref_min, kd.press_ref_max, "p_lev")
        outside(t_lay, kd.temp_ref_min, kd.temp_ref_max, "t_lay")
        if t_lev is not None:
            outside(t_lev, kd.temp_ref_min, kd.temp_ref_max, "t_lev")
        if t_sfc is not None:
            outside(t_sfc, kd.temp_ref_min, kd.temp_ref_max, "t_sfc")
        if col_dry is not None and (_host(col_dry) < 0).any():
            raise ValueError("col_dry is out of range (negative values)")

    @staticmethod
    def _dtype(dtype, p_lay) -> torch.dtype:
        """The solve's dtype: ``dtype`` (a torch or NumPy dtype), or with
        ``None`` the dtype of ``p_lay`` as given (the JAX package's
        ``dtype or jnp.asarray(p_lay).dtype``)."""
        if dtype is None:
            dtype = p_lay.dtype if torch.is_tensor(p_lay) else np.asarray(
                p_lay).dtype
        return as_torch_dtype(dtype)

    def _tensor(self, a, dtype):
        return torch.as_tensor(_host(a) if not torch.is_tensor(a) else a,
                               dtype=dtype, device=self.kdist.device)

    def _prep(self, gas_concs: GasConcs, p_lay, p_lev, dtype):
        ncol, nlay = tuple(p_lay.shape)
        vmr = gas_concs.materialize(self.kdist.gas_names, ncol, nlay,
                                    dtype=np.float64)
        return self._tensor(vmr, dtype)

    def _col_dry(self, gas_concs, p_lev, col_dry, dtype):
        if col_dry is not None:
            return self._tensor(col_dry, dtype)
        ncol, nlev = tuple(p_lev.shape)
        h2o = gas_concs.expand("h2o", ncol, nlev - 1)
        return gas_ops.get_col_dry(self._tensor(h2o, dtype),
                                   self._tensor(p_lev, dtype))

    @staticmethod
    def _detect_top(p_lay) -> bool:
        p = _host(p_lay)
        return bool(p[0, 0] < p[0, -1])


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or a NumPy dtype (``np.float32``) as its torch
    counterpart."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class RadiationSolverLW(_SolverBase):
    """Longwave: gas (+cloud) optics -> no-scattering Gauss-quadrature solve
    -> broadband / by-band fluxes."""

    def solve(self, gas_concs: GasConcs, p_lay, p_lev, t_lay, t_lev, t_sfc,
              emis_sfc, col_dry=None, lwp=None, iwp=None, rel=None, dei=None,
              gpt_chunk: Optional[int] = None, output_bnd_fluxes: bool = False,
              n_gauss_angles: int = 1, dtype=None,
              output_optical: bool = False, with_fluxes: bool = True,
              check_inputs: bool = True, cellw: Optional[bool] = None,
              layer_major: Optional[bool] = None, mesh=None) -> dict:
        """emis_sfc: (ncol, nbnd) surface emissivity per band.  Runs on the
        k-distribution's device in ``dtype`` (module docstring; ``None``:
        the dtype of ``p_lay``, so pass ``dtype=torch.float32`` with a
        NumPy float64 atmosphere to run the float32 kernels).

        Cloud fields (lwp/iwp in g m-2, rel/dei in micron) enable the
        cloudy-sky path when provided.  ``with_fluxes=False`` skips the
        solve (optical output only); ``check_inputs=False`` skips the range
        checks.  ``cellw`` / ``layer_major`` choose the layout (module
        docstring; ``None``: environment, tuned winner, default).

        ``mesh``: a cols-only ``parallel.Mesh`` runs the whole single-device
        pipeline, kernels included, on each column slab under its device
        and concatenates the outputs on the mesh's first device
        (``parallel/sharded.py``); a mesh with a ``gpt`` axis is refused."""
        dtype = self._dtype(dtype, p_lay)
        if check_inputs:
            self._validate(p_lay, p_lev, t_lay, t_lev, t_sfc, col_dry)
        top_at_1 = self._detect_top(p_lay)
        with_clouds = lwp is not None
        p_lay = self._tensor(p_lay, dtype)
        p_lev = self._tensor(p_lev, dtype)
        vmr = self._prep(gas_concs, p_lay, p_lev, dtype)
        col_dry = self._col_dry(gas_concs, p_lev, col_dry, dtype)
        zeros = torch.zeros_like(p_lay)
        cast = lambda a: self._tensor(a, dtype)
        args = (
            self.kdist, self.cloud_lut,
            p_lay, p_lev, cast(t_lay), cast(t_lev), cast(t_sfc),
            vmr, col_dry, cast(emis_sfc),
            cast(lwp) if with_clouds else zeros,
            cast(iwp) if with_clouds else zeros,
            cast(rel) if with_clouds else zeros,
            cast(dei) if with_clouds else zeros)
        statics = dict(
            top_at_1=top_at_1, gpt_chunk=gpt_chunk,
            output_bnd_fluxes=output_bnd_fluxes,
            n_gauss_angles=n_gauss_angles, with_clouds=with_clouds,
            output_optical=output_optical, with_fluxes=with_fluxes,
            cellw=cellw, layer_major=layer_major)
        if mesh is not None:
            from ..parallel.sharded import sharded_columns_call

            return sharded_columns_call(mesh, _solve_lw_impl, 2, args,
                                        statics)
        return _solve_lw_impl(*args, **statics)


class RadiationSolverSW(_SolverBase):
    """Shortwave: gas (+cloud/aerosol) optics -> two-stream adding solve ->
    broadband / by-band fluxes."""

    def solve(self, gas_concs: GasConcs, p_lay, p_lev, t_lay, mu0,
              sfc_alb_dir, sfc_alb_dif, tsi_scaling=None, col_dry=None,
              lwp=None, iwp=None, rel=None, dei=None, rh=None, aermr=None,
              gpt_chunk: Optional[int] = None, output_bnd_fluxes: bool = False,
              delta_cloud: bool = False, delta_aerosol: bool = False,
              dtype=None, output_optical: bool = False,
              with_fluxes: bool = True, check_inputs: bool = True,
              cellw: Optional[bool] = None,
              layer_major: Optional[bool] = None, mesh=None) -> dict:
        """sfc_alb_*: (ncol, nbnd); mu0: (ncol,); aermr: (ncol, nlay, 11).
        Runs on the k-distribution's device.  ``dtype``, ``with_fluxes`` and
        ``check_inputs`` as in :meth:`RadiationSolverLW.solve`; ``cellw`` /
        ``layer_major`` choose the layout (module docstring; ``None``:
        environment, tuned winner, default); ``mesh``: a cols-only mesh
        runs the solve on each column slab (see
        :meth:`RadiationSolverLW.solve`)."""
        dtype = self._dtype(dtype, p_lay)
        if check_inputs:
            self._validate(p_lay, p_lev, t_lay, col_dry=col_dry)
        top_at_1 = self._detect_top(p_lay)
        with_clouds = lwp is not None
        with_aerosols = aermr is not None
        p_lay = self._tensor(p_lay, dtype)
        p_lev = self._tensor(p_lev, dtype)
        vmr = self._prep(gas_concs, p_lay, p_lev, dtype)
        col_dry = self._col_dry(gas_concs, p_lev, col_dry, dtype)
        ncol, nlay = p_lay.shape
        zeros = torch.zeros_like(p_lay)
        zeros3 = torch.zeros((ncol, nlay, 11), dtype=dtype, device=p_lay.device)
        if tsi_scaling is None:
            tsi_scaling = torch.ones((ncol,), dtype=dtype, device=p_lay.device)
        cast = lambda a: self._tensor(a, dtype)
        args = (
            self.kdist, self.cloud_lut, self.aerosol_lut,
            p_lay, p_lev, cast(t_lay), vmr, col_dry,
            cast(sfc_alb_dir), cast(sfc_alb_dif), cast(tsi_scaling), cast(mu0),
            cast(lwp) if with_clouds else zeros,
            cast(iwp) if with_clouds else zeros,
            cast(rel) if with_clouds else zeros,
            cast(dei) if with_clouds else zeros,
            cast(rh) if with_aerosols else zeros,
            cast(aermr) if with_aerosols else zeros3)
        statics = dict(
            top_at_1=top_at_1, gpt_chunk=gpt_chunk,
            output_bnd_fluxes=output_bnd_fluxes,
            with_clouds=with_clouds, with_aerosols=with_aerosols,
            delta_cloud=delta_cloud, delta_aerosol=delta_aerosol,
            output_optical=output_optical, with_fluxes=with_fluxes,
            cellw=cellw, layer_major=layer_major)
        if mesh is not None:
            from ..parallel.sharded import sharded_columns_call

            return sharded_columns_call(mesh, _solve_sw_impl, 3, args,
                                        statics)
        return _solve_sw_impl(*args, **statics)
