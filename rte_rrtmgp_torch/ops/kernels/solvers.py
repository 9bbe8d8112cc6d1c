"""Wrappers of the broadband RTE solver kernels (``csrc/lw_sweep.cu``,
``csrc/sw_2stream.cu``).

* :func:`lw_sweep` replaces ``rte_rrtmgp_tpu/ops/pallas/solver_kernels.py:127``
  (``lw_sweep_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_lw.lw_sweep_plain`.
* :func:`sw_2stream` replaces ``solver_kernels.py:272``
  (``sw_2stream_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_plain`.
* :func:`lw_sweep_lm` and :func:`sw_2stream_lm` replace
  ``solver_layergrid.py:151`` (``lw_sweep_broadband_lm``) and ``:399``
  (``sw_2stream_broadband_lm``): the same functions on layer-major
  (nlay*ncol, G) planes with cell (c, l) at row l*ncol + c, read in place
  by the same kernel sources; their twins are
  :func:`rte_rrtmgp_torch.ops.rte_lw.lw_sweep_lm_plain` and
  :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_lm_plain`.

None needs G to be a multiple of 32 or 128, nor ncol a multiple of 8: a
block is one column and its threads are the chunk's g-points, masked past G.
"""

from __future__ import annotations

import math

import torch

from ... import config
from . import _build
from ._checks import on_cpu, require, stream_handle

MAX_G = 1024   # one thread per g-point in a block


def lw_sweep(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
             inc_flux, *, D: float, w: float):
    """One Gauss angle of the LW no-scattering solve, summed over g.
    tau/lay_src (ncol, nlay, G), lev_src (ncol, nlay+1, G), the rest
    (ncol, G).  Returns up, dn, jac each (ncol, nlay+1)."""
    if on_cpu(tau):
        from ..rte_lw import lw_sweep_plain
        return lw_sweep_plain(tau, lay_src, lev_src, sfc_emis, sfc_src,
                              sfc_src_jac, inc_flux, D, w)
    dev, f32 = tau.device, torch.float32
    ncol, nlay, G = tau.shape
    if G > MAX_G:
        raise ValueError(f"lw_sweep: G={G} exceeds {MAX_G} g-points per chunk")
    require("tau", tau, dev, f32, (ncol, nlay, G))
    require("lay_src", lay_src, dev, f32, (ncol, nlay, G))
    require("lev_src", lev_src, dev, f32, (ncol, nlay + 1, G))
    _require_lw_sfc(dev, ncol, G, sfc_emis, sfc_src, sfc_src_jac, inc_flux)
    up, dn, jac = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    rc = _build.library().rrtmgp_lw_sweep_f32(
        tau.data_ptr(), lay_src.data_ptr(), lev_src.data_ptr(),
        sfc_emis.data_ptr(), sfc_src.data_ptr(), sfc_src_jac.data_ptr(),
        inc_flux.data_ptr(), up.data_ptr(), dn.data_ptr(), jac.data_ptr(),
        ncol, nlay, G, *_lw_constants(D, w), stream_handle(dev))
    _build.check(rc, "lw_sweep")
    _build.LAUNCHES["lw_sweep"] += 1
    return up, dn, jac


def _require_lw_sfc(dev, ncol, G, *planes):
    for name, t in zip(("sfc_emis", "sfc_src", "sfc_src_jac", "inc_flux"),
                       planes):
        require(name, t, dev, torch.float32, (ncol, G))


def _lw_constants(D: float, w: float):
    """D, 2*pi*w, pi*w and tau_thres rounded to float32 as the twin rounds
    them."""
    f32 = torch.float32
    D32 = torch.tensor(D, dtype=f32).item()
    w32 = torch.tensor(w, dtype=f32).item()
    pi32 = torch.tensor(math.pi, dtype=f32)
    return (D32, 2.0 * pi32.item() * w32, (pi32 * w32).item(),
            config.tau_thres(f32))


def _nlay_lm(name, tau, ncol):
    rows, G = tau.shape
    if ncol <= 0 or rows % ncol or rows == 0:
        raise ValueError(f"{name}: {rows} layer-major rows are not a "
                         f"multiple of ncol={ncol}")
    if G > MAX_G:
        raise ValueError(f"{name}: G={G} exceeds {MAX_G} g-points per chunk")
    return rows // ncol, G


def lw_sweep_lm(tau, lay_src, lev_src, sfc_emis, sfc_src, sfc_src_jac,
                inc_flux, *, ncol: int, D: float, w: float):
    """:func:`lw_sweep` on layer-major planes: tau/lay_src (nlay*ncol, G),
    lev_src the pieces (lev0 (ncol, G), inner ((nlay-1)*ncol, G), lev_last
    (ncol, G)), the rest (ncol, G).  Returns up, dn, jac each
    (ncol, nlay+1)."""
    if on_cpu(tau):
        from ..rte_lw import lw_sweep_lm_plain
        return lw_sweep_lm_plain(tau, lay_src, lev_src, sfc_emis, sfc_src,
                                 sfc_src_jac, inc_flux, ncol, D, w)
    dev, f32 = tau.device, torch.float32
    nlay, G = _nlay_lm("lw_sweep_lm", tau, ncol)
    require("tau", tau, dev, f32, (nlay * ncol, G))
    require("lay_src", lay_src, dev, f32, (nlay * ncol, G))
    lev0, inner, last = lev_src
    require("lev_src[0]", lev0, dev, f32, (ncol, G))
    require("lev_src[1]", inner, dev, f32, ((nlay - 1) * ncol, G))
    require("lev_src[2]", last, dev, f32, (ncol, G))
    _require_lw_sfc(dev, ncol, G, sfc_emis, sfc_src, sfc_src_jac, inc_flux)
    up, dn, jac = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    rc = _build.library().rrtmgp_lw_sweep_lm_f32(
        tau.data_ptr(), lay_src.data_ptr(), lev0.data_ptr(),
        inner.data_ptr(), last.data_ptr(), sfc_emis.data_ptr(),
        sfc_src.data_ptr(), sfc_src_jac.data_ptr(), inc_flux.data_ptr(),
        up.data_ptr(), dn.data_ptr(), jac.data_ptr(), ncol, nlay, G,
        *_lw_constants(D, w), stream_handle(dev))
    _build.check(rc, "lw_sweep_lm")
    _build.LAUNCHES["lw_sweep_lm"] += 1
    return up, dn, jac


def sw_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
               inc_flux_dif=None):
    """Two-stream + adding, summed over g.  tau/ssa/g (ncol, nlay, G), mu0
    (ncol,), albedos and incident fluxes (ncol, G).  Returns up, dn
    (diffuse + direct) and dir, each (ncol, nlay+1)."""
    if on_cpu(tau):
        from ..rte_sw import sw_2stream_plain
        return sw_2stream_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                inc_flux_dir, inc_flux_dif)
    ncol, nlay, G = tau.shape
    if G > MAX_G:
        raise ValueError(f"sw_2stream: G={G} exceeds {MAX_G} g-points per chunk")
    return _sw_launch("sw_2stream", (ncol, nlay, G), ncol, nlay, G, tau, ssa,
                      g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                      inc_flux_dif)


def sw_2stream_lm(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                  inc_flux_dif=None, *, ncol: int):
    """:func:`sw_2stream` on layer-major planes: tau/ssa/g
    (nlay*ncol, G), mu0 (ncol,), albedos and incident fluxes (ncol, G).
    Returns up, dn (diffuse + direct) and dir, each (ncol, nlay+1)."""
    if on_cpu(tau):
        from ..rte_sw import sw_2stream_lm_plain
        return sw_2stream_lm_plain(tau, ssa, g, mu0, sfc_alb_dir,
                                   sfc_alb_dif, inc_flux_dir, inc_flux_dif,
                                   ncol=ncol)
    nlay, G = _nlay_lm("sw_2stream_lm", tau, ncol)
    return _sw_launch("sw_2stream_lm", (nlay * ncol, G), ncol, nlay, G, tau,
                      ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                      inc_flux_dif)


def _sw_launch(name, plane, ncol, nlay, G, tau, ssa, g, mu0, sfc_alb_dir,
               sfc_alb_dif, inc_flux_dir, inc_flux_dif):
    dev, f32 = tau.device, torch.float32
    for pname, t in (("tau", tau), ("ssa", ssa), ("g", g)):
        require(pname, t, dev, f32, plane)
    require("mu0", mu0, dev, f32, (ncol,))
    for pname, t in (("sfc_alb_dir", sfc_alb_dir),
                     ("sfc_alb_dif", sfc_alb_dif),
                     ("inc_flux_dir", inc_flux_dir)):
        require(pname, t, dev, f32, (ncol, G))
    if inc_flux_dif is not None:
        require("inc_flux_dif", inc_flux_dif, dev, f32, (ncol, G))
    up, dn, fdir = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    # rdif, tdif, and the two direct-beam sources per layer; albedo and
    # source per level, in the operands' layout.
    scratch = torch.empty(ncol * G * (4 * nlay + 2 * (nlay + 1)), dtype=f32,
                          device=dev)
    entry = getattr(_build.library(), f"rrtmgp_{name}_f32")
    rc = entry(
        tau.data_ptr(), ssa.data_ptr(), g.data_ptr(), mu0.data_ptr(),
        sfc_alb_dir.data_ptr(), sfc_alb_dif.data_ptr(),
        inc_flux_dir.data_ptr(),
        None if inc_flux_dif is None else inc_flux_dif.data_ptr(),
        up.data_ptr(), dn.data_ptr(), fdir.data_ptr(), scratch.data_ptr(),
        ncol, nlay, G, config.k_min(f32), config.eps(f32), stream_handle(dev))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return up, dn + fdir, fdir
