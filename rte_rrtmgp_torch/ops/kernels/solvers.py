"""Wrappers of the broadband RTE solver kernels (``csrc/lw_sweep.cu``,
``csrc/sw_2stream.cu``).

* :func:`lw_sweep` replaces ``rte_rrtmgp_tpu/ops/pallas/solver_kernels.py:127``
  (``lw_sweep_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_lw.lw_sweep_plain`.
* :func:`sw_2stream` replaces ``solver_kernels.py:272``
  (``sw_2stream_broadband``); its plain twin is
  :func:`rte_rrtmgp_torch.ops.rte_sw.sw_2stream_plain`.

Neither needs G to be a multiple of 32 or 128: a block is one column and
its threads are the chunk's g-points, masked past G.
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
    for name, t in (("sfc_emis", sfc_emis), ("sfc_src", sfc_src),
                    ("sfc_src_jac", sfc_src_jac), ("inc_flux", inc_flux)):
        require(name, t, dev, f32, (ncol, G))
    # D, w and the derived constants rounded to float32 as the twin rounds them.
    D32 = torch.tensor(D, dtype=f32).item()
    w32 = torch.tensor(w, dtype=f32).item()
    pi32 = torch.tensor(math.pi, dtype=f32)
    two_pi_w = 2.0 * pi32.item() * w32
    scale = (pi32 * w32).item()
    up, dn, jac = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    rc = _build.library().rrtmgp_lw_sweep_f32(
        tau.data_ptr(), lay_src.data_ptr(), lev_src.data_ptr(),
        sfc_emis.data_ptr(), sfc_src.data_ptr(), sfc_src_jac.data_ptr(),
        inc_flux.data_ptr(), up.data_ptr(), dn.data_ptr(), jac.data_ptr(),
        ncol, nlay, G, D32, two_pi_w, scale, config.tau_thres(f32),
        stream_handle(dev))
    _build.check(rc, "lw_sweep")
    _build.LAUNCHES["lw_sweep"] += 1
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
    dev, f32 = tau.device, torch.float32
    ncol, nlay, G = tau.shape
    if G > MAX_G:
        raise ValueError(f"sw_2stream: G={G} exceeds {MAX_G} g-points per chunk")
    for name, t in (("tau", tau), ("ssa", ssa), ("g", g)):
        require(name, t, dev, f32, (ncol, nlay, G))
    require("mu0", mu0, dev, f32, (ncol,))
    for name, t in (("sfc_alb_dir", sfc_alb_dir), ("sfc_alb_dif", sfc_alb_dif),
                    ("inc_flux_dir", inc_flux_dir)):
        require(name, t, dev, f32, (ncol, G))
    if inc_flux_dif is not None:
        require("inc_flux_dif", inc_flux_dif, dev, f32, (ncol, G))
    up, dn, fdir = torch.empty((3, ncol, nlay + 1), dtype=f32, device=dev)
    # rdif, tdif, and the two direct-beam sources per layer; albedo and
    # source per level.
    scratch = torch.empty(ncol * G * (4 * nlay + 2 * (nlay + 1)), dtype=f32,
                          device=dev)
    rc = _build.library().rrtmgp_sw_2stream_f32(
        tau.data_ptr(), ssa.data_ptr(), g.data_ptr(), mu0.data_ptr(),
        sfc_alb_dir.data_ptr(), sfc_alb_dif.data_ptr(),
        inc_flux_dir.data_ptr(),
        None if inc_flux_dif is None else inc_flux_dif.data_ptr(),
        up.data_ptr(), dn.data_ptr(), fdir.data_ptr(), scratch.data_ptr(),
        ncol, nlay, G, config.k_min(f32), config.eps(f32), stream_handle(dev))
    _build.check(rc, "sw_2stream")
    _build.LAUNCHES["sw_2stream"] += 1
    return up, dn + fdir, fdir
