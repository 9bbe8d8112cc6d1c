"""Plain reference of one all-sky LW + SW broadband radiation call.

Straightforward PyTorch of the RRTMGP + RTE equations, written for the
benchmark and importing nothing of the program: it reads the raw
coefficient dicts (the file layouts of ``benchmark/inputs/tables.py``) and
the atmosphere, and works out again everything the program derives from
them: the key-species pairs of each band, the minor-absorber intervals,
the dry-air column (where the caller does not give it), the flip to
top-first order, the interpolation indices and weights.

Stages, as the reference code has them (``src_kernels_cuda/`` of
rte-rrtmgp-cpp): column gas amounts; temperature / pressure / eta
interpolation; major-gas optical depth (trilinear in temperature,
pressure and eta, times the mixed column), minor gases per interval,
Rayleigh (SW) and Planck fraction (LW); Planck sources; cloud optics from
the effective-size tables (absorption only in the LW; two-stream, with
optional delta scaling, in the SW); the combination of gas and cloud
optics; the LW no-scattering solve with one Gauss angle and the SW
two-stream adding solve; the sums over g-points.

``dtype`` is the arithmetic: float64 for the reference, a lower type for
the control.  The guards (``eps``, ``tiny``, the two-stream ``k_min``, the
LW small-tau switch) are those of the configuration's precision,
``guard_dtype`` (float32), whatever ``dtype`` is.  Two discrete
decisions are taken in the configuration's precision as well, from the
same inputs, because the result jumps where they switch: whether a layer
lies in the lower atmosphere (log p above the tropopause's: the tables
switch there), and whether a key-species ratio eta is 1 (where the minor
partner's column is below float32's resolution of the mixed column,
float32 gives eta = 1 exactly and the reference code's clamp of the eta
index puts the whole weight on the next-to-last eta node, while float64
gives eta just below 1 and the weight on the last).  The work runs in
blocks of columns so that it fits beside nothing else on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRAV = 9.80665
AVOGADRO = 6.02214076e23
M_DRY = 0.028964
M_H2O = 0.018016
SOLAR_A_OFFSET = 0.1495954
SOLAR_B_OFFSET = 0.00066696
# One Gauss angle (Hogan 2023, Table 1; src/Rte_lw.cpp:138-152).
GAUSS_D = 1.0 / 0.6096748751
GAUSS_W = 1.0


def _strings(a) -> list:
    a = np.asarray(a)
    return [b"".join(row).decode().strip("\x00 ").lower() for row in a]


class KTables:
    """One k-distribution from its raw dict, as tensors of ``dtype``, for
    the atmosphere's ``gases`` (h2o first): a minor interval whose gas the
    atmosphere lacks is left out, as RRTMGP's loader does, and so is a
    scaling gas it lacks."""

    def __init__(self, raw: dict, gases, dtype, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)
        if gases[0] != "h2o":
            raise ValueError("the reference wants h2o as the first gas")
        names = _strings(raw["gas_names"])
        # col_gas axis: 0 dry air, 1 + i the i-th gas of ``gases``.
        col = {g: gases.index(g) + 1 for g in names if g in gases}
        ks = np.asarray(raw["key_species"], np.int64)        # (nbnd, 2, 2)
        self.nbnd = ks.shape[0]
        pair = np.zeros((self.nbnd, 2, 2), np.int64)
        for b in range(self.nbnd):
            for a in range(2):
                p = tuple(ks[b, a])
                if p == (0, 0):
                    p = (2, 2)
                pair[b, a] = [col[names[k - 1]] for k in p]
        self.pair = torch.as_tensor(pair, device=device)     # col_gas indices
        # vmr_ref (ntemp, 1 + ngas_file, 2) -> (2 atm, ntemp, col_gas axis)
        vr = np.asarray(raw["vmr_ref"], np.float64)
        vref = np.zeros((2, vr.shape[0], len(gases) + 1))
        vref[:, :, 0] = vr[:, 0, :].T
        for i, g in enumerate(names):
            if g in col:
                vref[:, :, col[g]] = vr[:, i + 1, :].T
        self.vref64 = torch.as_tensor(vref, device=device)
        lims = np.asarray(raw["bnd_limits_gpt"], np.int64)
        self.ngpt = int(lims[:, 1].max())
        g2b = np.zeros(self.ngpt, np.int64)
        for b in range(self.nbnd):
            g2b[lims[b, 0] - 1:lims[b, 1]] = b
        self.gpt2band = torch.as_tensor(g2b, device=device)
        self.kmajor = t(raw["kmajor"])                       # (T, P+1, E, G)
        self.ntemp, self.np1, self.neta, _ = self.kmajor.shape
        press_ref = np.asarray(raw["press_ref"], np.float64).reshape(-1)
        temp_ref = np.asarray(raw["temp_ref"], np.float64).reshape(-1)
        self.log_p0 = float(np.log(press_ref[0]))
        self.dlog_p = float((np.log(press_ref[-1]) - np.log(press_ref[0]))
                            / (press_ref.size - 1))
        self.npress = press_ref.size
        self.t_min = float(temp_ref[0])
        self.t_max = float(temp_ref[-1])
        self.dt = (self.t_max - self.t_min) / (temp_ref.size - 1)
        self.temp_ref = t(temp_ref)
        self.trop_log = float(np.log(np.asarray(
            raw["press_ref_trop"]).reshape(-1)[0]))
        self.minor = []   # (atm, g0, g1, table (T, E, ng), gas, sc gas, swd, sbc)
        ident = _strings(raw["identifier_minor"])
        gas_minor = _strings(raw["gas_minor"])
        for a, suf in enumerate(("lower", "upper")):
            kmin = np.asarray(raw[f"kminor_{suf}"], np.float64)
            mlims = np.asarray(raw[f"minor_limits_gpt_{suf}"], np.int64)
            start = np.asarray(raw[f"kminor_start_{suf}"], np.int64).reshape(-1)
            swd = np.asarray(raw[f"minor_scales_with_density_{suf}"]).reshape(-1)
            sbc = np.asarray(raw[f"scale_by_complement_{suf}"]).reshape(-1)
            sgas = _strings(raw[f"scaling_gas_{suf}"])
            for i, idn in enumerate(_strings(raw[f"minor_gases_{suf}"])):
                gas = gas_minor[ident.index(idn)]
                if gas not in col:
                    continue
                g0, g1 = int(mlims[i, 0] - 1), int(mlims[i, 1])
                tab = kmin[:, :, start[i] - 1:start[i] - 1 + (g1 - g0)]
                self.minor.append((a, g0, g1, t(tab), col[gas],
                                   col.get(sgas[i], 0), bool(swd[i]),
                                   bool(sbc[i])))
        self.lw = "totplnk" in raw
        if self.lw:
            self.planck = t(raw["plank_fraction"])           # (T, P+1, E, G)
            self.totplnk = t(np.asarray(raw["totplnk"]).T)   # (nT, nbnd)
            self.dt_planck = ((self.t_max - self.t_min)
                              / (self.totplnk.shape[0] - 1))
        else:
            self.rayl = t(np.stack([raw["rayl_lower"], raw["rayl_upper"]]))
            mg = float(np.asarray(raw["mg_default"]).reshape(-1)[0])
            sb = float(np.asarray(raw["sb_default"]).reshape(-1)[0])
            self.solar = t(np.asarray(raw["solar_source_quiet"])
                           + (mg - SOLAR_A_OFFSET)
                           * np.asarray(raw["solar_source_facular"])
                           + (sb - SOLAR_B_OFFSET)
                           * np.asarray(raw["solar_source_sunspot"]))


class CloudTables:
    """Effective-size cloud tables from their raw dict: liquid as given,
    ice at roughness category 2 (src/Cloud_optics.cpp:56-68); each
    (nsize, nbnd)."""

    def __init__(self, raw: dict, dtype, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)
        s = lambda k: float(np.asarray(raw[k]).reshape(-1)[0])
        self.liq = [t(np.asarray(raw[k]).T) for k in
                    ("lut_extliq", "lut_ssaliq", "lut_asyliq")]
        self.ice = [t(np.asarray(raw[k])[1].T) for k in
                    ("lut_extice", "lut_ssaice", "lut_asyice")]
        nl, ni = self.liq[0].shape[0], self.ice[0].shape[0]
        self.liq_grid = (s("radliq_lwr"), (s("radliq_upr") - s("radliq_lwr"))
                         / (nl - 1), nl)
        self.ice_grid = (s("diamice_lwr"), (s("diamice_upr")
                                            - s("diamice_lwr")) / (ni - 1), ni)


class Tables:
    """The four raw dicts of one configuration, on ``device`` in ``dtype``,
    for the atmosphere's ``gases``."""

    def __init__(self, raws: dict, gases, dtype=torch.float64, device="cpu"):
        gases = tuple(gases)
        self.kd_lw = KTables(raws["kd_lw"], gases, dtype, device)
        self.kd_sw = KTables(raws["kd_sw"], gases, dtype, device)
        self.cl_lw = CloudTables(raws["cloud_lw"], dtype, device)
        self.cl_sw = CloudTables(raws["cloud_sw"], dtype, device)


class _Guards:
    def __init__(self, guard_dtype):
        fi = torch.finfo(guard_dtype)
        self.eps, self.tiny = float(fi.eps), float(fi.tiny)
        self.k_min = 1.0e-12 if guard_dtype == torch.float64 else 1.0e-4
        self.tau_thres = math.sqrt(math.sqrt(self.eps))


def col_dry(h2o, p_lev):
    """Hydrostatic dry-air column (src/Gas_optics_rrtmgp.cpp:764-792)."""
    dp = torch.abs(p_lev[:, :-1] - p_lev[:, 1:])
    m_air = (M_DRY + M_H2O * h2o) / (1.0 + h2o)
    return 10.0 * dp * AVOGADRO / (1000.0 * m_air * 100.0 * GRAV) / (1.0 + h2o)


def _by_g(x, gpt2band):
    """(..., nbnd) -> (..., ngpt)."""
    return x.index_select(-1, gpt2band)


class _Interp:
    """Interpolation state of a block of cells for one k-distribution:
    indices, per-band eta and weights, all (B, L[, nbnd][, 2])."""

    def __init__(self, kd: KTables, p, t, p32, col_gas, col_gas32,
                 gd: _Guards):
        self.kd = kd
        jt = torch.clamp(((t - (kd.t_min - kd.dt)) / kd.dt).floor().long(),
                         1, kd.ntemp - 1)
        self.jt0 = jt - 1
        self.ft = (t - kd.temp_ref[self.jt0]) / kd.dt
        locp = 1.0 + (torch.log(p) - kd.log_p0) / kd.dlog_p
        jp = torch.clamp(locp.floor().long(), 1, kd.npress - 1)
        self.fp = locp - jp.to(p.dtype)
        self.tropo = torch.log(p32) > kd.trop_log
        self.itrop = (~self.tropo).long()
        self.jp0 = jp - 1 + self.itrop         # row of the k tables' p axis
        # Key-species pair of each band in each cell's atmosphere.
        pair = kd.pair[:, 0, :][None, None] * self.tropo[..., None, None] \
            + kd.pair[:, 1, :][None, None] * (~self.tropo)[..., None, None]
        cg1 = torch.gather(col_gas, 2, pair[..., 0])           # (B, L, nbnd)
        cg2 = torch.gather(col_gas, 2, pair[..., 1])
        c32 = [torch.gather(col_gas32, 2, pair[..., k]) for k in range(2)]
        je, fe, cm = [], [], []
        for i in range(2):
            tt = (self.jt0 + i)[..., None].expand_as(pair[..., 0])
            a = self.itrop[..., None].expand_as(tt)
            v1 = kd.vref64[a, tt, pair[..., 0]]
            v2 = kd.vref64[a, tt, pair[..., 1]]
            ratio = (v1 / v2).to(cg1.dtype)
            mix = cg1 + ratio * cg2
            eta = torch.where(mix > 2.0 * gd.tiny, cg1 / torch.where(
                mix > 2.0 * gd.tiny, mix, 1.0), 0.5)
            loc = eta * (kd.neta - 1)
            j, f = loc.floor(), loc - loc.floor()
            # eta = 1 in the configuration's precision: the weight goes
            # whole to the next-to-last eta node (jeta's clamp).
            mix32 = c32[0] + (v1 / v2).to(col_gas32.dtype) * c32[1]
            eta32 = torch.where(mix32 > 2.0 * gd.tiny, c32[0] / torch.where(
                mix32 > 2.0 * gd.tiny, mix32, 1.0), 0.5)
            at_end = eta32 * (kd.neta - 1) >= kd.neta - 1
            je.append(torch.where(at_end, kd.neta - 2,
                                  torch.clamp(j.long(), max=kd.neta - 2)))
            fe.append(torch.where(at_end, 0.0, f))
            cm.append(mix)
        self.je0, self.fe, self.colmix = je, fe, cm

    def ftemp(self, i):
        return (1.0 - self.ft) if i == 0 else self.ft

    def trilinear(self, table, scale_by_colmix: bool, g2b):
        """Σ over 2 temperatures x 2 pressures x 2 eta of weight x table
        (T, P+1, E, G), per g-point: (B, L, G)."""
        kd = self.kd
        G = table.shape[-1]
        flat = table.reshape(-1)
        g = torch.arange(G, device=table.device)
        out = 0.0
        for i in range(2):
            je = _by_g(self.je0[i], g2b)
            fe = _by_g(self.fe[i], g2b)
            acc = 0.0
            for dp in range(2):
                fpw = (1.0 - self.fp) if dp == 0 else self.fp
                row = ((self.jt0 + i) * kd.np1 + (self.jp0 + dp))[..., None]
                base = (row * kd.neta + je) * G + g
                acc = acc + fpw[..., None] * ((1.0 - fe) * flat[base]
                                              + fe * flat[base + G])
            acc = acc * self.ftemp(i)[..., None]
            if scale_by_colmix:
                acc = acc * _by_g(self.colmix[i], g2b)
            out = out + acc
        return out

    def bilinear_te(self, table, atm, g_idx, b_idx):
        """Σ over 2 temperatures x 2 eta of weight x table (T, E, n) for the
        columns ``g_idx`` of the table, with the eta of band ``b_idx``
        (per column): (B, L, n)."""
        out = 0.0
        for i in range(2):
            je = self.je0[i].index_select(-1, b_idx)
            fe = self.fe[i].index_select(-1, b_idx)
            t_i = (self.jt0 + i)[..., None]
            lo = table[t_i, je, g_idx]
            hi = table[t_i, je + 1, g_idx]
            out = out + self.ftemp(i)[..., None] * ((1.0 - fe) * lo + fe * hi)
        return out


def _gas_tau(kd: KTables, ip: _Interp, p, t, col_gas):
    """Major + minor absorption optical depth (B, L, G)."""
    tau = ip.trilinear(kd.kmajor, True, kd.gpt2band)
    for atm, g0, g1, tab, gas, sgas, swd, sbc in kd.minor:
        sc = col_gas[..., gas]
        if swd:
            sc = sc * (0.01 * p / t)
            if sgas > 0:
                vmr_fact = 1.0 / col_gas[..., 0]
                dry_fact = 1.0 / (1.0 + col_gas[..., 1] * vmr_fact)
                sx = col_gas[..., sgas] * vmr_fact * dry_fact
                sc = sc * ((1.0 - sx) if sbc else sx)
        mask = ip.tropo if atm == 0 else ~ip.tropo
        sc = torch.where(mask, sc, 0.0)
        n = g1 - g0
        cols = torch.arange(n, device=p.device)
        band = kd.gpt2band[g0:g1]
        tau[..., g0:g1] = tau[..., g0:g1] + ip.bilinear_te(
            tab, atm, cols, band) * sc[..., None]
    return tau


def _planck_band(kd: KTables, temp):
    """Band Planck radiance from ``totplnk`` (interpolate1D): temp.shape +
    (nbnd,)."""
    nT = kd.totplnk.shape[0]
    v = (temp - kd.t_min) / kd.dt_planck
    iv = v.floor()
    frac = (v - iv)[..., None]
    idx = torch.clamp(iv.long() + 1, 1, nT - 1)
    lo, hi = kd.totplnk[idx - 1], kd.totplnk[idx]
    return lo + frac * (hi - lo)


def _cloud_lut(cwp, re, grid, tabs):
    """Per-band (tau, tau*ssa[, tau*ssa*g]) from one effective-size table
    set, zero where there is no water."""
    lwr, step, n = grid
    pos = (re - lwr) / step
    idx = torch.clamp(pos.floor().long() + 1, max=n - 1)
    f = (pos - (idx - 1).to(pos.dtype))[..., None]
    lo, hi = torch.clamp(idx - 1, min=0), torch.clamp(idx, min=0)
    vals = [tb[lo] + f * (tb[hi] - tb[lo]) for tb in tabs]
    has = (cwp > 0.0)[..., None]
    tau = torch.where(has, cwp[..., None] * vals[0], 0.0)
    out = [tau, torch.where(has, tau * vals[1], 0.0)]
    if len(tabs) == 3:
        out.append(torch.where(has, out[1] * vals[2], 0.0))
    return out


def _lw_block(tb: Tables, x: dict, gd: _Guards):
    kd = tb.kd_lw
    p, t = x["p_lay"], x["t_lay"]
    ip = _Interp(kd, p, t, x["p32"], x["col_gas"], x["col_gas32"], gd)
    tau = _gas_tau(kd, ip, p, t, x["col_gas"])
    pfrac = ip.trilinear(kd.planck, False, kd.gpt2band)
    g2b = kd.gpt2band
    # Clouds: absorption optical depth tau - tau*ssa per band.
    lt, lts = _cloud_lut(x["lwp"], x["rel"], tb.cl_lw.liq_grid, tb.cl_lw.liq[:2])
    it, its = _cloud_lut(x["iwp"], x["dei"], tb.cl_lw.ice_grid, tb.cl_lw.ice[:2])
    tau = tau + _by_g((lt - lts) + (it - its), g2b)
    # Planck sources, top at layer 0.
    nlay = p.shape[1]
    lay_src = pfrac * _by_g(_planck_band(kd, t), g2b)
    blev = _by_g(_planck_band(kd, x["t_lev"]), g2b)
    lev_src = torch.cat([pfrac[:, :1] * blev[:, :1],
                         torch.sqrt(pfrac[:, 1:] * pfrac[:, :-1])
                         * blev[:, 1:nlay],
                         pfrac[:, -1:] * blev[:, nlay:]], dim=1)
    sfc_src = pfrac[:, -1] * _by_g(_planck_band(kd, x["t_sfc"]), g2b)
    emis = _by_g(x["emis_sfc"], g2b)
    # No-scattering solve, one Gauss angle (rte_solver_kernels.cu:35-193).
    D = float(np.float32(GAUSS_D))
    tau_loc = tau * D
    trans = torch.exp(-tau_loc)
    fact = torch.where(tau_loc > gd.tau_thres,
                       (1.0 - trans) / torch.where(tau_loc > 0.0, tau_loc, 1.0)
                       - trans,
                       tau_loc * (0.5 + tau_loc * (-1.0 / 3.0
                                                   + tau_loc * (1.0 / 8.0))))
    src_dn = (1.0 - trans) * lev_src[:, 1:] + 2.0 * fact * (lay_src
                                                            - lev_src[:, 1:])
    src_up = (1.0 - trans) * lev_src[:, :-1] + 2.0 * fact * (lay_src
                                                             - lev_src[:, :-1])
    rad = torch.zeros_like(sfc_src)
    dn = [rad.sum(-1)]
    for l in range(nlay):
        rad = trans[:, l] * rad + src_dn[:, l]
        dn.append(rad.sum(-1))
    up_l = rad * (1.0 - emis) + emis * sfc_src
    up = [up_l.sum(-1)]
    for l in range(nlay - 1, -1, -1):
        up_l = trans[:, l] * up_l + src_up[:, l]
        up.append(up_l.sum(-1))
    scale = math.pi * GAUSS_W
    flux_up = scale * torch.stack(up[::-1], dim=1)
    flux_dn = scale * torch.stack(dn, dim=1)
    return {"lw_flux_up": flux_up, "lw_flux_dn": flux_dn,
            "lw_flux_net": flux_dn - flux_up}


def _sw_block(tb: Tables, x: dict, gd: _Guards, delta_cloud: bool):
    kd = tb.kd_sw
    p, t, cg = x["p_lay"], x["t_lay"], x["col_gas"]
    ip = _Interp(kd, p, t, x["p32"], cg, x["col_gas32"], gd)
    g2b = kd.gpt2band
    tau_abs = _gas_tau(kd, ip, p, t, cg)
    # Rayleigh: 2 temperatures x 2 eta on the table of the cell's atmosphere.
    G = kd.ngpt
    g = torch.arange(G, device=p.device)
    kloc = 0.0
    for i in range(2):
        je = _by_g(ip.je0[i], g2b)
        fe = _by_g(ip.fe[i], g2b)
        a = ip.itrop[..., None]
        t_i = (ip.jt0 + i)[..., None]
        kloc = kloc + ip.ftemp(i)[..., None] * (
            (1.0 - fe) * kd.rayl[a, t_i, je, g]
            + fe * kd.rayl[a, t_i, je + 1, g])
    tau_ray = kloc * (cg[..., 1] + cg[..., 0])[..., None]
    tau_g = tau_abs + tau_ray
    ssa_g = torch.where(tau_g > 2.0 * gd.eps, tau_ray / torch.where(
        tau_g == 0.0, 1.0, tau_g), 0.0)
    # Clouds: two-stream per band, optionally delta-scaled.
    lt, lts, ltsg = _cloud_lut(x["lwp"], x["rel"], tb.cl_sw.liq_grid,
                               tb.cl_sw.liq)
    it, its, itsg = _cloud_lut(x["iwp"], x["dei"], tb.cl_sw.ice_grid,
                               tb.cl_sw.ice)
    ctau, cts = lt + it, lts + its
    cssa = cts / torch.clamp(ctau, min=gd.eps)
    cg_ = (ltsg + itsg) / torch.clamp(cts, min=gd.eps)
    if delta_cloud:
        f = cg_ * cg_
        wf = cssa * f
        ctau = ctau * (1.0 - wf)
        cssa = (cssa - wf) / torch.clamp(1.0 - wf, min=gd.eps)
        cg_ = (cg_ - f) / torch.clamp(1.0 - f, min=gd.eps)
    ctau, cssa, cg_ = (_by_g(a, g2b) for a in (ctau, cssa, cg_))
    # Gas (asymmetry 0) plus cloud.
    tau = tau_g + ctau
    tsc = tau_g * ssa_g + ctau * cssa
    asy = (ctau * cssa * cg_) / torch.clamp(tsc, min=gd.eps)
    ssa = tsc / torch.clamp(tau, min=gd.eps)
    # Two-stream coefficients (Meador-Weaver, rte_solver_kernels.cu:543-592).
    mu0 = x["mu0"]
    mu0s = torch.where(mu0 > 0.0, mu0, 1.0)[:, None, None]
    g1 = (8.0 - ssa * (5.0 + 3.0 * asy)) * 0.25
    g2 = 3.0 * (ssa * (1.0 - asy)) * 0.25
    g3 = (2.0 - 3.0 * mu0s * asy) * 0.25
    g4 = 1.0 - g3
    a1 = g1 * g4 + g2 * g3
    a2 = g1 * g3 + g2 * g4
    k = torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=gd.k_min))
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
    r_dif = rt * g2 * (1.0 - e2)
    t_dif = rt * 2.0 * k * e1
    t_ns = torch.exp(-tau / mu0s)
    kmu = k * mu0s
    om = 1.0 - kmu * kmu
    om = torch.where(torch.abs(om) > gd.eps, om, gd.eps)
    rt2 = ssa * rt / om
    r_dir = rt2 * ((1.0 - kmu) * (a2 + k * g3) - (1.0 + kmu) * (a2 - k * g3)
                   * e2 - 2.0 * (k * g3 - a2 * kmu) * e1 * t_ns)
    t_dir = -rt2 * ((1.0 + kmu) * (a1 + k * g4) * t_ns - (1.0 - kmu)
                    * (a1 - k * g4) * e2 * t_ns - 2.0 * (k * g4 + a1 * kmu) * e1)
    r_dir = torch.clamp(torch.minimum(r_dir, 1.0 - t_ns), min=gd.eps)
    t_dir = torch.clamp(torch.minimum(t_dir, 1.0 - t_ns - r_dir), min=gd.eps)
    # Direct beam, then the adding sweeps.
    nlay = p.shape[1]
    toa = kd.solar[None, :] * x["tsi_scaling"][:, None]
    fdir = [toa * mu0s[:, 0]]
    for l in range(nlay):
        fdir.append(fdir[-1] * t_ns[:, l])
    alb_dir = _by_g(x["sfc_alb_dir"], g2b)
    alb = [None] * (nlay + 1)
    src = [None] * (nlay + 1)
    den = [None] * nlay
    alb[nlay] = _by_g(x["sfc_alb_dif"], g2b)
    src[nlay] = fdir[nlay] * alb_dir
    for l in range(nlay - 1, -1, -1):
        d = 1.0 / (1.0 - r_dif[:, l] * alb[l + 1])
        alb[l] = r_dif[:, l] + t_dif[:, l] ** 2 * alb[l + 1] * d
        src[l] = r_dir[:, l] * fdir[l] + t_dif[:, l] * d * (
            src[l + 1] + alb[l + 1] * t_dir[:, l] * fdir[l])
        den[l] = d
    dn = torch.zeros_like(toa)
    up_s, dn_s, dir_s = [], [], []
    for l in range(nlay + 1):
        if l > 0:
            dn = (t_dif[:, l - 1] * dn + r_dif[:, l - 1] * src[l]
                  + t_dir[:, l - 1] * fdir[l - 1]) * den[l - 1]
        up_s.append((dn * alb[l] + src[l]).sum(-1))
        dn_s.append((dn + fdir[l]).sum(-1))
        dir_s.append(fdir[l].sum(-1))
    day = (mu0 > 0.0).to(tau.dtype)[:, None]
    up, dnf, dr = (torch.stack(s, dim=1) * day for s in (up_s, dn_s, dir_s))
    return {"sw_flux_up": up, "sw_flux_dn": dnf, "sw_flux_dn_dir": dr,
            "sw_flux_net": dnf - up}


def fluxes(tables: Tables, inp: dict, *, delta_cloud: bool,
           dtype=torch.float64, guard_dtype=torch.float32,
           block_cells: int = 1 << 26) -> dict:
    """Broadband fluxes of one call: {lw_flux_up, lw_flux_dn, lw_flux_net,
    sw_flux_up, sw_flux_dn, sw_flux_dn_dir, sw_flux_net}, each (ncol,
    nlev) float64 NumPy in the inputs' vertical order.

    ``inp`` holds NumPy arrays: p_lay, p_lev, t_lay, t_lev (ncol, nlay[+1]),
    t_sfc (ncol,), vmr (ncol, nlay, ngas) in the order of the ``gases``
    the tables were built for, col_dry
    (ncol, nlay) or None (then worked out from h2o and p_lev), emis_sfc
    (ncol, 16), sfc_alb_dir / sfc_alb_dif (ncol, 14), tsi_scaling, mu0
    (ncol,), lwp, iwp, rel, dei (ncol, nlay).  ``tables`` fixes the device
    and ``dtype`` must match its tables."""
    dev = tables.kd_lw.kmajor.device
    gd = _Guards(guard_dtype)
    ncol, nlay = np.shape(inp["p_lay"])
    p = np.asarray(inp["p_lay"])
    flip = p[0, 0] > p[0, -1]      # bottom-up input: solve top-first
    ngpt = max(tables.kd_lw.ngpt, tables.kd_sw.ngpt)
    step = max(1, min(ncol, block_cells // (nlay * ngpt)))
    out = {}
    for c0 in range(0, ncol, step):
        c1 = min(ncol, c0 + step)
        x = {}
        for k in ("p_lay", "p_lev", "t_lay", "t_lev", "vmr", "lwp", "iwp",
                  "rel", "dei", "col_dry"):
            if inp.get(k) is None:
                continue
            a = torch.as_tensor(np.asarray(inp[k])[c0:c1]).to(dev)
            x[k] = torch.flip(a, dims=(1,)) if flip else a
        # The configuration's precision, for its two decisions.
        x32 = {k: x[k].to(guard_dtype) for k in ("p_lay", "p_lev", "vmr")}
        cd32 = (x["col_dry"].to(guard_dtype) if "col_dry" in x
                else col_dry(x32["vmr"][..., 0], x32["p_lev"]))
        x["p32"] = x32["p_lay"]
        x["col_gas32"] = torch.cat([cd32[..., None], x32["vmr"]
                                    * cd32[..., None]], dim=2)
        x = {k: (v if k in ("p32", "col_gas32") else v.to(dtype))
             for k, v in x.items()}
        for k in ("t_sfc", "emis_sfc", "sfc_alb_dir", "sfc_alb_dif",
                  "tsi_scaling", "mu0"):
            x[k] = torch.as_tensor(np.asarray(inp[k])[c0:c1]).to(
                device=dev, dtype=dtype)
        vmr = x["vmr"]
        cd = x.get("col_dry")
        if cd is None:
            cd = col_dry(vmr[..., 0], x["p_lev"])
        x["col_gas"] = torch.cat([cd[..., None], vmr * cd[..., None]], dim=2)
        res = {**_lw_block(tables, x, gd),
               **_sw_block(tables, x, gd, delta_cloud)}
        for k, v in res.items():
            v = torch.flip(v, dims=(1,)) if flip else v
            out.setdefault(k, []).append(v.to(torch.float64).cpu().numpy())
        del x, res
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def outputs(raws: dict, inputs: dict, options: dict, device,
            dtype=torch.float64) -> dict:
    """:func:`fluxes` from the raw dicts, the harness's entry point:
    ``inputs`` names its ``gases`` (the order of ``vmr``'s last axis);
    ``options`` holds the call's ``delta_cloud`` and ``guard_dtype``, the
    configuration's precision."""
    return fluxes(Tables(raws, inputs["gases"], dtype, device), inputs,
                  delta_cloud=options["delta_cloud"], dtype=dtype,
                  guard_dtype=options["guard_dtype"])
