"""Port gas optics vs the JAX package, in float64 on the CPU.

The JAX side runs its XLA path (``use_pallas()`` is False off TPU); the port
runs its plain PyTorch path, which for CPU tensors includes the twin of the
gas-optics kernel (``majmin_plain``).  Both get the same inputs, made from a
seed with NumPy, and the same tables.  Tolerance: rtol 1e-10 (the two
differ only in the order of float64 sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rte_rrtmgp_tpu.models.kdist import KDist as JKDist
from rte_rrtmgp_tpu.ops import gas_optics as jgo

from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.models.kdist import KDist
from rte_rrtmgp_torch.ops import gas_optics as go

torch.set_num_threads(2)

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
RTOL = 1e-10
NCOL, NLAY = 6, 10


def close(a, b, rtol=RTOL, atol=0.0, name=""):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.fixture(scope="module")
def case():
    """Tables (both packages, f64) and a top-at-0 atmosphere."""
    kds = {}
    for lw in (True, False):
        raw = synthetic.make_kdist_raw(lw, gpt_per_band=2)
        kds[lw] = (KDist.from_raw(raw, GASES, dtype=torch.float64, device="cpu"),
                   JKDist.from_raw(raw, GASES, dtype=np.float64))
    atm = make_atmosphere(NCOL, NLAY, seed=11)
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])
    vmr = flip(atm["gas_concs"].materialize(GASES, NCOL, NLAY))
    arrs = dict(play=flip(atm["p_lay"]), plev=flip(atm["p_lev"]),
                tlay=flip(atm["t_lay"]), tlev=flip(atm["t_lev"]),
                tsfc=atm["t_sfc"], vmr=vmr)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t["col_dry"] = go.get_col_dry(t["vmr"][:, :, 0], t["plev"])
    j["col_dry"] = jgo.get_col_dry(j["vmr"][:, :, 0], j["plev"])
    t["col_gas"] = go.build_col_gas(t["vmr"], t["col_dry"])
    j["col_gas"] = jgo.build_col_gas(j["vmr"], j["col_dry"])
    return kds, t, j


def test_col_dry_and_col_gas(case):
    _, t, j = case
    close(t["col_dry"], j["col_dry"], name="col_dry")
    close(t["col_gas"], j["col_gas"], name="col_gas")


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_interpolation(case, longwave):
    kds, t, j = case
    kd, jkd = kds[longwave]
    it = go.interpolation(kd, t["play"], t["tlay"], t["col_gas"])
    jit_ = jgo.interpolation(jkd, j["play"], j["tlay"], j["col_gas"])
    for f in ("jtemp0", "jpress0", "tropo", "itropo01", "jeta0"):
        np.testing.assert_array_equal(getattr(it, f).numpy(),
                                      np.asarray(getattr(jit_, f)), err_msg=f)
    for f in ("fpress", "col_mix", "fminor", "fmajor"):
        close(getattr(it, f), getattr(jit_, f), name=f)


# Chunk [0, 16) holds minor intervals, the rest of the spectrum none.
CHUNKS = {"minor": (0, 16), "no_minor": (16, 28)}


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_tau_majmin_and_pfrac(case, chunk):
    kds, t, j = case
    kd, jkd = kds[True]
    kdc, jkdc = kd.slice_gpt(*CHUNKS[chunk]), jkd.slice_gpt(*CHUNKS[chunk])
    assert bool(kdc.minor_lower or kdc.minor_upper) == (chunk == "minor")
    it = go.interpolation(kd, t["play"], t["tlay"], t["col_gas"])
    jit_ = jgo.interpolation(jkd, j["play"], j["tlay"], j["col_gas"])
    tau, pfrac = go.tau_majmin_and_pfrac(kdc, it, t["play"], t["tlay"],
                                         t["col_gas"])
    jtau, jpfrac = jgo.tau_majmin_and_pfrac(jkdc, jit_, j["play"], j["tlay"],
                                            j["col_gas"])
    close(tau, jtau, name="tau")
    close(pfrac, jpfrac, name="pfrac")


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_tau_majmin_and_rayleigh(case, chunk):
    kds, t, j = case
    kd, jkd = kds[False]
    kdc, jkdc = kd.slice_gpt(*CHUNKS[chunk]), jkd.slice_gpt(*CHUNKS[chunk])
    it = go.interpolation(kd, t["play"], t["tlay"], t["col_gas"])
    jit_ = jgo.interpolation(jkd, j["play"], j["tlay"], j["col_gas"])
    tau, ray = go.tau_majmin_and_rayleigh(kdc, it, t["play"], t["tlay"],
                                          t["col_gas"], t["col_dry"])
    jtau, jray = jgo.tau_majmin_and_rayleigh(jkdc, jit_, j["play"], j["tlay"],
                                             j["col_gas"], j["col_dry"])
    close(tau, jtau, name="tau_abs")
    close(ray, jray, name="tau_rayleigh")
    tt, ts, tg = go.combine_abs_and_rayleigh(tau, ray)
    jt_, js, jg = jgo.combine_abs_and_rayleigh(jtau, jray)
    close(tt, jt_, name="tau")
    close(ts, js, name="ssa")
    close(tg, jg, name="g")


def test_unmerged_pieces_match_merged_twin(case):
    """tau_major + tau_minor, planck_fraction and tau_rayleigh (the separate
    plain functions) agree with the JAX functions of the same names."""
    kds, t, j = case
    for lw in (True, False):
        kd, jkd = kds[lw]
        it = go.interpolation(kd, t["play"], t["tlay"], t["col_gas"])
        jit_ = jgo.interpolation(jkd, j["play"], j["tlay"], j["col_gas"])
        tau = go.tau_minor(kd, it, t["play"], t["tlay"], t["col_gas"],
                           go.tau_major(kd, it))
        jtau = jgo.tau_minor(jkd, jit_, j["play"], j["tlay"], j["col_gas"],
                             jgo.tau_major(jkd, jit_))
        close(tau, jtau, name="tau")
        if lw:
            close(go.planck_fraction(kd, it),
                  jgo._interp3d_rows(jkd, jkd.planck_rows, jit_, False),
                  name="pfrac")
        else:
            close(go.tau_rayleigh(kd, it, t["col_gas"], t["col_dry"]),
                  jgo.tau_rayleigh(jkd, jit_, j["col_gas"], j["col_dry"]),
                  name="tau_rayleigh")


@pytest.mark.parametrize("chunk", [None, (0, 16)], ids=["whole", "chunk0"])
def test_planck_source(case, chunk):
    kds, t, j = case
    kd, jkd = kds[True]
    it = go.interpolation(kd, t["play"], t["tlay"], t["col_gas"])
    jit_ = jgo.interpolation(jkd, j["play"], j["tlay"], j["col_gas"])
    if chunk is not None:
        kd, jkd = kd.slice_gpt(*chunk), jkd.slice_gpt(*chunk)
    src = go.planck_source(kd, it, t["tlay"], t["tlev"], t["tsfc"],
                           sfc_lay=NLAY - 1)
    jsrc = jgo.planck_source(jkd, jit_, j["tlay"], j["tlev"], j["tsfc"],
                             sfc_lay=NLAY - 1)
    for f in ("sfc_src", "sfc_src_jac", "lay_src", "lev_src"):
        close(getattr(src, f), getattr(jsrc, f), name=f)
