"""The port's weight-plane gas optics vs the JAX package, float64 on the CPU.

The JAX package runs its XLA path (``use_pallas()`` is False off TPU); the
port makes the same weight planes and runs, for CPU tensors, the plain twin
of the weight-plane kernel (``interp_rows_plain``).  Inputs are made from a
seed with NumPy and handed to both.

* The weight planes equal JAX's ``_fused_inputs`` / ``_kernel_resolves``
  and ``_minor_prep`` exactly (JAX's one-hot matmuls are exact in f64).
* The plane paths of the major, Planck, Rayleigh and minor interpolations,
  the top-level ``gas_optics_lw`` / ``gas_optics_sw`` and
  ``planck_source_lm`` agree with JAX, and the interpolations with the
  NumPy oracle ``ops/reference.py``, at rtol 1e-10 (the twin blends the
  pressure pair before the eta pair, JAX multiplies precomputed fmajor
  weights: the float64 sums differ in order only).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rte_rrtmgp_tpu.models.kdist import KDist as JKDist
from rte_rrtmgp_tpu.ops import gas_optics as jgo
from rte_rrtmgp_tpu.ops import reference as ref

from helpers import interp_oracle
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models.kdist import KDist
from rte_rrtmgp_torch.ops import gas_optics as go

torch.set_num_threads(2)

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
RTOL = 1e-10
NCOL, NLAY = 6, 10
# Chunk [0, 16) holds minor intervals, [16, 28) none.
CHUNKS = {"minor": (0, 16), "no_minor": (16, 28)}


@functools.lru_cache(maxsize=None)
def jitted(fn, *static):
    """A JAX reference function compiled once (faster than op by op)."""
    return jax.jit(fn, static_argnames=static)


def close(a, b, rtol=RTOL, name=""):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=0.0,
                               err_msg=name)


def equal(a, b, name=""):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.fixture(scope="module")
def case():
    """Per spectrum (LW, SW): both packages' tables and interpolation
    weights, and the oracle's; plus a top-at-0 atmosphere."""
    atm = make_atmosphere(NCOL, NLAY, seed=13)
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])
    vmr = flip(atm["gas_concs"].materialize(GASES, NCOL, NLAY))
    arrs = dict(play=flip(atm["p_lay"]), plev=flip(atm["p_lev"]),
                tlay=flip(atm["t_lay"]), tlev=flip(atm["t_lev"]),
                tsfc=atm["t_sfc"], vmr=vmr)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t["col_dry"] = go.get_col_dry(t["vmr"][:, :, 0], t["plev"])
    t["col_gas"] = go.build_col_gas(t["vmr"], t["col_dry"])
    j["col_dry"] = jnp.asarray(t["col_dry"].numpy())
    j["col_gas"] = jnp.asarray(t["col_gas"].numpy())
    spectra = {}
    for lw in (True, False):
        raw = synthetic.make_kdist_raw(lw, gpt_per_band=2)
        kd = KDist.from_raw(raw, GASES, dtype=torch.float64, device="cpu")
        jkd = JKDist.from_raw(raw, GASES, dtype=np.float64)
        spectra[lw] = dict(
            kd=kd, jkd=jkd,
            it=go.interpolation(kd, t["play"], t["tlay"], t["col_gas"]),
            oi=interp_oracle(jkd, arrs["play"], arrs["tlay"],
                             t["col_gas"].numpy()))
        # Both packages interpolate from the same weights (the two
        # interpolation functions are held equal in test_torch_gas_optics).
        spectra[lw]["jit"] = jgo.Interp(**{
            f.name: jnp.asarray(getattr(spectra[lw]["it"], f.name).numpy())
            for f in dataclasses.fields(go.Interp)})
    return spectra, t, j


def _chunk(spec, chunk):
    g0, g1 = CHUNKS[chunk]
    return spec["kd"].slice_gpt(g0, g1), spec["jkd"].slice_gpt(g0, g1), g0, g1


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_fused_inputs_match_jax(case, longwave):
    spectra, _, _ = case
    spec = spectra[longwave]
    kdc, jkdc, _, _ = _chunk(spec, "minor")
    rows, jes, fms, fp, cms = go._fused_inputs(kdc, spec["it"], True)
    jrows, jjes, jfms, jfp, jcms = jitted(
        jgo._fused_inputs, "with_colmix")(
        jkdc, spec["jit"], masks=jgo._flavor_masks(jkdc, np.float64),
        with_colmix=True)
    assert rows.dtype == jes[0].dtype == torch.int32
    equal(rows, jrows, "rows")
    for name, a, b in (("je", jes, jjes), ("fm", fms, jfms),
                       ("cm", cms, jcms)):
        assert len(a) == len(b)
        for k, (x, y) in enumerate(zip(a, b)):
            equal(x, y, f"{name}{k}")
    equal(fp, jfp, "fp")


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("order,chunk", [("cm", "minor"), ("lm", "minor"),
                                         ("cm", "no_minor")])
def test_minor_prep_matches_jax(case, longwave, order, chunk):
    spectra, t, j = case
    spec = spectra[longwave]
    kdc, jkdc, _, _ = _chunk(spec, chunk)
    got = go._minor_prep(kdc, spec["it"], t["play"], t["tlay"], t["col_gas"],
                         order=order)
    want = jgo._minor_prep(jkdc, spec["jit"], j["play"], j["tlay"],
                           j["col_gas"], order=order)
    if chunk == "no_minor":
        assert got is None and want is None
        return
    tbl, rows, flav, spec_idx, sc, ordered, CT = got
    jtbl, jrows, Mf, Ms, jsc, jordered, jCT = want
    assert CT == jCT and tuple(map(tuple, ordered)) == tuple(map(tuple, jordered))
    equal(tbl, jtbl, "tbl")
    equal(rows, jrows, "rows")
    equal(sc, jsc, "sc")
    place = lambda idx, n: np.eye(n, dtype=np.float32)[idx.numpy()].T
    equal(place(flav, kdc.nflav), Mf, "Mf")
    equal(place(spec_idx, len(ordered)), Ms, "Ms")


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_tau_major_and_pfrac_planes(case, chunk):
    """The fused kmajor + planck pass (B4's twin) against JAX's XLA
    tau_major and Planck fraction, and tau against the oracle."""
    spectra, _, _ = case
    spec = spectra[True]
    kdc, jkdc, g0, g1 = _chunk(spec, chunk)
    tau, pfrac = go.tau_major_and_pfrac(kdc, spec["it"])
    close(tau, jitted(jgo.tau_major)(jkdc, spec["jit"]), name="tau")
    close(pfrac, jitted(jgo._interp3d_rows, "scale_by_colmix")(
        jkdc, jkdc.planck_rows, spec["jit"], scale_by_colmix=False),
        name="pfrac")
    jkd = spec["jkd"]
    oracle = ref.tau_major(spec["oi"], np.asarray(jkd.kmajor),
                           jkd.gpoint_flavor, jkd.gpt2band)
    close(tau, oracle[:, :, g0:g1], name="tau vs oracle")


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_tau_major_and_rayleigh_planes(case, chunk):
    """The fused kmajor + krayl pass (B4's twin) against JAX and the
    oracle."""
    spectra, t, j = case
    spec = spectra[False]
    kdc, jkdc, g0, g1 = _chunk(spec, chunk)
    tau, ray = go.tau_major_and_rayleigh(kdc, spec["it"], t["col_gas"],
                                         t["col_dry"])
    close(tau, jitted(jgo.tau_major)(jkdc, spec["jit"]), name="tau")
    close(ray, jitted(jgo.tau_rayleigh)(jkdc, spec["jit"], j["col_gas"],
                                        j["col_dry"]), name="tau_rayleigh")
    jkd = spec["jkd"]
    oracle = ref.tau_rayleigh(spec["oi"], t["col_gas"].numpy(),
                              t["col_dry"].numpy(), np.asarray(jkd.krayl),
                              jkd.gpoint_flavor, jkd.idx_h2o)
    close(ray, oracle[:, :, g0:g1], name="tau_rayleigh vs oracle")


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_tau_minor_planes(case, longwave, chunk):
    """The minor pass over the contributor axis (B5's twin) against JAX's
    tau_minor and the oracle (both atmospheres), added into zeros and into
    the major tau."""
    spectra, t, j = case
    spec = spectra[longwave]
    kdc, jkdc, g0, g1 = _chunk(spec, chunk)
    args = (t["play"], t["tlay"], t["col_gas"])
    jargs = (j["play"], j["tlay"], j["col_gas"])
    zeros = torch.zeros((NCOL, NLAY, g1 - g0), dtype=torch.float64)
    got = go._tau_minor_planes(kdc, spec["it"], *args, zeros)
    jminor = jitted(jgo.tau_minor)
    close(got, jminor(jkdc, spec["jit"], *jargs,
                      jnp.zeros((NCOL, NLAY, g1 - g0))), name="minor")
    jkd, oi = spec["jkd"], spec["oi"]
    oracle = sum(ref.tau_minor(oi, t["play"].numpy(), t["tlay"].numpy(),
                               t["col_gas"].numpy(),
                               np.asarray(getattr(jkd, f"kminor_{atm}")),
                               getattr(jkd, f"minor_{atm}"), jkd.idx_h2o,
                               lower=atm == "lower", ngpt=jkd.ngpt)
                 for atm in ("lower", "upper"))
    close(got, oracle[:, :, g0:g1], name="minor vs oracle")
    base = go.tau_major(kdc, spec["it"])
    close(go._tau_minor_planes(kdc, spec["it"], *args, base),
          jminor(jkdc, spec["jit"], *jargs,
                 jitted(jgo.tau_major)(jkdc, spec["jit"])), name="major+minor")


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_card_branches_of_single_quantities(case, longwave):
    """tau_major, planck_fraction and tau_rayleigh take the weight-plane
    kernel on CUDA tensors and their plain bodies on CPU tensors; the two
    branches compute the same function."""
    spectra, t, _ = case
    spec = spectra[longwave]
    kd, it = spec["kd"], spec["it"]
    close(go._interp3d_rows_planes(kd, kd.kmajor_rows, it, True),
          go.tau_major(kd, it), name="tau_major")
    if longwave:
        close(go._interp3d_rows_planes(kd, kd.planck_rows, it, False),
              go.planck_fraction(kd, it), name="planck_fraction")
    else:
        _, ray = go.tau_major_and_rayleigh(kd, it, t["col_gas"], t["col_dry"])
        close(ray, go.tau_rayleigh(kd, it, t["col_gas"], t["col_dry"]),
              name="tau_rayleigh")


def test_gas_optics_lw_sw_match_jax(case):
    spectra, t, j = case
    kd, jkd = spectra[True]["kd"], spectra[True]["jkd"]
    keys = ("play", "plev", "tlay", "tlev", "tsfc", "vmr", "col_dry")
    op, src = go.gas_optics_lw(kd, *[t[k] for k in keys], sfc_lay=NLAY - 1)
    jop, jsrc = jitted(jgo.gas_optics_lw, "sfc_lay")(
        jkd, *[j[k] for k in keys], sfc_lay=NLAY - 1)
    close(op.tau, jop.tau, name="lw tau")
    for f in ("sfc_src", "sfc_src_jac", "lay_src", "lev_src"):
        close(getattr(src, f), getattr(jsrc, f), name=f)
    kd, jkd = spectra[False]["kd"], spectra[False]["jkd"]
    keys = ("play", "plev", "tlay", "vmr", "col_dry")
    op, toa = go.gas_optics_sw(kd, *[t[k] for k in keys])
    jop, jtoa = jitted(jgo.gas_optics_sw)(jkd, *[j[k] for k in keys])
    for f in ("tau", "ssa", "g"):
        close(getattr(op, f), getattr(jop, f), name=f"sw {f}")
    close(toa, jtoa, name="toa_src")


def test_planck_source_lm_matches_jax(case):
    spectra, t, j = case
    spec = spectra[True]
    kd, jkd, _, _ = _chunk(spec, "minor")
    jpfrac = jgo._cells(jitted(jgo._interp3d_rows, "scale_by_colmix")(
        jkd, jkd.planck_rows, spec["jit"], scale_by_colmix=False), "lm")
    pfrac = torch.from_numpy(np.array(jpfrac))
    src = go.planck_source_lm(kd, t["tlay"], t["tlev"], t["tsfc"],
                              sfc_lay=NLAY - 1, pfrac_lm=pfrac, ncol=NCOL)
    jsrc = jitted(jgo.planck_source_lm, "sfc_lay", "ncol")(
        jkd, j["tlay"], j["tlev"], j["tsfc"], sfc_lay=NLAY - 1,
        pfrac_lm=jpfrac, ncol=NCOL)
    for f in ("sfc_src", "sfc_src_jac", "lay_src"):
        close(getattr(src, f), getattr(jsrc, f), name=f)
    assert len(src.lev_src) == len(jsrc.lev_src) == 3
    for k, (a, b) in enumerate(zip(src.lev_src, jsrc.lev_src)):
        close(a, b, name=f"lev_src[{k}]")
    # The same sources as the column-major planck_source, re-ordered.
    cm = go.planck_source(kd, spec["it"], t["tlay"], t["tlev"], t["tsfc"],
                          sfc_lay=NLAY - 1, pfrac=go._interp3d_rows(
                              kd, kd.planck_rows, spec["it"], False))
    close(src.lay_src, go._cells(cm.lay_src, "lm"), name="lay_src vs cm")
    close(torch.cat(src.lev_src), go._cells(cm.lev_src, "lm"),
          name="lev_src vs cm")
