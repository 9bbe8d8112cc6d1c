"""Port tables vs the JAX package's: KDist, CloudLUT and AerosolLUT built
from the same raw dicts must be equal field by field, exactly; the
``convert`` path must reproduce them; ``make_atmosphere`` must agree."""

import numpy as np
import pytest
import torch

from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jax_make_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models.aerosol_lut import AerosolLUT as JAerosolLUT
from rte_rrtmgp_tpu.models.cloud_lut import CloudLUT as JCloudLUT
from rte_rrtmgp_tpu.models.kdist import KDist as JKDist

from rte_rrtmgp_torch import convert
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models.aerosol_lut import AerosolLUT
from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
from rte_rrtmgp_torch.models.kdist import META_FIELDS, TABLE_FIELDS, KDist

torch.set_num_threads(2)

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _np(x):
    return None if x is None else np.asarray(x)


def assert_kdist_equal(port: KDist, jkd):
    for name in TABLE_FIELDS:
        a, b = port_np(getattr(port, name)), _np(getattr(jkd, name))
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in META_FIELDS:
        assert getattr(port, name) == getattr(jkd, name), name


def port_np(t):
    return None if t is None else t.numpy()


@pytest.fixture(scope="module")
def raws():
    return {lw: synthetic.make_kdist_raw(lw, gpt_per_band=2)
            for lw in (True, False)}


def test_synthetic_raw_dicts_equal(raws):
    for lw in (True, False):
        jraw = jsyn.make_kdist_raw(lw, gpt_per_band=2)
        assert raws[lw].keys() == jraw.keys()
        for k in jraw:
            np.testing.assert_array_equal(np.asarray(raws[lw][k]),
                                          np.asarray(jraw[k]), err_msg=k)
    for lw in (True, False):
        a, b = synthetic.make_cloud_raw(lw), jsyn.make_cloud_raw(lw)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = synthetic.make_aerosol_raw(), jsyn.make_aerosol_raw()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("chunk", [None, (0, 16), (16, 28)],
                         ids=["whole", "chunk0", "chunk1"])
def test_kdist_from_raw_equals_jax(raws, longwave, chunk, dt):
    np_dt, t_dt = DTYPES[dt]
    port = KDist.from_raw(raws[longwave], GASES, dtype=t_dt, device="cpu")
    jkd = JKDist.from_raw(raws[longwave], GASES, dtype=np_dt)
    if chunk is not None:
        port, jkd = port.slice_gpt(*chunk), jkd.slice_gpt(*chunk)
    assert_kdist_equal(port, jkd)


def test_with_solar_variability_equals_jax(raws):
    port = KDist.from_raw(raws[False], GASES, dtype=torch.float64,
                          device="cpu").with_solar_variability(0.2, 0.001)
    jkd = JKDist.from_raw(raws[False], GASES, dtype=np.float64
                          ).with_solar_variability(0.2, 0.001)
    np.testing.assert_array_equal(port.solar_source.numpy(),
                                  np.asarray(jkd.solar_source))


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_cloud_lut_from_raw_equals_jax_netcdf(tmp_path, longwave):
    raw = synthetic.make_cloud_raw(longwave)
    path = str(tmp_path / "cloud.nc")
    jsyn.write_cloud_nc(path, raw)
    jlut = JCloudLUT.from_netcdf(path, dtype=np.float64)
    lut = CloudLUT.from_raw(raw, dtype=torch.float64, device="cpu")
    for f in ("lut_extliq", "lut_ssaliq", "lut_asyliq", "lut_extice",
              "lut_ssaice", "lut_asyice"):
        np.testing.assert_array_equal(getattr(lut, f).numpy(),
                                      np.asarray(getattr(jlut, f)), err_msg=f)
    for f in ("radliq_lwr", "radliq_upr", "diamice_lwr", "diamice_upr",
              "liq_nsteps", "ice_nsteps", "liq_step_size", "ice_step_size",
              "band_lims_wvn"):
        assert getattr(lut, f) == getattr(jlut, f), f


def test_aerosol_lut_from_raw_equals_jax_netcdf(tmp_path):
    raw = synthetic.make_aerosol_raw()
    path = str(tmp_path / "aer.nc")
    jsyn.write_aerosol_nc(path, raw)
    jlut = JAerosolLUT.from_netcdf(path, dtype=np.float32)
    lut = AerosolLUT.from_raw(raw, dtype=torch.float32, device="cpu")
    for f in ("mext_phobic", "ssa_phobic", "g_phobic", "mext_philic",
              "ssa_philic", "g_philic", "rh_upper"):
        np.testing.assert_array_equal(getattr(lut, f).numpy(),
                                      np.asarray(getattr(jlut, f)), err_msg=f)
    assert lut.nhum == jlut.nhum


def _jax_fields(obj, names):
    return {k: _np(getattr(obj, k)) for k in names if hasattr(obj, k)}


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_convert_kdist_equals_own_tables(raws, longwave):
    jkd = JKDist.from_raw(raws[longwave], GASES, dtype=np.float64)
    conv = convert.kdist_from_numpy(
        _jax_fields(jkd, TABLE_FIELDS),
        {k: getattr(jkd, k) for k in META_FIELDS},
        device="cpu", dtype=torch.float64)
    own = KDist.from_raw(raws[longwave], GASES, dtype=torch.float64,
                         device="cpu")
    for name in TABLE_FIELDS:
        a, b = port_np(getattr(conv, name)), port_np(getattr(own, name))
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in META_FIELDS:
        assert getattr(conv, name) == getattr(own, name), name


def test_convert_luts_equal_own_tables(tmp_path):
    raw = synthetic.make_cloud_raw(False)
    path = str(tmp_path / "c.nc")
    jsyn.write_cloud_nc(path, raw)
    jlut = JCloudLUT.from_netcdf(path, dtype=np.float32)
    names = ("lut_extliq", "lut_ssaliq", "lut_asyliq", "lut_extice",
             "lut_ssaice", "lut_asyice")
    meta = ("radliq_lwr", "radliq_upr", "diamice_lwr", "diamice_upr",
            "liq_nsteps", "ice_nsteps", "liq_step_size", "ice_step_size",
            "band_lims_wvn")
    conv = convert.cloud_lut_from_numpy(
        _jax_fields(jlut, names), {k: getattr(jlut, k) for k in meta},
        device="cpu", dtype=torch.float32)
    own = CloudLUT.from_raw(raw, dtype=torch.float32, device="cpu")
    for f in names:
        np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                      getattr(own, f).numpy(), err_msg=f)
    assert conv.band_lims_wvn == own.band_lims_wvn

    araw = synthetic.make_aerosol_raw()
    apath = str(tmp_path / "a.nc")
    jsyn.write_aerosol_nc(apath, araw)
    jalut = JAerosolLUT.from_netcdf(apath, dtype=np.float32)
    anames = ("mext_phobic", "ssa_phobic", "g_phobic", "mext_philic",
              "ssa_philic", "g_philic", "rh_upper")
    aconv = convert.aerosol_lut_from_numpy(
        _jax_fields(jalut, anames), {"nhum": jalut.nhum}, device="cpu",
        dtype=torch.float32)
    aown = AerosolLUT.from_raw(araw, dtype=torch.float32, device="cpu")
    for f in anames:
        np.testing.assert_array_equal(getattr(aconv, f).numpy(),
                                      getattr(aown, f).numpy(), err_msg=f)


@pytest.mark.parametrize("perturb", [True, False])
def test_make_atmosphere_equals_jax(perturb):
    a = make_atmosphere(5, 12, seed=3, perturb=perturb)
    b = jax_make_atmosphere(5, 12, seed=3, perturb=perturb)
    assert a.keys() == b.keys()
    for k in b:
        if k == "gas_concs":
            assert a[k].names() == b[k].names()
            for g in b[k].names():
                np.testing.assert_array_equal(a[k].get_vmr(g), b[k].get_vmr(g))
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_small_accessors_equal_jax(raws, longwave):
    """KDist's ngas / npress / source_is_internal / has_rayleigh, the
    optical-property classes' ncol / nlay / ngpt and
    ``fluxes.net_broadband`` return what the JAX package's return."""
    from rte_rrtmgp_tpu.models import types as jtypes
    from rte_rrtmgp_tpu.ops import fluxes as jfluxes
    from rte_rrtmgp_torch.models import types
    from rte_rrtmgp_torch.ops import fluxes

    port = KDist.from_raw(raws[longwave], GASES, dtype=torch.float64,
                          device="cpu")
    jkd = JKDist.from_raw(jsyn.make_kdist_raw(longwave, gpt_per_band=2),
                          GASES, dtype=np.float64)
    for name in ("ngas", "npress", "source_is_internal", "has_rayleigh"):
        assert getattr(port, name) == getattr(jkd, name), name
    tau = np.random.default_rng(0).uniform(size=(3, 5, port.ngpt))
    for cls, jcls, fields in (
            (types.OpticalProps1scl, jtypes.OpticalProps1scl, ("tau",)),
            (types.OpticalProps2str, jtypes.OpticalProps2str,
             ("tau", "ssa", "g"))):
        p = cls(**{f: torch.from_numpy(tau) for f in fields})
        j = jcls(**{f: tau for f in fields})
        assert (p.ncol, p.nlay, p.ngpt) == (j.ncol, j.nlay, j.ngpt) \
            == (3, 5, port.ngpt)
    dn, up = tau[:, :, 0], tau[:, :, 1]
    np.testing.assert_array_equal(
        fluxes.net_broadband(torch.from_numpy(dn), torch.from_numpy(up))
        .numpy(), np.asarray(jfluxes.net_broadband(dn, up)))
