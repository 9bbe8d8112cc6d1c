"""The port's NetCDF I/O (``rte_rrtmgp_torch/utils/ncio.py``) and the table
loaders that read through it.

* The classic writer round-trips float32, float64, int64 (stored int32),
  bool (stored int32), scalar, 0-d and char/string variables, with and
  without ``h5py`` (the card's machine has none).
* The port reads the JAX package's HDF5 files (input, coefficients, cloud,
  aerosol) into arrays equal to the JAX ``NcReader``'s, and the JAX reader
  reads the port's classic files equal.
* ``KDist`` / ``CloudLUT`` / ``AerosolLUT.from_netcdf`` equal their
  ``from_raw`` on the same raw dict exactly; ``total_solar_irradiance``
  equals JAX's.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu.cases import inputs as jinputs
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jmake_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models.kdist import KDist as JKDist
from rte_rrtmgp_tpu.utils.ncio import NcReader as JNcReader

from rte_rrtmgp_torch.cases import inputs
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.data import synthetic
from rte_rrtmgp_torch.models import AerosolLUT, CloudLUT, KDist
from rte_rrtmgp_torch.models.kdist import META_FIELDS, TABLE_FIELDS
from rte_rrtmgp_torch.utils import ncio

torch.set_num_threads(2)

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]


def _sample():
    rng = np.random.default_rng(3)
    return dict(
        f32=rng.standard_normal((3, 4)).astype(np.float32),
        f64=rng.standard_normal((4,)),
        i64=np.array([[1, -2], [3, 2**31 - 1], [0, -2**31]], np.int64),
        flag=np.array([True, False, True]),
        i8=np.array([1, 0, 1], np.int8),
        zero_d=np.float64(2.5))


@pytest.mark.parametrize("hide_h5py", [False, True], ids=["h5py", "no_h5py"])
def test_classic_round_trip(tmp_path, monkeypatch, hide_h5py):
    if hide_h5py:
        monkeypatch.setattr(ncio, "h5py", None)
    data = _sample()
    path = str(tmp_path / "rt.nc")
    with ncio.NcWriter(path) as nc:
        nc.def_dim("x", 3)
        nc.write("f32", data["f32"], ("x", "y"), attrs={"units": "W m-2"})
        nc.write("f64", data["f64"], ("y",))
        nc.write("i64", data["i64"], ("x", "pair"))
        nc.write("flag", data["flag"], ("x",))
        nc.write("i8", data["i8"], ("x",))
        nc.write("zero_d", data["zero_d"], ())
        nc.write_scalar("scalar", 7.25)
        nc.write_strings("names", ["h2o", "co2", "o3"], "x", string_len=8)
        with pytest.raises(ValueError):
            nc.def_dim("x", 4)
    with open(path, "rb") as f:
        assert f.read(4) == b"CDF\x02"
    with ncio.NcReader(path) as nc:
        assert sorted(nc.variables()) == sorted(
            ["f32", "f64", "i64", "flag", "i8", "zero_d", "scalar", "names"])
        assert (nc.dim("x"), nc.dim("y"), nc.dim("pair"),
                nc.dim("string_len")) == (3, 4, 2, 8)
        with pytest.raises(KeyError):
            nc.dim("nope")
        assert nc.has("f32") and not nc.has("x")
        f32 = nc.read("f32")
        assert f32.dtype == np.float32 and f32.dtype.isnative
        np.testing.assert_array_equal(f32, data["f32"])
        np.testing.assert_array_equal(nc.read("f64"), data["f64"])
        i64 = nc.read("i64")
        assert i64.dtype == np.int32
        np.testing.assert_array_equal(i64, data["i64"])
        assert nc.read("flag").dtype == np.int32
        np.testing.assert_array_equal(nc.read("flag").astype(bool), data["flag"])
        np.testing.assert_array_equal(nc.read("i8"), data["i8"])
        assert nc.read("zero_d").shape == () and nc.read_scalar("zero_d") == 2.5
        assert nc.read_scalar("scalar") == 7.25
        assert nc.read("f64", np.float32).dtype == np.float32
        assert nc.read_strings("names") == ["h2o", "co2", "o3"]
        assert nc.read_optional("missing") is None
    with pytest.raises(ValueError, match="int32"):
        with ncio.NcWriter(str(tmp_path / "big.nc")) as nc:
            nc.write("big", np.array([2**40]), ("n",))


def test_hdf5_file_without_h5py_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "cloud.nc")
    jsyn.write_cloud_nc(path, jsyn.make_cloud_raw(True))
    monkeypatch.setattr(ncio, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        ncio.NcReader(path)


def _atmosphere(make):
    return make(6, 8, seed=2)


def _write_case(mod_inputs, mod_syn, make, d):
    """Input (clouds, aerosols, a ray-tracing grid) and table files."""
    paths = {k: str(d / f"{k}.nc") for k in
             ("input", "coefs_lw", "coefs_sw", "cloud_lw", "cloud_sw", "aerosol")}
    mod_inputs.write_input_nc(paths["input"], _atmosphere(make), 3, 2,
                              with_clouds=True, with_aerosols=True,
                              rt_grid=dict(nz=4, sza=0.3))
    for lw in (True, False):
        mod_syn.write_kdist_nc(paths["coefs_lw" if lw else "coefs_sw"],
                               mod_syn.make_kdist_raw(lw, gpt_per_band=2))
        mod_syn.write_cloud_nc(paths["cloud_lw" if lw else "cloud_sw"],
                               mod_syn.make_cloud_raw(lw))
    mod_syn.write_aerosol_nc(paths["aerosol"], mod_syn.make_aerosol_raw())
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same case written by the JAX package (HDF5) and the port
    (classic NetCDF)."""
    return (_write_case(jinputs, jsyn, jmake_atmosphere,
                        tmp_path_factory.mktemp("jax")),
            _write_case(inputs, synthetic, make_atmosphere,
                        tmp_path_factory.mktemp("port")))


def _dim_scales(path):
    """Names of the JAX writer's dimension-scale datasets (HDF5 stores each
    dimension as a variable; classic NetCDF stores one only where a caller
    writes it)."""
    import h5py
    with h5py.File(path, "r") as f:
        return {k for k, v in f.items()
                if v.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"}


def _assert_same(a, b, name):
    assert a.shape == b.shape, name
    if a.dtype.kind in "iub":
        assert b.dtype.kind in "iub", name
    else:
        assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", ["input", "coefs_lw", "coefs_sw", "cloud_lw",
                                  "cloud_sw", "aerosol"])
def test_port_reads_jax_hdf5_and_jax_reads_port_classic(files, kind):
    jfile, pfile = files[0][kind], files[1][kind]
    with JNcReader(jfile) as jr, ncio.NcReader(jfile) as pr:
        jnames = set(jr.variables())
        assert set(pr.variables()) == jnames
        for name in jnames:
            _assert_same(pr.read(name), jr.read(name), name)
        expected = {n: jr.read(n) for n in jnames - _dim_scales(jfile)}
        # The coordinate variables the input writer fills (the ray-tracing
        # grid): the JAX writer stores them in its float32 dimension scale.
        coords = {n: jr.read(n) for n in ("x", "y", "z") if kind == "input"}
    with JNcReader(pfile) as jr, ncio.NcReader(pfile) as pr:
        assert set(jr.variables()) == set(pr.variables()) == \
            set(expected) | set(coords)
        for name in pr.variables():
            _assert_same(jr.read(name), pr.read(name), name)
        for name, ref in expected.items():
            _assert_same(pr.read(name), ref, name)
        for name, ref in coords.items():
            _assert_same(pr.read(name).astype(ref.dtype), ref, name)


def _kdist_equal(a, b):
    for f in TABLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_kdist_from_netcdf_equals_from_raw(files, longwave, dtype):
    raw = synthetic.make_kdist_raw(longwave, gpt_per_band=2)
    path = files[1]["coefs_lw" if longwave else "coefs_sw"]
    kw = dict(dtype=dtype, device="cpu")
    _kdist_equal(KDist.from_netcdf(path, GASES, **kw),
                 KDist.from_raw(raw, GASES, **kw))


def test_luts_from_netcdf_equal_from_raw(files):
    kw = dict(dtype=torch.float64, device="cpu")
    for lw in (True, False):
        a = CloudLUT.from_netcdf(files[1]["cloud_lw" if lw else "cloud_sw"], **kw)
        b = CloudLUT.from_raw(synthetic.make_cloud_raw(lw), **kw)
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y, f
    a = AerosolLUT.from_netcdf(files[1]["aerosol"], **kw)
    b = AerosolLUT.from_raw(synthetic.make_aerosol_raw(), **kw)
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y, f


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_total_solar_irradiance_matches_jax(files, dtype):
    kd = KDist.from_netcdf(files[1]["coefs_sw"], GASES,
                           dtype=getattr(torch, dtype), device="cpu")
    jkd = JKDist.from_netcdf(files[0]["coefs_sw"], GASES,
                             dtype=getattr(np, dtype))
    assert kd.total_solar_irradiance() == jkd.total_solar_irradiance()


@pytest.mark.parametrize("form", ["classic", "hdf5"])
def test_group_convention(tmp_path, monkeypatch, form):
    """A group's variables: the HDF5 group of a NetCDF4 file (the JAX
    writers'), or ``<group>.<name>`` in a classic file (a classic name may
    not contain ``/``).  ``set_scalars`` writes each file in its own form
    (creating and overwriting); ``NcReader.group`` / ``has_group`` read
    both; the classic form reads without ``h5py``."""
    from rte_rrtmgp_tpu.utils.ncio import NcWriter as JNcWriter

    path = str(tmp_path / "f.nc")
    writer = ncio.NcWriter if form == "classic" else JNcWriter
    with writer(path) as w:
        w.write("t", np.arange(3.0), ("x",))
        w.write_scalar("sza", 0.5)
    ncio.set_scalars(path, {"px": 12.5, "nx": 64.0}, group="camera-settings")
    ncio.set_scalars(path, {"px": 13.0}, group="camera-settings")
    ncio.set_scalars(path, {"sza": 0.7, "azi": 0.1})
    if form == "classic":
        monkeypatch.setattr(ncio, "h5py", None)
    with ncio.NcReader(path) as nc:
        assert nc.is_hdf5 == (form == "hdf5")
        assert nc.has_group("camera-settings")
        assert not nc.has_group("camera") and not nc.has_group("t")
        grp = nc.group("camera-settings")
        assert sorted(grp.variables()) == ["nx", "px"]
        assert grp.has("px") and not grp.has("py")
        assert (grp.read_scalar("px"), grp.read_scalar("nx")) == (13.0, 64.0)
        assert (nc.read_scalar("sza"), nc.read_scalar("azi")) == (0.7, 0.1)
        np.testing.assert_array_equal(nc.read("t"), np.arange(3.0))
        top = set(nc.variables())
        with pytest.raises(KeyError, match="other"):
            nc.group("other")
    if form == "classic":
        assert {"camera-settings.px", "camera-settings.nx"} <= top
    else:
        assert top == {"t", "sza", "azi"} | _dim_scales(path)
        with JNcReader(path) as jr:
            assert jr.group("camera-settings").read_scalar("px") == 13.0
