"""The port's camera CLI (``rte_rrtmgp_torch/cli_bw.py``), the camera branch
of ``cli_rt_lite`` and the camera tools (``tools/set_virtual_camera.py``,
``image_from_xyz.py``, ``box_cloud.py``) against the JAX package's, on the
same input files (a 4 x 3 column case, 12 layers, the lowest 6 rendered
in 3D, ``gpt_per_band=1``, written by the JAX writers as HDF5; a TOA
camera of 5 x 4 pixels written by JAX's ``set_virtual_camera``).

* ``cli_bw --broadband --cloud-optics --cloud-cam`` of both packages: the
  same variables and shapes, the cloud-camera images within 1e-5 of each
  image's largest value (both CLIs run float32; the march is
  deterministic), the radiance's domain mean within 4 sigma of the
  Monte-Carlo error from the spread of a few port seeds (``lanes``, one
  window).
* The classic form of the camera group: the same case written by the
  port's writers (classic NetCDF, ``camera-settings.<name>`` variables)
  renders exactly what the HDF5 input renders for the same seed.
* ``cli_rt_lite --bw-raytracing`` writes a finite ``radiance`` (cam_y,
  cam_x); ``image_from_xyz`` and ``box_cloud`` equal JAX's.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks load in every port test file)
from rte_rrtmgp_tpu import cli_bw as jcli_bw
from rte_rrtmgp_tpu.cases import inputs as jinputs
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jmake_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.tools import box_cloud as jbox
from rte_rrtmgp_tpu.tools import image_from_xyz as jxyz
from rte_rrtmgp_tpu.tools import set_virtual_camera as jcam
from rte_rrtmgp_tpu.utils.ncio import NcReader as JNcReader

from rte_rrtmgp_torch import cli_bw, cli_rt_lite
from rte_rrtmgp_torch.cases import inputs
from rte_rrtmgp_torch.tools import box_cloud, image_from_xyz
from rte_rrtmgp_torch.tools import set_virtual_camera as cam_tool
from rte_rrtmgp_torch.utils import ncio

torch.set_num_threads(2)

NX, NY, NLAY, NZ = 4, 3, 12, 6
FLAGS = ["--broadband", "--bw-raytracing", "1", "--cloud-optics",
         "--cloud-cam"]
CAM_IMAGES = ("liq_ice_wp_cam", "tau_cld_cam", "dist_cld_cam", "zen_cam")
RT = {"nz": NZ, "sza": 0.4}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("bw_cli")
    atm = jmake_atmosphere(NX * NY, NLAY, seed=21)
    jinputs.write_input_nc(str(d / "rte_rrtmgp_input.nc"), atm, NX, NY,
                           rt_grid=RT)
    jcam.main(["--name", str(d / "rte_rrtmgp_input.nc"), "--toa", "--nx",
               "5", "--ny", "4"])
    jsyn.write_kdist_nc(str(d / "coefficients_sw.nc"),
                        jsyn.make_kdist_raw(False, gpt_per_band=1))
    jsyn.write_cloud_nc(str(d / "cloud_coefficients_sw.nc"),
                        jsyn.make_cloud_raw(False))
    # the same case through the port's writers: classic NetCDF
    inputs.write_input_nc(str(d / "classic_input.nc"), atm, NX, NY,
                          rt_grid=RT)
    cam_tool.main(["--name", str(d / "classic_input.nc"), "--toa", "--nx",
                   "5", "--ny", "4"])
    return d


def _run(d, main, argv, name):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert main(argv + ["--output", name]) == 0
    finally:
        os.chdir(cwd)
    return str(d / name)


def _read(path, reader):
    with reader(path) as nc:
        return {n: np.asarray(nc.read(n)) for n in nc.variables()
                if n not in ("x", "y", "n")}


def test_camera_group_in_both_forms(case):
    with ncio.NcReader(str(case / "rte_rrtmgp_input.nc")) as h5, \
            ncio.NcReader(str(case / "classic_input.nc")) as cl:
        assert h5.is_hdf5 and not cl.is_hdf5
        assert h5.has_group("camera-settings") and cl.has_group(
            "camera-settings")
        assert "camera-settings.px" in cl.variables()
        assert cam_tool.read_camera(h5) == cam_tool.read_camera(cl)
        cam = cam_tool.read_camera(cl)
    assert (cam.cam_type, cam.nx, cam.ny) == (2, 5, 4)


def test_cli_bw_matches_jax_cli(case):
    ref = _read(_run(case, jcli_bw.main, FLAGS, "jax.nc"), JNcReader)
    runs = [_read(_run(case, cli_bw.main, FLAGS + [
        "--device", "cpu", "--seed", str(s), "--spectral-mode", "lanes",
        "--steps-per-dispatch", "off"], f"port{s}.nc"), ncio.NcReader)
        for s in range(4)]
    got = runs[0]
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape == (4, 5), name
    for name in CAM_IMAGES:
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=1e-5 * np.abs(ref[name]).max(),
                                   err_msg=name)
    assert got["liq_ice_wp_cam"].max() > 0
    vals = np.array([r["radiance"].astype(np.float64).mean() for r in runs])
    assert np.isfinite(vals).all() and vals.min() > 0
    sigma = vals.std(ddof=1) * np.sqrt(1.0 + 1.0 / len(vals))
    r = ref["radiance"].astype(np.float64).mean()
    assert abs(r - vals.mean()) <= 4 * sigma, (r, vals)


def test_cli_bw_classic_input_renders_as_hdf5(case):
    """The port's classic file (prefixed camera variables) and JAX's HDF5
    file hold the same case: the same render for the same seed."""
    argv = FLAGS + ["--device", "cpu", "--seed", "7", "--spectral-mode",
                    "lanes", "--n-sub", "1"]
    h5 = _read(_run(case, cli_bw.main, argv, "h5.nc"), ncio.NcReader)
    cl = _read(_run(case, cli_bw.main, argv + ["--input", "classic_input.nc"],
                    "classic.nc"), ncio.NcReader)
    for name in h5:
        np.testing.assert_allclose(cl[name], h5[name], rtol=1e-6,
                                   atol=1e-6 * np.abs(h5[name]).max(),
                                   err_msg=name)


def test_cli_bw_refuses_to_run_without_a_card(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_bw.main(["--input", str(case / "never.nc")])


def test_cli_rt_lite_renders_the_camera(tmp_path):
    data = box_cloud.make_box_cloud(nx=8, ny=8, nz=4, tau_cloud=2.0,
                                    ngrid=(2, 4, 4))
    path = str(tmp_path / "rt_lite_input.nc")
    box_cloud.write_rt_lite_input(path, data)
    cam_tool.main(["--name", path, "--toa", "--nx", "4", "--ny", "3"])
    out = _read(_run(tmp_path, cli_rt_lite.main, [
        "--raytracing", "0", "--bw-raytracing", "8", "--device", "cpu"],
        "lite.nc"), ncio.NcReader)
    assert sorted(out) == ["radiance"]
    assert out["radiance"].shape == (3, 4)
    assert np.isfinite(out["radiance"]).all() and out["radiance"].max() > 0
    with ncio.NcReader(str(tmp_path / "lite.nc")) as nc:
        assert (nc.dim("cam_y"), nc.dim("cam_x")) == (3, 4)


def test_image_from_xyz_and_box_cloud_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0.0, 2.0, (3, 5, 6))
    for adapt in (True, False):
        np.testing.assert_array_equal(
            image_from_xyz.xyz_to_srgb(xyz, 95.0, adapt=adapt),
            jxyz.xyz_to_srgb(xyz, 95.0, adapt=adapt))
    with ncio.NcWriter(str(tmp_path / "xyz.nc")) as w:
        w.write("XYZ", xyz, ("n", "y", "x"))
    image_from_xyz.main(["--name", str(tmp_path / "xyz.nc"), "--output",
                         str(tmp_path / "image.png")])
    from PIL import Image

    assert Image.open(str(tmp_path / "image.png")).size == (6, 5)
    kw = dict(nx=16, ny=12, nz=8, n_cloud_x=3)
    got, ref = box_cloud.make_box_cloud(**kw), jbox.make_box_cloud(**kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    box_cloud.write_rt_lite_input(str(tmp_path / "p.nc"), got)
    jbox.write_rt_lite_input(str(tmp_path / "j.nc"), ref)
    p, j = (_read(str(tmp_path / n), r) for n, r in (("p.nc", ncio.NcReader),
                                                     ("j.nc", JNcReader)))
    assert sorted(p) == sorted(set(j) - {"lay"})    # JAX's unused dim scale
    for k in p:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
