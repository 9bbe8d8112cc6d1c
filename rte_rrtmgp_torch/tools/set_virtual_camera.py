"""Add or modify the "camera-settings" group of a ray-tracer input file.

The port's copy of the JAX package's ``tools/set_virtual_camera.py`` (the
reference's ``python/set_virtual_camera.py``): the same variables and
presets.  The file keeps its format: a NetCDF4 (HDF5) file gets an HDF5
group (through ``h5py``), a classic file the prefixed variables
``camera-settings.<name>`` (``utils/ncio.py``), which is what the port's
writers produce and what a machine without ``h5py`` can read.

Usage: python -m rte_rrtmgp_torch.tools.set_virtual_camera [--toa|--image|--radiance]
           [--name rte_rrtmgp_input.nc] [--nx N] [--ny N] [--sza DEG] ...
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import ncio

GROUP = "camera-settings"
CAMERA_VARIABLES = {
    "yaw": 0.0, "pitch": 0.0, "roll": 0.0, "cam_type": 1.0, "fov": 80.0,
    "px": 0.0, "py": 0.0, "pz": 500.0, "nx": 256.0, "ny": 256.0,
    "f_zoom": 1.0,
}

PRESETS = {
    # sky-view hemispheric radiance camera at the surface
    "radiance": dict(cam_type=0.0, pitch=-90.0, fov=180.0, pz=1.0,
                     nx=128, ny=128),
    # horizontal-view image camera at 500 m
    "image": dict(cam_type=1.0, yaw=0.0, pitch=0.0, fov=80.0, pz=500.0,
                  nx=256, ny=256),
    # top-of-atmosphere nadir radiances
    "toa": dict(cam_type=2.0, nx=128, ny=128),
}


def set_camera(path: str, values: dict, sza=None, azi=None) -> None:
    """Write the camera variables (defaults overridden by ``values``) and,
    when given, the sun angles (degrees; stored in radians)."""
    merged = dict(CAMERA_VARIABLES)
    merged.update({k: v for k, v in values.items() if v is not None})
    ncio.set_scalars(path, {k: float(v) for k, v in merged.items()},
                     group=GROUP)
    sun = {name: float(np.deg2rad(val))
           for name, val in (("sza", sza), ("azi", azi)) if val is not None}
    if sun:
        ncio.set_scalars(path, sun)


def read_camera(nc):
    """The camera of an open ``NcReader`` (its "camera-settings" group, in
    either form) as a :class:`~rte_rrtmgp_torch.models.raytracer_bw.Camera`."""
    from ..models.raytracer_bw import Camera

    grp = nc.group(GROUP)
    return Camera(
        position=(grp.read_scalar("px"), grp.read_scalar("py"),
                  grp.read_scalar("pz")),
        cam_type=int(grp.read_scalar("cam_type")),
        yaw_deg=grp.read_scalar("yaw"), pitch_deg=grp.read_scalar("pitch"),
        roll_deg=grp.read_scalar("roll"), fov=grp.read_scalar("fov"),
        nx=int(grp.read_scalar("nx")), ny=int(grp.read_scalar("ny")))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for preset in PRESETS:
        p.add_argument(f"--{preset}", action="store_true")
    p.add_argument("--sza", type=float)
    p.add_argument("--azi", type=float)
    p.add_argument("--name", default="rte_rrtmgp_input.nc")
    for var in CAMERA_VARIABLES:
        p.add_argument(f"--{var}", type=float)
    args = vars(p.parse_args(argv))

    values = {}
    for preset, preset_vals in PRESETS.items():
        if args.pop(preset):
            values.update(preset_vals)
    values.update({k: args[k] for k in CAMERA_VARIABLES
                   if args.get(k) is not None})
    set_camera(args["name"], values, args.get("sza"), args.get("azi"))
    print(f"camera-settings updated in {args['name']}")


if __name__ == "__main__":
    main()
