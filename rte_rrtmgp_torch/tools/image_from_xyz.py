"""Convert rendered CIE XYZ tristimulus images to sRGB PNGs.

The port's copy of the JAX package's ``tools/image_from_xyz.py`` (the
reference's ``python/image_from_xyz.py``) without the colour-science
dependency: percentile luminance normalization, Bradford chromatic
adaptation from illuminant E to D65, the standard sRGB matrix and transfer
function.  NumPy only; PIL is imported where the PNG is written.
"""

from __future__ import annotations

import argparse

import numpy as np

# XYZ (D65) -> linear sRGB.
_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])

# Bradford adaptation matrix from illuminant E (1,1,1) to D65.
_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])
_WHITE_E = np.array([1.0, 1.0, 1.0])
_WHITE_D65 = np.array([0.95047, 1.0, 1.08883])


def _adaptation_matrix(src_white, dst_white):
    s = _BRADFORD @ src_white
    d = _BRADFORD @ dst_white
    return np.linalg.inv(_BRADFORD) @ np.diag(d / s) @ _BRADFORD


def srgb_encode(linear):
    a = 0.055
    return np.where(linear <= 0.0031308, 12.92 * linear,
                    (1 + a) * np.clip(linear, 0, None) ** (1 / 2.4) - a)


def xyz_to_srgb(xyz, p_norm=98.0, adapt=True):
    """xyz: (3, ny, nx) -> RGB uint8 (ny, nx, 3)."""
    xyz = np.asarray(xyz, np.float64)
    lum = np.percentile(xyz[1], p_norm)
    xyz = xyz / max(lum, 1e-30)
    flat = xyz.reshape(3, -1)
    if adapt:
        flat = _adaptation_matrix(_WHITE_E, _WHITE_D65) @ flat
    rgb = _XYZ_TO_SRGB @ flat
    rgb = srgb_encode(np.clip(rgb, 0.0, 1.0))
    rgb = np.clip(rgb, 0.0, 1.0).reshape(xyz.shape)
    return (np.moveaxis(rgb, 0, -1) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description="XYZ image -> sRGB PNG")
    p.add_argument("--name", default="rte_rrtmgp_output.nc")
    p.add_argument("--output", default="image.png")
    p.add_argument("--p-norm", type=float, default=98.0)
    p.add_argument("--no-adapt", action="store_true",
                   help="skip E->D65 chromatic adaptation")
    args = p.parse_args(argv)

    from ..utils.ncio import NcReader

    with NcReader(args.name) as nc:
        xyz = np.asarray(nc.read("XYZ"))
    rgb = xyz_to_srgb(xyz, args.p_norm, adapt=not args.no_adapt)

    from PIL import Image

    Image.fromarray(rgb).save(args.output)
    print(f"wrote {args.output} ({rgb.shape[1]}x{rgb.shape[0]})")


if __name__ == "__main__":
    main()
