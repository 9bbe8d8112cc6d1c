"""Cross-device / cross-precision validation: the analog of the
reference's GPU-vs-CPU check (``rcemip/compare.py``) and the platform
gate of PARITY.md:144-154.

The port's counterpart of the JAX package's ``tools/crosscheck.py``.  The
``allsky`` and ``aerosky`` cases (``cases.inputs.make_case_files``, 24
columns x 72 layers, ``--gpt-per-band 8``) run through ``cli.main`` with
``--cloud-optics --delta-cloud --gpt-chunk 64`` (plus ``--aerosol-optics
--delta-aerosol`` for aerosky), in-process, three ways each:

  1. CPU float64 (the plain twins);
  2. CPU float32 (the plain twins);
  3. ``--device`` float32: on the card (default ``cuda``; raises without
     one) the gas-optics and solver kernels and the aerosol optics.

Then ``cases.check.compare``: device f32 against CPU f32 within 0.7 W m-2
(the gate) and CPU f32 against CPU f64 within 2.0 W m-2 (informational,
the intrinsic single-precision error).  Exit 1 when the gate fails.

History of the gate, in the JAX reference on a TPU (not the port's
numbers): it was first set bitwise (1e-4), then made physical at 0.7 W
m-2 after a TPU-vs-CPU divergence of up to 0.55 W m-2 was traced to the
two XLA backends' transcendental code generation rather than to the
kernels; the reference's f32-vs-f64 error on this case reached 0.54 W m-2
in the LW and 1.45 W m-2 in the SW.

Usage: python -m rte_rrtmgp_torch.tools.crosscheck [workdir]
           [--device cuda] [--gpt-per-band 8]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import cli, config
from ..cases import check, inputs
from ..ops import kernels
from ..utils.ncio import NcReader

GATE_WM2 = 0.7          # device f32 vs CPU f32 (PARITY.md:144-154)
INFO_WM2 = 2.0          # CPU f32 vs CPU f64, informational
COMMON = ["--cloud-optics", "--delta-cloud", "--gpt-chunk", "64"]
CASES = {"allsky": [], "aerosky": ["--aerosol-optics", "--delta-aerosol"]}


def max_diffs(path_a: str, path_b: str) -> dict:
    """Max abs difference (W m-2) of every broadband flux both files hold."""
    out = {}
    with NcReader(path_a) as a, NcReader(path_b) as b:
        for v in check.DEFAULT_VARS:
            if a.has(v) and b.has(v):
                out[v] = float(np.abs(a.read(v).astype(np.float64)
                                      - b.read(v)).max())
    return out


def run(workdir: str = os.path.join("build", "crosscheck"), device="cuda",
        gpt_per_band: int = 8, cases=tuple(CASES)) -> dict:
    """``cases`` (both by default), three legs each.  Returns {"ok", case:
    {"ok", "dev_vs_cpu_f32", "cpu_f32_vs_f64" (max diffs), "launches"
    (kernel launches of each leg), "files"}}."""
    dev = config.resolve_device(device)
    legs = (("cpu_f64", "cpu", "float64"), ("cpu_f32", "cpu", "float32"),
            ("dev_f32", str(dev), "float32"))
    res = {"ok": True}
    for case in cases:
        extra = CASES[case]
        d = os.path.join(workdir, case)
        paths = inputs.make_case_files(d, case, gpt_per_band=gpt_per_band)
        files = ["--input", paths["input"], "--coefs-lw", paths["coefs_lw"],
                 "--coefs-sw", paths["coefs_sw"], "--cloud-lw",
                 paths["cloud_lw"], "--cloud-sw", paths["cloud_sw"],
                 "--aerosol", paths["aerosol"]]
        out = {leg: os.path.join(d, leg + ".nc") for leg, _, _ in legs}
        launches = {}
        for leg, leg_dev, precision in legs:
            print(f"running {case} {leg} ({leg_dev}, {precision}) ...",
                  flush=True)
            before = kernels.launch_counts()
            rc = cli.main(files + COMMON + extra + [
                "--precision", precision, "--device", leg_dev,
                "--output", out[leg]])
            if rc != 0:
                raise RuntimeError(f"crosscheck {case} {leg}: cli rc {rc}")
            after = kernels.launch_counts()
            launches[leg] = {k: n - before.get(k, 0) for k, n in after.items()
                             if n != before.get(k, 0)}
        print(f"\n--- {case}: device f32 vs CPU f32 (device/kernel "
              "divergence) ---")
        ok = check.compare(out["dev_f32"], out["cpu_f32"],
                           failure_threshold=GATE_WM2)
        print(f"\n--- {case}: CPU f32 vs CPU f64 (intrinsic single-precision "
              "error, informational) ---")
        check.compare(out["cpu_f32"], out["cpu_f64"],
                      failure_threshold=INFO_WM2)
        res[case] = {"ok": ok,
                     "dev_vs_cpu_f32": max_diffs(out["dev_f32"], out["cpu_f32"]),
                     "cpu_f32_vs_f64": max_diffs(out["cpu_f32"], out["cpu_f64"]),
                     "launches": launches, "files": out}
        res["ok"] &= ok
    print("\nPLATFORM CHECK:", "PASSED" if res["ok"] else "FAILED", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", default=os.path.join("build",
                                                              "crosscheck"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--gpt-per-band", type=int, default=8)
    a = p.parse_args(argv)
    return 0 if run(a.workdir, a.device, a.gpt_per_band)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
