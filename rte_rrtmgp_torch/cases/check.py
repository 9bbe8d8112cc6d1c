"""Output comparison — equivalent of the reference's validation scripts
(``allsky/allsky_check.py:27-80`` and rrtmgp's compare-to-reference.py):
per-variable max-abs and percent differences with a failure threshold,
plus NaN checks."""

from __future__ import annotations

import sys

import numpy as np

from ..utils.ncio import NcReader

DEFAULT_VARS = ("lw_flux_up", "lw_flux_dn", "lw_flux_net",
                "sw_flux_up", "sw_flux_dn", "sw_flux_dn_dir", "sw_flux_net")


def compare(test_path: str, ref_path: str, variables=None,
            failure_threshold: float = 5.8e-2, verbose: bool = True) -> bool:
    """Return True when every shared variable matches within the threshold
    (max abs diff in W m-2 — the reference CI gate, rfmip/check_rfmip.sh:4-5)."""
    ok = True
    with NcReader(test_path) as t, NcReader(ref_path) as r:
        names = variables or [v for v in DEFAULT_VARS if t.has(v) and r.has(v)]
        if not names:
            print("no flux variables in common — nothing compared")
            return False
        for name in names:
            if not (t.has(name) and r.has(name)):
                if verbose:
                    print(f"{name}: MISSING in one file")
                ok = False
                continue
            a = np.asarray(t.read(name), dtype=np.float64)
            b = np.asarray(r.read(name), dtype=np.float64)
            if a.shape != b.shape:
                print(f"{name}: shape mismatch {a.shape} vs {b.shape}")
                ok = False
                continue
            if np.isnan(a).any() or np.isnan(b).any():
                print(f"{name}: contains NaN")
                ok = False
                continue
            diff = np.abs(a - b)
            maxdiff = diff.max()
            denom = np.maximum(np.abs(b), 1e-30)
            maxpct = (diff / denom).max() * 100.0
            status = "PASS" if maxdiff <= failure_threshold else "FAIL"
            if verbose:
                print(f"{name}: max abs diff {maxdiff:.3e} W m-2 "
                      f"(max {maxpct:.4f}%) [{status}]")
            ok &= maxdiff <= failure_threshold
    return ok


def self_consistency(path: str, verbose: bool = True) -> bool:
    """Single-file physics checks (no reference needed): finite fluxes,
    net == dn - up, by-band sums reproduce the broadband fluxes, and
    non-negative up/down fluxes."""
    ok = True
    with NcReader(path) as nc:
        def get(name):
            return (np.asarray(nc.read(name), np.float64)
                    if nc.has(name) else None)

        for sw_lw in ("lw", "sw"):
            up, dn = get(f"{sw_lw}_flux_up"), get(f"{sw_lw}_flux_dn")
            net = get(f"{sw_lw}_flux_net")
            if up is None:
                continue
            for name, a in ((f"{sw_lw}_flux_up", up), (f"{sw_lw}_flux_dn", dn)):
                if not np.isfinite(a).all():
                    print(f"{name}: non-finite values"); ok = False
                if a.min() < -1e-6:
                    print(f"{name}: negative flux {a.min():.3e}"); ok = False
            if net is not None:
                err = np.abs(net - (dn - up)).max()
                if err > 1e-4:
                    print(f"{sw_lw}_flux_net != dn-up (max {err:.2e})")
                    ok = False
                elif verbose:
                    print(f"{sw_lw}: net == dn - up (max err {err:.2e}) [PASS]")
            bnd_up = get(f"{sw_lw}_bnd_flux_up")
            if bnd_up is not None:
                # band axis is leading in the file layout (band, lev, y, x)
                err = np.abs(bnd_up.sum(axis=0) - up).max()
                rel = err / max(np.abs(up).max(), 1e-30)
                if rel > 1e-5:
                    print(f"{sw_lw}: band sum != broadband ({rel:.2e})")
                    ok = False
                elif verbose:
                    print(f"{sw_lw}: band sums match broadband [PASS]")
        sw_dir = get("sw_flux_dn_dir")
        sw_dn = get("sw_flux_dn")
        if sw_dir is not None and sw_dn is not None:
            if (sw_dir - sw_dn).max() > 1e-4:
                print("sw direct exceeds total downward"); ok = False
            elif verbose:
                print("sw: direct <= total downward [PASS]")
    return ok


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Compare radiation outputs")
    p.add_argument("test_file")
    p.add_argument("ref_file", nargs="?", default=None)
    p.add_argument("--failure-threshold", type=float, default=5.8e-2)
    p.add_argument("--variables", nargs="*", default=None)
    p.add_argument("--self-consistency", action="store_true",
                   help="single-file physics checks instead of a reference "
                        "comparison")
    args = p.parse_args(argv)
    if args.self_consistency:
        ok = self_consistency(args.test_file)
    else:
        if args.ref_file is None:
            p.error("ref_file required unless --self-consistency")
        ok = compare(args.test_file, args.ref_file, args.variables,
                     args.failure_threshold)
    print("PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
