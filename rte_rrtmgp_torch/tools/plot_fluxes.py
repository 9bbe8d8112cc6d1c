"""Plot flux profiles from a solver output NetCDF: the analog of the
reference's ``allsky/allsky_plot.py`` (the same panels: sw dn, sw dir,
sw up, lw dn, lw up against pressure), optionally overlaying a second
file for comparison.

The port's counterpart of the JAX package's ``tools/plot_fluxes.py``,
reading through ``utils/ncio``.  A flux variable of the CLI's output is
(lev, y, x); each panel shows its mean over the columns.  A host-side
tool: it needs matplotlib (imported inside :func:`main`), which the card's
machine does not have.

Usage: python -m rte_rrtmgp_torch.tools.plot_fluxes rte_rrtmgp_output.nc
           [reference.nc] [--input rte_rrtmgp_input.nc] [--out fluxes.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.ncio import NcReader

VARS = ("sw_flux_dn", "sw_flux_dn_dir", "sw_flux_up",
        "lw_flux_dn", "lw_flux_up")


def column_means(path: str) -> dict:
    """{variable: (nlev,) mean profile over the columns} of the fluxes in
    :data:`VARS` that ``path`` holds."""
    with NcReader(path) as nc:
        return {v: (lambda a: a.reshape(a.shape[0], -1).mean(axis=1))(
            np.asarray(nc.read(v), np.float64)) for v in VARS if nc.has(v)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", help="solver output NetCDF")
    p.add_argument("ref", nargs="?", default=None,
                   help="optional second file to overlay (dashed)")
    p.add_argument("--input", default="rte_rrtmgp_input.nc",
                   help="input file holding p_lev (else the level index)")
    p.add_argument("--out", default="fluxes.png")
    args = p.parse_args(argv)
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit("plot_fluxes needs matplotlib, which is not "
                         "installed here; run it on a host that has it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    run = column_means(args.run)
    ref = column_means(args.ref) if args.ref else {}
    if not run:
        raise SystemExit(f"no flux variables {VARS} in {args.run}")
    nlev = len(next(iter(run.values())))
    y, ylabel = np.arange(nlev), "level"
    if os.path.exists(args.input):
        with NcReader(args.input) as nc:
            if nc.has("p_lev"):
                y = np.asarray(nc.read("p_lev")).reshape(nlev, -1)[:, 0] / 1e3
                ylabel = "p (kPa)"

    names = [v for v in VARS if v in run]
    fig, axes = plt.subplots(1, len(names), figsize=(3.2 * len(names), 5),
                             sharey=True)
    axes = np.atleast_1d(axes)
    for ax, v in zip(axes, names):
        ax.plot(run[v], y, "C0-", label=os.path.basename(args.run))
        if v in ref:
            ax.plot(ref[v], y, "k--", label=os.path.basename(args.ref))
        ax.set_title(v, fontsize=9)
        ax.set_xlabel("W m$^{-2}$")
    if ylabel.startswith("p"):
        axes[0].invert_yaxis()
    axes[0].set_ylabel(ylabel)
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out} ({len(names)} panels, column-mean profiles)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
