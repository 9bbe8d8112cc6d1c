"""Share (%) of the least time of the solve stages' work
(``counts/stages.solvers``) in the card's time inside the driver's
clear-sky ranges ``lw_solve_clrsky`` and ``sw_solve_clrsky`` (the LW
sweep and SW two-stream kernels on the gas-only optics, with the chunk's
surface and top-of-atmosphere inputs that both solves share); None where
the call makes no clear-sky solve."""

from benchmark.counts import stages as counts

STAGES = ("lw_solve_clrsky", "sw_solve_clrsky")


def read(trace, cell):
    if not trace.has_stage(STAGES):
        return None
    work = counts.solvers(cell.ncol, cell.nlay, cell.raws["kd_lw"],
                          cell.raws["kd_sw"])
    return 100.0 * counts.least_seconds(work) / (trace.stage_us(STAGES) * 1e-6)
