"""Share (%) of the least time of the solve stages' work
(``counts/stages.solvers``) in the card's time inside the driver's
``lw_solve`` and ``sw_solve`` ranges (the LW sweep and SW two-stream
kernels with their surface and top-of-atmosphere inputs)."""

from benchmark.counts import stages as counts

STAGES = ("lw_solve", "sw_solve")


def read(trace, cell):
    if not trace.has_stage(STAGES):
        return None
    work = counts.solvers(cell.ncol, cell.nlay, cell.raws["kd_lw"],
                          cell.raws["kd_sw"])
    return 100.0 * counts.least_seconds(work) / (trace.stage_us(STAGES) * 1e-6)
