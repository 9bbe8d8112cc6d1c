"""Share (%) of the least time of the gas-optics stages' work
(``counts/stages.gas_optics``: bytes over 3.35 TB/s or float32 operations
over 67 TFLOP/s, the larger) in the card's time inside the driver's
``lw_gas_optics`` and ``sw_gas_optics`` ranges (the gas-optics kernel with
the minor-gas scaling)."""

from benchmark.counts import stages as counts

STAGES = ("lw_gas_optics", "sw_gas_optics")


def read(trace, cell):
    if not trace.has_stage(STAGES):
        return None
    work = counts.gas_optics(cell.ncol, cell.nlay, cell.raws["kd_lw"],
                             cell.raws["kd_sw"], len(cell.gases))
    return 100.0 * counts.least_seconds(work) / (trace.stage_us(STAGES) * 1e-6)
