"""Device ms a call of the plain optics stages: the card's work inside
the driver's ranges of the interpolation weights, the cloud optics, the
Planck sources, the SW gas/Rayleigh combination and the cloud increments
(the program's plain PyTorch, ``ops/gas_optics``, ``ops/cloud_optics``,
``ops/optics_ops``)."""

STAGES = ("lw_cloud_optics", "sw_cloud_optics", "lw_interpolation",
          "sw_interpolation", "lw_planck", "sw_combine", "lw_cloud_add",
          "sw_cloud_increment")


def read(trace, cell):
    if not trace.has_stage(STAGES):
        return None
    return trace.stage_us(STAGES) / 1e3
