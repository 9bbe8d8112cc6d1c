"""The flagship step: ``rte_rrtmgp_torch.step.make_step`` over tensors
already on the card (a GPU model keeps its state there), in the
configuration's precision and the layout the program's ``config``
resolves, ``gpt_chunk`` from the traffic mix.  One call is one LW + SW
all-sky broadband solve (clouds on, delta-scaled in the SW, no aerosols,
one Gauss angle: the step runs only that)."""

from __future__ import annotations

import torch

from benchmark.inputs import atmosphere

RUNS = {"clouds": True, "aerosols": False, "n_gauss_angles": 1}


class Entry:
    def __init__(self, cell, device):
        from rte_rrtmgp_torch import step
        from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
        from rte_rrtmgp_torch.models.kdist import KDist

        self.device = torch.device(device)
        dt = cell.dtype
        r = cell.raws
        tables = (KDist.from_raw(r["kd_lw"], cell.gases, dtype=dt,
                                 device=self.device),
                  KDist.from_raw(r["kd_sw"], cell.gases, dtype=dt,
                                 device=self.device),
                  CloudLUT.from_raw(r["cloud_lw"], dtype=dt,
                                    device=self.device),
                  CloudLUT.from_raw(r["cloud_sw"], dtype=dt,
                                    device=self.device))
        self.gases = cell.gases
        self.arrays = atmosphere.step_arrays(
            cell.atm, torch.empty((), dtype=dt).numpy().dtype, cell.gases)
        self.args = [torch.as_tensor(self.arrays[k], device=self.device)
                     for k in step.ARG_NAMES]
        self.run = step.make_step(*tables,
                                  gpt_chunk=cell.traffic.get("gpt_chunk"))
        self.delta_cloud = True

    def call(self):
        out = self.run(*self.args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def reference_inputs(self) -> dict:
        return dict(self.arrays, gases=self.gases)

    def close(self):
        self.run = self.args = None
