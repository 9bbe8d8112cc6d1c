"""The CMIP radiation call: the flagship step with
``make_step(..., clear_sky=True)``, as :mod:`benchmark.entries.step` runs
it otherwise (tensors already on the card, the configuration's precision,
the layout the program's ``config`` resolves, ``gpt_chunk`` from the
traffic mix).  One call returns the seven all-sky and the seven clear-sky
LW + SW broadband fluxes from one gas-optics pass; a program whose
``make_step`` has no ``clear_sky`` fails at set-up."""

from __future__ import annotations

import torch

from benchmark.entries import step
from benchmark.inputs import atmosphere

RUNS = {"clouds": True, "aerosols": False, "n_gauss_angles": 1}


class Entry(step.Entry):
    def __init__(self, cell, device):
        from rte_rrtmgp_torch import step as program
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
                     for k in program.ARG_NAMES]
        self.run = program.make_step(*tables,
                                     gpt_chunk=cell.traffic.get("gpt_chunk"),
                                     clear_sky=True)
        self.delta_cloud = True
