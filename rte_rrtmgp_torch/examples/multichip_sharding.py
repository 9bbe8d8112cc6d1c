"""Column-sharding walkthrough, the port of ``examples/multichip_sharding.py``
(the replacement for the reference's MPI/NCCL column blocking,
``src_test/Radiation_solver.cu``'s block loop): columns are independent, so
``RadiationSolverLW.solve(mesh=...)`` runs the whole single-device pipeline,
kernels included, on each column slab of a cols mesh, and the result must
equal the single-device solve.

The mesh lists every card once, or the one card of a one-card machine 4
times (each listing is one shard); on the CPU it lists ``cpu`` 8 times.
The solves pass ``dtype=torch.float32``, as the JAX walkthrough's NumPy
atmosphere enters as float32 with x64 off.

    python -m rte_rrtmgp_torch.examples.multichip_sharding [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..cases.profiles import make_atmosphere
from ..data import synthetic
from ..models import KDist, RadiationSolverLW
from ..parallel import make_mesh
from . import device_from_args

GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
NCOL, NLAY = 64, 40


def mesh_devices(device: torch.device):
    """The shards' devices: every card once (the one card 4 times), or
    ``cpu`` 8 times."""
    if device.type != "cuda":
        return [device] * 8
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [device] * 4)


def main(device) -> dict:
    """The walkthrough on ``device``; returns the single-device and the
    sharded fluxes."""
    device = torch.device(device)
    devices = mesh_devices(device)
    print(f"devices: {len(devices)} x {device.type}")

    kd_lw = KDist.from_raw(synthetic.make_kdist_raw(True, gpt_per_band=4),
                           GASES, dtype=torch.float32, device=device)
    atm = make_atmosphere(NCOL, NLAY, seed=3)
    emis = np.full((NCOL, kd_lw.nbnd), 0.98)
    solver = RadiationSolverLW(kd_lw)
    kw = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
              p_lev=atm["p_lev"], t_lay=atm["t_lay"], t_lev=atm["t_lev"],
              t_sfc=atm["t_sfc"], emis_sfc=emis, dtype=torch.float32)

    # Single-device reference.
    one = solver.solve(**kw)

    # cols mesh: each shard runs the whole pipeline on its columns.
    mesh = make_mesh((len(devices),), ("cols",), devices=devices)
    sharded = solver.solve(mesh=mesh, **kw)

    a = one["lw_flux_up"].cpu().numpy()
    b = sharded["lw_flux_up"].cpu().numpy()
    print(f"cols mesh ({len(devices)} shards): TOA up "
          f"{b[:, -1].mean():8.2f} W/m2, max |delta| vs single device "
          f"{np.abs(a - b).max():.2e}")
    np.testing.assert_allclose(a, b, rtol=5e-6, atol=1e-4)
    print("cols-mesh fluxes match the single-device solve")
    return dict(one=one, sharded=sharded, shards=len(devices))


if __name__ == "__main__":
    main(device_from_args("The port's column-sharding walkthrough."))
