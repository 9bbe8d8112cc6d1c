"""The port's sharding layer (``rte_rrtmgp_torch/parallel``) on the CPU
against the JAX package's (``tests/test_parallel.py``), in float64 at
JAX's size: 16 columns x 8 layers, 4 g-points a band.

* ``RadiationSolverLW/SW.solve(mesh=)`` on 8 CPU shards against JAX's
  ``solve(mesh=mesh8)`` (8 virtual devices) at rtol 1e-10;
* the flagship step sharded on a (4, 2) cols x gpt mesh (the g-slices'
  broadband fluxes summed over ``gpt``) and on an (8,) mesh against JAX's
  unsharded step at rtol 1e-10;
* placement: 8 slabs of 2 columns, the g-slices of ``shard_kdist``, tables
  copied once a mesh;
* refusals: 10 columns over 8 shards, a ``gpt`` axis in ``solve(mesh=)``,
  ``make_mesh()`` with no card;
* the transport ``distributed.initialize`` chooses from the cards its
  processes report (NCCL only where each has one of its own, on any number
  of hosts).
"""

import numpy as np
import pytest
import torch

import jax
import __graft_entry__ as ge
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere as jmake_atmosphere
from rte_rrtmgp_tpu.models import RadiationSolverLW as JSolverLW
from rte_rrtmgp_tpu.models import RadiationSolverSW as JSolverSW
from rte_rrtmgp_tpu.parallel import make_mesh as jmake_mesh

from rte_rrtmgp_torch import step
from rte_rrtmgp_torch.cases.profiles import make_atmosphere
from rte_rrtmgp_torch.models import RadiationSolverLW, RadiationSolverSW
from rte_rrtmgp_torch.parallel import distributed as dist
from rte_rrtmgp_torch.parallel import (column_spec, make_mesh, replicate,
                                       shard_atmosphere, shard_kdist)
from rte_rrtmgp_torch.parallel.mesh import gpt_bounds
from rte_rrtmgp_torch.parallel.sharded import sharded_step

torch.set_num_threads(2)
F64 = torch.float64
RTOL = 1e-10
NCOL, NLAY, GPB = 16, 8, 4
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def tables():
    return step.build_tables(GPB, dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def jax_tables():
    return ge._build(gpt_per_band=GPB, dtype=np.float64)


@pytest.fixture(scope="module")
def arrs():
    return ge._atmos_arrays(ncol=NCOL, nlay=NLAY, dtype=np.float64)


@pytest.fixture(scope="module")
def jax_step_out(jax_tables, arrs):
    out = jax.jit(ge.make_step(*jax_tables))(
        *[arrs[k] for k in step.ARG_NAMES])
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, ref, rtol=RTOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("shape", [(4, 2), (8,)], ids=["cols4xgpt2", "cols8"])
def test_sharded_step_matches_jax_unsharded(tables, arrs, jax_step_out,
                                            shape):
    mesh = make_mesh(shape, ("cols", "gpt"), devices=CPU8)
    out = sharded_step(mesh, *tables)(*[arrs[k] for k in step.ARG_NAMES])
    for v in out.values():
        assert v.shape == (NCOL, NLAY + 1)
    _close(out, jax_step_out)


def test_sharded_step_takes_placed_inputs_and_chunks(tables, arrs,
                                                     jax_step_out):
    """The step on inputs placed beforehand, each shard's g-slice cut
    into chunks of its own (32 LW / 28 SW g-points a shard, chunk 12)."""
    mesh = make_mesh((4, 2), devices=CPU8)
    placed = shard_atmosphere(mesh, tuple(arrs[k] for k in step.ARG_NAMES))
    out = sharded_step(mesh, *tables, gpt_chunk=12)(placed)
    _close(out, jax_step_out)


def _solver_case(ncol, seed):
    atm = make_atmosphere(ncol, NLAY, seed=seed)
    jatm = jmake_atmosphere(ncol, NLAY, seed=seed)
    return atm, jatm


@pytest.fixture(scope="module")
def mesh8_solves(tables, jax_tables):
    """The port's and JAX's LW and SW solves on 8 column shards."""
    kd_lw, kd_sw, cl_lw, cl_sw = tables
    jkd_lw, jkd_sw, jcl_lw, jcl_sw = jax_tables
    atm, jatm = _solver_case(NCOL, seed=2)
    mesh = make_mesh((8,), ("cols",), devices=CPU8)
    jmesh = jmake_mesh((8,), ("cols",), devices=jax.devices()[:8])

    def lw_kw(a):
        return dict(gas_concs=a["gas_concs"], p_lay=a["p_lay"],
                    p_lev=a["p_lev"], t_lay=a["t_lay"], t_lev=a["t_lev"],
                    t_sfc=a["t_sfc"], emis_sfc=np.full((NCOL, 16), 0.98),
                    lwp=a["lwp"], iwp=a["iwp"], rel=a["rel"], dei=a["dei"])

    def sw_kw(a):
        alb = np.full((NCOL, 14), 0.06)
        return dict(gas_concs=a["gas_concs"], p_lay=a["p_lay"],
                    p_lev=a["p_lev"], t_lay=a["t_lay"], mu0=a["mu0"],
                    sfc_alb_dir=alb, sfc_alb_dif=alb, lwp=a["lwp"],
                    iwp=a["iwp"], rel=a["rel"], dei=a["dei"],
                    delta_cloud=True)

    lw, sw = RadiationSolverLW(kd_lw, cl_lw), RadiationSolverSW(kd_sw, cl_sw)
    port = dict(lw=lw.solve(mesh=mesh, **lw_kw(atm)),
                sw=sw.solve(mesh=mesh, **sw_kw(atm)),
                lw_one=lw.solve(**lw_kw(atm)))
    n_copies = len(mesh.copies)
    port["lw_again"] = lw.solve(mesh=mesh, **lw_kw(atm))
    port["copies"] = (n_copies, len(mesh.copies))
    jlw, jsw = JSolverLW(jkd_lw, jcl_lw), JSolverSW(jkd_sw, jcl_sw)
    ref = dict(lw=jlw.solve(mesh=jmesh, **lw_kw(jatm)),
               sw=jsw.solve(mesh=jmesh, **sw_kw(jatm)))
    return port, {k: {n: np.asarray(a) for n, a in v.items()}
                  for k, v in ref.items()}


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_solve_mesh_matches_jax_mesh(mesh8_solves, band):
    port, ref = mesh8_solves
    _close(port[band], ref[band])


def test_solve_mesh_equals_unsharded_and_copies_tables_once(mesh8_solves):
    port, _ = mesh8_solves
    for k, v in port["lw_one"].items():
        torch.testing.assert_close(port["lw"][k], v, rtol=1e-12, atol=0)
        torch.testing.assert_close(port["lw_again"][k], v, rtol=0, atol=0)
    before, after = port["copies"]
    assert before > 0 and after == before


def test_column_placement(arrs):
    mesh = make_mesh((8,), ("cols",), devices=CPU8)
    placed = shard_atmosphere(mesh, {"p_lay": arrs["p_lay"],
                                     "t_sfc": arrs["t_sfc"]})
    assert placed.parts.shape == (8, 1)
    for (c, g), part in placed.local():
        assert part["p_lay"].shape == (2, NLAY)
        np.testing.assert_array_equal(part["p_lay"].numpy(),
                                      arrs["p_lay"][2 * c:2 * c + 2])
        np.testing.assert_array_equal(part["t_sfc"].numpy(),
                                      arrs["t_sfc"][2 * c:2 * c + 2])
    assert column_spec(mesh, 3) == ("cols", None, None)


def test_kdist_gpt_slices(tables):
    kd_lw = tables[0]
    mesh = make_mesh((4, 2), devices=CPU8)
    placed = shard_kdist(kd_lw, mesh)
    assert mesh.shape == {"cols": 4, "gpt": 2}
    for (c, g), kd in placed.local():
        g0, g1 = gpt_bounds(kd_lw.ngpt, 2, g)
        assert (g0, g1) == (32 * g, 32 * g + 32)
        assert kd.ngpt == 32
        assert kd.gpt2band == kd_lw.gpt2band[g0:g1]      # global bands
        torch.testing.assert_close(kd.kmajor, kd_lw.kmajor[g0:g1],
                                   rtol=0, atol=0)
        torch.testing.assert_close(kd.kmajor_rows,
                                   kd_lw.kmajor_rows[:, :, g0:g1],
                                   rtol=0, atol=0)
    # no gpt axis: the whole table everywhere, one copy a device
    whole = shard_kdist(kd_lw, make_mesh((8,), devices=CPU8))
    assert all(kd.ngpt == kd_lw.ngpt for _, kd in whole.local())
    rep = replicate(mesh, (kd_lw,))
    assert rep.parts[0, 0][0].kmajor is rep.parts[3, 1][0].kmajor
    assert [gpt_bounds(7, 3, g) for g in range(3)] == [(0, 3), (3, 5), (5, 7)]


def test_indivisible_columns_refused(tables):
    kd_lw, _, cl_lw, _ = tables
    atm = make_atmosphere(10, NLAY, seed=3)
    mesh = make_mesh((8,), ("cols",), devices=CPU8)
    with pytest.raises(ValueError, match="divide"):
        RadiationSolverLW(kd_lw, cl_lw).solve(
            gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
            p_lev=atm["p_lev"], t_lay=atm["t_lay"], t_lev=atm["t_lev"],
            t_sfc=atm["t_sfc"], emis_sfc=np.full((10, 16), 0.98),
            mesh=mesh)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_gpt_axis_refused_by_solve(tables, band):
    kd_lw, kd_sw, cl_lw, cl_sw = tables
    atm = make_atmosphere(NCOL, NLAY, seed=3)
    mesh = make_mesh((4, 2), devices=CPU8)
    common = dict(gas_concs=atm["gas_concs"], p_lay=atm["p_lay"],
                  p_lev=atm["p_lev"], t_lay=atm["t_lay"], mesh=mesh)
    with pytest.raises(ValueError, match="cols-only"):
        if band == "lw":
            RadiationSolverLW(kd_lw, cl_lw).solve(
                t_lev=atm["t_lev"], t_sfc=atm["t_sfc"],
                emis_sfc=np.full((NCOL, 16), 0.98), **common)
        else:
            alb = np.full((NCOL, 14), 0.06)
            RadiationSolverSW(kd_sw, cl_sw).solve(
                mu0=atm["mu0"], sfc_alb_dir=alb, sfc_alb_dif=alb, **common)


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((4, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((4, 2), ("x", "y"), devices=CPU8)


@pytest.mark.parametrize("cards, backend", [
    ([f"GPU-{h}{i}" for h in "ab" for i in range(8)], "nccl"),  # 2 x 8 cards
    (["GPU-a0"], "nccl"),
    (["GPU-a0", "GPU-a0"], "gloo"),                             # one shared
    ([f"GPU-a{i % 8}" for i in range(16)], "gloo"),             # 16 on 8
    (["", ""], "gloo"),                                         # the CPU
])
def test_default_backend(cards, backend):
    assert dist.default_backend(cards) == backend


def test_card_id_names_the_physical_card(monkeypatch):
    from types import SimpleNamespace
    props = SimpleNamespace(uuid="GPU-1234")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    assert dist._card_id(torch.device("cuda", 3)) == "GPU-1234"
    props.uuid = None
    assert dist._card_id(torch.device("cuda", 3)).endswith("/cuda:3")
    assert dist._card_id(torch.device("cpu")) == ""
