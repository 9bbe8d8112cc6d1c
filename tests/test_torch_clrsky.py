"""The clear-sky call (``step.make_step(..., clear_sky=True)``) on the CPU
at the tiny size of ``benchmark/tests/tiny.py`` (8 columns x 12 layers, 2
g-points a band, the benchmark's published-shape tables), in each
layout: its all-sky fluxes bit-equal to those of ``clear_sky=False``, its
clear-sky fluxes held to the benchmark's plain reference and to the
program's own all-sky call without clouds, one gas-optics pass a chunk
feeding the SW's fused entry twice (no increment, then the clouds), the
clear-sky g-point counter, and the refused combinations."""

import numpy as np
import pytest
import torch

from benchmark.inputs import atmosphere, tables
from benchmark.reference import rrtmgp_clrsky
from benchmark.tests.tiny import TINY, TINY_LIMITS
from rte_rrtmgp_torch import step
from rte_rrtmgp_torch.models.cloud_lut import CloudLUT
from rte_rrtmgp_torch.models.kdist import KDist
from rte_rrtmgp_torch.models.radiation import _solve_lw_impl, _solve_sw_impl
from rte_rrtmgp_torch.ops import gas_optics, kernels, rte_sw

torch.set_num_threads(2)

SEED = 2 ** 31 + 16
CHUNK = 16          # two chunks in the LW (32 g-points) and the SW (28)
LAYOUTS = {"default": dict(cellw=True, layer_major=False),
           "cellw_off": dict(cellw=False, layer_major=False),
           "layer_major": dict(cellw=True, layer_major=True)}
ALLSKY = ("lw_flux_up", "lw_flux_dn", "lw_flux_net", "sw_flux_up",
          "sw_flux_dn", "sw_flux_dn_dir", "sw_flux_net")
CLRSKY = tuple(k.replace("_flux", "_clrsky_flux") for k in ALLSKY)


@pytest.fixture(scope="module")
def case():
    """The raw tables and the atmosphere from the seed, as the benchmark
    makes them for a cell."""
    gpb = TINY["gpt_per_band"]
    raws = {"kd_lw": tables.make_kdist_raw(True, SEED, gpt_per_band=gpb),
            "kd_sw": tables.make_kdist_raw(False, SEED, gpt_per_band=gpb),
            "cloud_lw": tables.make_cloud_raw(True, SEED),
            "cloud_sw": tables.make_cloud_raw(False, SEED)}
    atm = atmosphere.make_atmosphere(TINY["ncol"], TINY["nlay"], SEED)
    return raws, atm


def _tables(raws, dtype):
    return (KDist.from_raw(raws["kd_lw"], atmosphere.GASES, dtype=dtype,
                           device="cpu"),
            KDist.from_raw(raws["kd_sw"], atmosphere.GASES, dtype=dtype,
                           device="cpu"),
            CloudLUT.from_raw(raws["cloud_lw"], dtype=dtype, device="cpu"),
            CloudLUT.from_raw(raws["cloud_sw"], dtype=dtype, device="cpu"))


def _args(atm, dtype, **change):
    arr = atmosphere.step_arrays(atm, torch.empty((), dtype=dtype).numpy()
                                 .dtype)
    arr.update(change)
    return arr, [torch.as_tensor(arr[k]) for k in step.ARG_NAMES]


def _run(raws, args, dtype, layout, clear_sky):
    run = step.make_step(*_tables(raws, dtype), gpt_chunk=CHUNK,
                         clear_sky=clear_sky, **LAYOUTS[layout])
    return run(*args)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_allsky_outputs_bit_equal(case, layout):
    raws, atm = case
    _, args = _args(atm, torch.float32)
    off = _run(raws, args, torch.float32, layout, False)
    on = _run(raws, args, torch.float32, layout, True)
    assert set(off) == set(ALLSKY) and set(on) == set(ALLSKY + CLRSKY)
    for k in ALLSKY:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_clrsky_within_tiny_limits_of_reference(case, layout):
    """float32 against the plain reference in float64, at the limits a tiny
    run of the benchmark holds the all-sky fluxes to."""
    raws, atm = case
    arr, args = _args(atm, torch.float32)
    got = _run(raws, args, torch.float32, layout, True)
    ref = rrtmgp_clrsky.outputs(
        raws, dict(arr, gases=atmosphere.GASES),
        {"delta_cloud": True, "guard_dtype": torch.float32}, "cpu")
    for keys, lim in ((CLRSKY[:3], TINY_LIMITS["lw_flux_err_wm2"]),
                      (CLRSKY[3:], TINY_LIMITS["sw_flux_err_wm2"])):
        for k in keys:
            gap = float(np.abs(got[k].double().numpy() - ref[k]).max())
            assert gap <= lim, (k, gap)
    # Clouds shade: the clear- and all-sky fluxes differ far beyond that.
    assert float((got["sw_clrsky_flux_dn"] - got["sw_flux_dn"]).abs()
                 .max()) > 100 * TINY_LIMITS["sw_flux_err_wm2"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_clrsky_equals_allsky_without_clouds_f64(case, layout):
    raws, atm = case
    _, args = _args(atm, torch.float64)
    got = _run(raws, args, torch.float64, layout, True)
    zero = np.zeros_like(atm["lwp"])
    _, dry = _args(atm, torch.float64, lwp=zero, iwp=zero)
    ref = _run(raws, dry, torch.float64, layout, False)
    for k, c in zip(ALLSKY, CLRSKY):
        assert float((got[c] - ref[k]).abs().max()) <= 1e-5, c


def _count_fused(monkeypatch, layout):
    """The number of increments of each call of the layout's fused SW
    entry."""
    name = ("sw_solver_2stream_fused_broadband_lm" if layout == "layer_major"
            else "sw_solver_2stream_fused_broadband")
    fused, incs = getattr(rte_sw, name), []
    monkeypatch.setattr(rte_sw, name, lambda *a, **k: (
        incs.append(len(a[2])), fused(*a, **k))[1])
    return incs


@pytest.mark.parametrize("clear_sky", [False, True], ids=["off", "on"])
def test_one_gas_optics_pass_a_chunk(case, monkeypatch, clear_sky):
    """The gas-optics entry points run once a chunk, with or without the
    clear-sky solves; the SW solves take the chunk's gas optics through
    the fused entry, the clear-sky one with no increment and the all-sky
    one with the clouds; ``clrsky_gpts`` counts every g-point of both
    spectra once a clear-sky call."""
    raws, atm = case
    calls = {}
    for name in ("tau_majmin_and_pfrac", "tau_majmin_and_rayleigh"):
        fn = getattr(gas_optics, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(gas_optics, name, counted)
    incs = _count_fused(monkeypatch, "default")
    _, args = _args(atm, torch.float32)
    kernels.reset_launch_counts()
    _run(raws, args, torch.float32, "default", clear_sky)
    ngpt_lw, ngpt_sw = TINY["ngpt_lw"], TINY["ngpt_sw"]
    assert calls == {"tau_majmin_and_pfrac": -(-ngpt_lw // CHUNK),
                     "tau_majmin_and_rayleigh": -(-ngpt_sw // CHUNK)}
    assert incs == ([0, 1] if clear_sky else [1]) * -(-ngpt_sw // CHUNK)
    assert kernels.clrsky_gpts() == (ngpt_lw + ngpt_sw if clear_sky else 0)
    kernels.reset_launch_counts()
    assert kernels.clrsky_gpts() == 0


@pytest.mark.parametrize("clear_sky", [False, True], ids=["off", "on"])
def test_layer_major_sw_solves_through_fused_entry(case, monkeypatch,
                                                   clear_sky):
    """The layer-major SW solves too take the chunk's gas optics through
    the fused entry: no increment clear-sky, the clouds all-sky."""
    raws, atm = case
    incs = _count_fused(monkeypatch, "layer_major")
    _, args = _args(atm, torch.float32)
    out = _run(raws, args, torch.float32, "layer_major", clear_sky)
    nchunks = -(-TINY["ngpt_sw"] // CHUNK)
    assert incs == ([0, 1] if clear_sky else [1]) * nchunks
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


@pytest.mark.parametrize("flag,value", [("output_bnd_fluxes", True),
                                        ("output_optical", True),
                                        ("with_fluxes", False)])
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
def test_clear_sky_refuses_other_outputs(case, flag, value, longwave):
    raws, atm = case
    kd_lw, kd_sw, cl_lw, cl_sw = _tables(raws, torch.float32)
    arr, _ = _args(atm, torch.float32)
    x = {k: torch.as_tensor(v) for k, v in arr.items()}
    flags = dict(top_at_1=False, gpt_chunk=CHUNK, output_bnd_fluxes=False,
                 clear_sky=True)
    flags[flag] = value
    with pytest.raises(ValueError,
                       match=f"clear_sky=True with {flag}={value}"):
        if longwave:
            _solve_lw_impl(kd_lw, cl_lw, *(x[k] for k in (
                "p_lay", "p_lev", "t_lay", "t_lev", "t_sfc", "vmr", "col_dry",
                "emis_sfc", "lwp", "iwp", "rel", "dei")),
                n_gauss_angles=1, with_clouds=True, **flags)
        else:
            _solve_sw_impl(kd_sw, cl_sw, None, *(x[k] for k in (
                "p_lay", "p_lev", "t_lay", "vmr", "col_dry", "sfc_alb_dir",
                "sfc_alb_dif", "tsi_scaling", "mu0", "lwp", "iwp", "rel",
                "dei")), torch.zeros_like(x["lwp"]), None,
                with_clouds=True, with_aerosols=False, delta_cloud=True,
                delta_aerosol=False, **flags)
