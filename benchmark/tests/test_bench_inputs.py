"""The benchmark's frozen input generators against the program's, and
its work counts."""

import numpy as np
import pytest
import torch

from benchmark.counts import stages
from benchmark.inputs import atmosphere, tables

SEED = 2 ** 31 + 12345


# What the benchmark's tables keep of the program's generator.
SHARED = ("key_species", "bnd_limits_wavenumber", "bnd_limits_gpt",
          "press_ref", "temp_ref", "press_ref_trop", "kmajor")


@pytest.mark.parametrize("longwave", [True, False])
@pytest.mark.parametrize("gpt_per_band", [16, 2])
def test_tables_keep_the_programs_major_tables(longwave, gpt_per_band):
    from rte_rrtmgp_torch.data import synthetic

    a = tables.make_kdist_raw(longwave, SEED, gpt_per_band=gpt_per_band)
    b = synthetic.make_kdist_raw(longwave, SEED, gpt_per_band=gpt_per_band)
    assert a.keys() == b.keys()
    for k in SHARED:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # The program's eight gases keep their places and reference profiles.
    assert np.array_equal(a["gas_names"][:8], b["gas_names"])
    assert np.array_equal(a["vmr_ref"][:, :9], b["vmr_ref"])
    c, d = tables.make_cloud_raw(longwave, SEED), synthetic.make_cloud_raw(
        longwave, SEED)
    assert c.keys() == d.keys()
    for k in c:
        assert np.array_equal(c[k], d[k]), k


@pytest.mark.parametrize("longwave", [True, False])
def test_tables_have_the_published_shapes_and_all_run(longwave):
    """The published files' absorbers and minor intervals, each over one
    band, no identifier twice in a band, and every interval kept by the
    program's loader for the configurations' gases."""
    from rte_rrtmgp_torch.models.kdist import KDist

    raw = tables.make_kdist_raw(longwave, SEED)
    nlo, nup = tables.MINOR_INTERVALS["lw" if longwave else "sw"]
    assert raw["gas_names"].shape[0] == 19
    bands = raw["bnd_limits_gpt"].tolist()
    for suf, n in (("lower", nlo), ("upper", nup)):
        lims = raw[f"minor_limits_gpt_{suf}"]
        ids = raw[f"minor_gases_{suf}"]
        assert lims.shape == (n, 2) and ids.shape[0] == n
        assert all(row in bands for row in lims.tolist())
        assert len({(bytes(i), tuple(l)) for i, l in
                    zip(ids, lims.tolist())}) == n
        assert raw[f"kminor_{suf}"].shape[-1] == n * 16
    kd = KDist.from_raw(raw, atmosphere.GASES, dtype=torch.float32,
                        device="cpu")
    assert kd.gas_names == atmosphere.GASES
    assert (len(kd.minor_lower), len(kd.minor_upper)) == (nlo, nup)


@pytest.mark.parametrize("ncol,nlay", [(4096, 256), (24, 72), (7, 12)])
def test_atmosphere_equals_the_programs(ncol, nlay):
    from rte_rrtmgp_torch.cases.profiles import make_atmosphere

    a = atmosphere.make_atmosphere(ncol, nlay, SEED)
    b = make_atmosphere(ncol, nlay, seed=SEED)
    for k in ("p_lay", "p_lev", "t_lay", "t_lev", "t_sfc", "lwp", "iwp",
              "rel", "dei", "mu0"):
        assert np.array_equal(a[k], b[k]), k
    for g in atmosphere.GASES[:8]:
        assert np.array_equal(np.asarray(a["vmr"][g]),
                              b["gas_concs"].get_vmr(g)), g


def test_step_arrays_equal_the_programs():
    from rte_rrtmgp_torch import step

    a = atmosphere.step_arrays(atmosphere.make_atmosphere(16, 12, 7),
                               gases=step.GASES)
    b = step.atmos_arrays(16, 12, seed=7)
    for k in step.ARG_NAMES:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# The counts stated in PERF.md (section 3), a call of the configuration,
# and at the upstream all-sky example's 24 x 72.
COUNTS = {
    (4096, 256): {"gas_optics": (4234644224, 14461960192),
                  "solvers": (6084460544, 24159191040)},
    (24, 72): {"gas_optics": (30502656, 23832576),
               "solvers": (10126656, 39813120)},
}


@pytest.mark.parametrize("shape", sorted(COUNTS))
def test_counts_repeat_exactly(shape):
    lw, sw = tables.make_kdist_raw(True, SEED), tables.make_kdist_raw(False, 3)
    for name, (nbytes, flops) in COUNTS[shape].items():
        fn = getattr(stages, name)
        args = (*shape, lw, sw) + ((19,) if name == "gas_optics" else ())
        w = fn(*args)
        assert w == fn(*args)
        assert (w["bytes"], w["flops"]) == (nbytes, flops)
        assert stages.least_seconds(w) == max(nbytes / 3.35e12, flops / 67e12)
