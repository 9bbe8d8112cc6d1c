"""The port's forward Monte-Carlo tracer (``rte_rrtmgp_torch/models/
raytracer.py``) against the JAX package's, on the same NumPy inputs.

* Deterministic pieces in float64 at rtol 1e-10 (absolute floor 1e-12 of
  each array's largest value, see ``ULP_FLOOR``): the knull grid (exact),
  the Rayleigh, Henyey-Greenstein and Mie samplers on the same uniforms,
  the Mie phase value, ``_scatter_direction``, ``bundle_optical_props``
  and ``sun_direction_from_angles``.
* Truncated replay in float64: JAX traces a tiny heterogeneous cloudy
  domain for a few steps; the port traces the same case with its draw
  functions replaced by JAX's threefry stream (``split`` then ``uniform``,
  in JAX's order and shapes), and every output lies within 1e-9 of its
  largest value of JAX's.  Cases: G == 1 with fifo respawn, and a pooled
  G == 2 window with Mie sampling and pool respawn.
* Full runs, statistical: energy closure; JAX's domain means within 4
  sigma of the Monte-Carlo error (sigma from the spread of a few port
  seeds) at equal photon counts; compaction on against off and the three
  respawn modes against each other; a batched (``lanes``) trace equal to
  separate traces up to accumulation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models import raytracer as jrt

from rte_rrtmgp_torch.models import raytracer as rt

torch.set_num_threads(2)

NZ, NY, NX = 6, 3, 4
GRID_D = (500.0, 800.0, 700.0)
KN = (2, 3, 2)
SUN = jrt.sun_direction_from_angles(0.6, 0.3)
# The JAX references are compiled (op by op they cost seconds); compiled,
# XLA's vectorized transcendentals and fused products differ from the
# eager ones by up to ~1e-14 of an array's largest value, from one run to
# the next, so values near zero get an absolute floor of 1e-12 of it.
ULP_FLOOR = 1e-12
FIELDS = ("flux_toa_down", "flux_tod_up", "flux_sfc_dir", "flux_sfc_dif",
          "flux_sfc_up", "flux_abs_dir", "flux_abs_dif")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _cloudy(seed=3, G=None):
    """A tiny heterogeneous domain: gas, a broken cloud and aerosol."""
    rng = np.random.default_rng(seed)
    sh = (NZ, NY, NX) if G is None else (G, NZ, NY, NX)
    kg = rng.uniform(1e-5, 1e-4, sh)
    cld = np.where(rng.random(sh) < 0.4, rng.uniform(1e-3, 5e-3, sh), 0.0)
    ka = rng.uniform(0.0, 2e-5, sh)
    fields = [kg + cld + ka, 0.5 * kg, 0.99 * cld, 0.8 * ka,
              np.where(cld > 0, 0.85, 0.0), np.full(sh, 0.7)]
    alb = rng.uniform(0.05, 0.3, sh[:-3] + (NY, NX))
    reff = rng.uniform(3.0, 15.0, (NZ, NY, NX))
    return fields, reff, alb


def test_knull_grid_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.uniform(0.0, 1.0, (7, 5, 6))
    shapes = ((2, 2, 2), (3, 5, 4), (7, 1, 6), (1, 1, 1))
    refs = jax.jit(lambda x: [jrt.create_knull_grid(x, sh, k_ext_null_min=f)
                              for sh in shapes for f in (0.0, 0.5)])(
        jnp.asarray(k))
    got = [rt.create_knull_grid(_t(k), sh, k_ext_null_min=f)
           for sh in shapes for f in (0.0, 0.5)]
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        rt.create_knull_grid(_t(k), (8, 1, 1))


def test_samplers_match_jax():
    rng = np.random.default_rng(1)
    u = rng.random(3000)
    g = rng.uniform(-0.9, 0.95, 3000)
    g = np.where(np.abs(g) < 1e-4, 1e-4, g)
    reff = rng.uniform(1.0, 30.0, 3000)     # clipped at both table ends
    scat = rng.uniform(0.0, np.pi, 3000)
    raw = jsyn.make_mie_raw(nbnd=3)
    cdf, ang = raw["phase_cdf"], raw["phase_cdf_angle"]

    def jax_side(u, g, reff, scat, cdf, ang, p_ang, phase):
        seg = lambda x, b: x[1000 * b:1000 * (b + 1)]
        return (jrt._rayleigh_sample(u), jrt._henyey_sample(g, u),
                jnp.concatenate([jrt._mie_sample(cdf[b], ang[b], seg(u, b),
                                                 seg(reff, b))
                                 for b in range(3)]),
                jrt._mie_sample(cdf[1], ang[1], u, reff),
                jrt._mie_phase_value(p_ang, phase, scat, reff))

    ref = jax.jit(jax_side)(*map(jnp.asarray, (
        u, g, reff, scat, cdf, ang, raw["phase_angle"], raw["phase"][1])))
    got = (rt._rayleigh_sample(_t(u)), rt._henyey_sample(_t(g), _t(u)),
           # batched tables: B traces as B consecutive segments of the lanes
           rt._mie_sample(_t(cdf), _t(ang), _t(u), _t(reff)),
           rt._mie_sample(_t(cdf[1]), _t(ang[1]), _t(u), _t(reff)),
           rt._mie_phase_value(_t(raw["phase_angle"]), _t(raw["phase"][1]),
                               _t(scat), _t(reff)))
    for name, a, b in zip(("rayleigh", "henyey", "mie batched", "mie",
                           "mie phase value"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                   atol=ULP_FLOOR * np.abs(b).max(),
                                   err_msg=name)


def test_scatter_direction_matches_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(3000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:5] = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [0, -1, 0], [0.6, 0.0, -0.8]]
    cos_scat = rng.uniform(-1.0, 1.0, 3000)
    u_phi = rng.random(3000)
    ref = np.asarray(jax.jit(jrt._scatter_direction)(
        jnp.asarray(d), jnp.asarray(cos_scat), jnp.asarray(u_phi)))
    got = rt._scatter_direction(_t(d), _t(cos_scat), _t(u_phi)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=ULP_FLOOR)


def test_bundle_optical_props_and_sun_direction_match_jax():
    rng = np.random.default_rng(4)
    a = [rng.uniform(0.0, 1.0, (NZ, NY, NX)) for _ in range(8)]
    a[1] = a[1] * 0.3          # ssa_tot small: k_sca_gas clipped at 0 somewhere
    ref = jax.jit(lambda *x: jrt.bundle_optical_props(*x, 250.0))(
        *map(jnp.asarray, a))
    got = rt.bundle_optical_props(*map(_t, a), 250.0)
    assert (np.asarray(ref[1]) == 0).any()
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10,
                                   atol=ULP_FLOOR * np.abs(r).max())
    for zen, azi in ((0.0, 0.0), (0.64, 0.0), (1.2, 2.5), (0.3, -1.0)):
        np.testing.assert_allclose(rt.sun_direction_from_angles(zen, azi),
                                   jrt.sun_direction_from_angles(zen, azi),
                                   rtol=1e-12, atol=1e-15)


class _JaxStream:
    """JAX's key carried by a trace: each draw splits and draws, as the
    JAX tracer does."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def draw(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(
            k, shape, jnp.float64)))


@pytest.fixture
def jax_stream(monkeypatch):
    monkeypatch.setattr(rt, "_generator", lambda seed, device: _JaxStream(seed))
    monkeypatch.setattr(rt, "_uniform",
                        lambda s, shape, dtype, device: s.draw(shape))


def _jax_trace(fn, seed, fields, *arrays):
    """A JAX tracer call compiled as one program (op by op, its eager
    setup costs seconds of small compiles)."""
    return jax.jit(fn)(jax.random.PRNGKey(seed),
                       [jnp.asarray(f) for f in fields],
                       *map(jnp.asarray, arrays))


def _assert_replay(ref, got):
    for name in FIELDS:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.shape == b.shape, name
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-9 * scale, (name, np.abs(a - b).max(),
                                                     scale)
    assert np.abs(np.asarray(ref.flux_tod_up)).max() > 0
    assert np.abs(np.asarray(ref.flux_sfc_dif)).max() > 0


def test_truncated_replay_single_gpt_fifo(jax_stream):
    """G == 1, fifo respawn (4 photons a lane), 40 steps."""
    fields, reff, alb = _cloudy()
    kw = dict(photons_per_pixel=8, photons_per_lane=4, max_steps=40,
              respawn_mode="fifo")
    ref = _jax_trace(lambda key, f, r, a: jrt.trace_rays(
        key, *f, r, a, KN, GRID_D, 900.0, 100.0, SUN, **kw), 11, fields,
        reff, alb)
    got = rt.trace_rays(11, *map(_t, fields), _t(reff), _t(alb), KN, GRID_D,
                        900.0, 100.0, SUN, **kw)
    _assert_replay(ref, got)


def test_truncated_replay_pooled_mie(jax_stream):
    """A pooled window of two g-points with Mie cloud scattering and the
    precomputed launch pool (respawn mode "pool"), 30 steps."""
    fields, reff, alb = _cloudy(seed=5, G=2)
    raw = jsyn.make_mie_raw(nbnd=3)
    cdf, ang = raw["phase_cdf"][1], raw["phase_cdf_angle"][1]
    tod = (np.array([700.0, 300.0]), np.array([50.0, 20.0]))
    kw = dict(photons_per_pixel=4, photons_per_lane=2, max_steps=30,
              respawn_mode="pool")
    ref = _jax_trace(lambda key, f, r, a, t0, t1, c, m: jrt.trace_rays_pooled(
        key, *f, r, a, (3, 1, 2), GRID_D, t0, t1, SUN, mie_cdf=c, mie_ang=m,
        **kw), 5, fields, reff, alb, *tod, cdf, ang)
    got = rt.trace_rays_pooled(
        5, *map(_t, fields), _t(reff), _t(alb), (3, 1, 2), GRID_D,
        _t(tod[0]), _t(tod[1]), SUN, mie_cdf=_t(cdf), mie_ang=_t(ang), **kw)
    _assert_replay(ref, got)


def _trace(seed, fields, reff, alb, **kw):
    return rt.trace_rays(seed, *map(_t, fields), _t(reff), _t(alb), KN,
                         GRID_D, 900.0, 100.0, SUN, photons_per_pixel=32,
                         **kw)


def _means(out):
    return {n: float(getattr(out, n).mean()) for n in FIELDS}


def _closure(out):
    toa = float(out.flux_toa_down.mean())
    tod_up = float(out.flux_tod_up.mean())
    sfc = float((out.flux_sfc_dir + out.flux_sfc_dif - out.flux_sfc_up).mean())
    atm = float((out.flux_abs_dir + out.flux_abs_dif).mean(dim=(1, 2)).sum()
                * GRID_D[0])
    return (tod_up + sfc + atm - toa) / toa


def _within_mc(ref: dict, runs: list, n_sigma=4.0):
    """Each mean of ``ref`` within ``n_sigma`` of the Monte-Carlo error of
    one run, estimated from the spread of ``runs`` (one more sample's
    deviation from their mean: sigma * sqrt(1 + 1/n))."""
    n = len(runs)
    for name, r in ref.items():
        vals = np.array([x[name] for x in runs])
        sigma = vals.std(ddof=1) * np.sqrt(1.0 + 1.0 / n)
        assert abs(r - vals.mean()) <= n_sigma * sigma + 1e-9 * abs(r), (
            name, r, vals)


@pytest.fixture(scope="module")
def port_runs():
    fields, reff, alb = _cloudy(seed=7)
    runs = [_trace(s, fields, reff, alb) for s in range(6)]
    return fields, reff, alb, runs


def test_full_run_closes_energy_and_matches_jax_means(port_runs):
    fields, reff, alb, runs = port_runs
    for out in runs:
        np.testing.assert_allclose(out.flux_toa_down.numpy(), 1000.0,
                                   rtol=1e-12)
        assert all(bool(torch.isfinite(f).all()) for f in out)
    closure = np.mean([_closure(o) for o in runs])
    assert abs(closure) < 0.03, closure
    ref = _jax_trace(lambda key, f, r, a: jrt.trace_rays(
        key, *f, r, a, KN, GRID_D, 900.0, 100.0, SUN, photons_per_pixel=32),
        0, fields, reff, alb)
    ref_means = {n: float(np.asarray(getattr(ref, n)).mean()) for n in FIELDS
                 if n != "flux_toa_down"}
    _within_mc(ref_means, [_means(o) for o in runs])


@pytest.mark.parametrize("variant", [
    dict(compact=False), dict(respawn_mode="arith", photons_per_lane=4),
    dict(respawn_mode="pool", photons_per_lane=4),
    dict(respawn_mode="fifo", photons_per_lane=4)])
def test_loop_variants_agree_statistically(port_runs, variant):
    fields, reff, alb, runs = port_runs
    out = _trace(100, fields, reff, alb, **variant)
    means = _means(out)
    means.pop("flux_toa_down")
    _within_mc(means, [_means(o) for o in runs])
    assert abs(_closure(out)) < 0.06


def test_batched_traces_equal_separate_traces():
    """``trace_rays_batched`` (the solver's lanes mode) traces each member
    with its own stream and loop condition: equal to ``trace_rays`` of
    each up to accumulation order."""
    f1, reff, a1 = _cloudy(seed=8)
    f2, _, a2 = _cloudy(seed=9)
    raw = jsyn.make_mie_raw(nbnd=2)
    mie = [(_t(raw["phase_cdf"][b]), _t(raw["phase_cdf_angle"][b]))
           for b in range(2)]
    kw = dict(photons_per_pixel=16)
    sep = [rt.trace_rays(s, *map(_t, f), _t(reff), _t(a), KN, GRID_D, td,
                         0.0, SUN, mie_cdf=m[0], mie_ang=m[1], **kw)
           for s, f, a, td, m in ((3, f1, a1, 800.0, mie[0]),
                                  (4, f2, a2, 300.0, mie[1]))]
    bat = rt.trace_rays_batched(
        [3, 4], *(torch.stack([_t(x), _t(y)]) for x, y in zip(f1, f2)),
        _t(reff), torch.stack([_t(a1), _t(a2)]), KN, GRID_D,
        _t([800.0, 300.0]), _t([0.0, 0.0]), SUN,
        mie_cdf=torch.stack([m[0] for m in mie]),
        mie_ang=torch.stack([m[1] for m in mie]), **kw)
    for name in FIELDS:
        for b in range(2):
            ref = getattr(sep[b], name)
            np.testing.assert_allclose(getattr(bat, name)[b].numpy(),
                                       ref.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(ref.abs().max()),
                                       err_msg=f"{name}[{b}]")


def test_int32_range_guard_raises_as_jax():
    k = torch.ones((1, 1, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        rt.trace_rays(0, k, k, k, k, k, k, None, torch.ones((1, 2)),
                      (1, 1, 1), GRID_D, 1.0, 0.0, SUN,
                      photons_per_pixel=2 ** 30)
    with pytest.raises(ValueError, match="respawn_mode"):
        rt.trace_rays(0, k, k, k, k, k, k, None, torch.ones((1, 2)),
                      (1, 1, 1), GRID_D, 1.0, 0.0, SUN, photons_per_pixel=1,
                      respawn_mode="lifo")
