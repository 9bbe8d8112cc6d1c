"""The port's backward (camera) tracer (``rte_rrtmgp_torch/models/
raytracer_bw.py``) against the JAX package's, on the same NumPy inputs.

* Deterministic pieces in float64 at rtol 1e-10 (absolute floor 1e-12 of
  each array's largest value): ``Camera.rotation`` / ``rect_basis``, the
  camera rays of each camera type on the same uniforms, the phase
  functions, ``count_to_radiance``, ``accumulate_clouds`` on the three
  cases of ``tests/test_cloud_cam.py``, and the field NEE's ``tau_lev``
  where it has a closed form (drift of whole cells a layer).
* Truncated replay in float64: JAX renders a tiny cloudy domain for 30-40
  steps; the port renders the same case with its stream functions
  (``_split``, ``_fold_in``, ``_uniform``) replaced by JAX's threefry, and
  every pixel's count lies within 1e-9 of the largest of JAX's.  Cases:
  pool respawn with 2 rays a lane and walk NEE (fisheye camera), fifo with
  walk NEE (TOA camera), and Mie sampling with the Mie phase value under
  the field NEE (a camera aimed at the sun, so every launch sees it).
  The domain's lowest layer is opaque (tau 50): the reference's surface
  test compares a crossing's rounding noise with eps (``pos_cross z <
  eps``), so a ray that reaches the ground takes its surface event a step
  earlier or later under another rounding (compiled XLA's fused products
  and its own transcendentals against PyTorch's), which no long replay can
  match.
* Truncated replay over the ground, against JAX run op by op
  (``jax.disable_jit``): without the opaque layer, a TOA camera over mixed
  land (Lambertian) and water (specular) for 10 steps, and a camera aimed
  at the sun's mirror image over water, whose glints score, for 3 steps
  (the first ground hit; at the 4th, compiled and op-by-op JAX already
  differ from each other).
* Statistical: the vacuum Lambertian limit, an absorbing layer's
  attenuation, fifo against pool, field against walk NEE, and a batched
  render (the solver's ``lanes`` mode) equal to separate renders up to
  accumulation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models import raytracer_bw as jbw

from rte_rrtmgp_torch.models import raytracer_bw as bw

torch.set_num_threads(2)

ULP_FLOOR = 1e-12
NZ, NY, NX = 5, 3, 4
GRID_D = (400.0, 500.0, 450.0)
KN = (NZ, 3, 2)
MU0 = 0.7
SUN = np.array([np.sqrt(1 - MU0 ** 2) * 0.8, np.sqrt(1 - MU0 ** 2) * 0.6, MU0])
CAM_FIELDS = ("position", "cam_type", "yaw_deg", "pitch_deg", "roll_deg",
              "f_zoom", "fov", "nx", "ny")


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jcam(cam):
    return jbw.Camera(**{k: getattr(cam, k) for k in CAM_FIELDS})


def _close(got, ref, rtol=1e-10, msg=""):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=ULP_FLOOR * max(np.abs(ref).max(), 1e-300),
                               err_msg=msg)


CAMERAS = [
    bw.Camera(cam_type=0, nx=5, ny=4, fov=160.0, pitch_deg=-30.0, yaw_deg=20.0,
              position=(900.0, 700.0, 650.0)),
    bw.Camera(cam_type=1, nx=6, ny=3, fov=70.0, pitch_deg=-15.0, roll_deg=5.0,
              yaw_deg=-40.0, position=(100.0, 2000.0, 4500.0)),
    bw.Camera(cam_type=1, nx=3, ny=7, fov=40.0, pitch_deg=-90.0,
              position=(1000.0, 1000.0, 10.0)),
    bw.Camera(cam_type=2, nx=4, ny=3),
]


def test_camera_geometry_matches_jax():
    for cam in CAMERAS:
        jc = _jcam(cam)
        for g, r in zip(cam.rotation(), jc.rotation()):
            np.testing.assert_array_equal(g, r)
        for g, r in zip(cam.rect_basis(), jc.rect_basis()):
            np.testing.assert_array_equal(g, r)
        assert cam.npix == jc.npix


@pytest.mark.parametrize("cam", CAMERAS, ids=lambda c: f"type{c.cam_type}")
def test_camera_rays_match_jax(cam):
    rng = np.random.default_rng(1)
    n = cam.npix * 3
    pix = np.arange(n) % cam.npix
    u1, u2 = rng.random(n), rng.random(n)
    size, z_top = (1800.0, 1500.0, 2000.0), 4000.0
    ref = jbw._camera_rays_for(_jcam(cam), jnp.asarray(pix), jnp.asarray(u1),
                               jnp.asarray(u2), size, z_top, jnp.float64)
    got = bw._camera_rays_for(cam, torch.as_tensor(pix), _t(u1), _t(u2),
                              size, z_top, torch.float64)
    for g, r, name in zip(got, ref, ("pos", "dir")):
        _close(g, r, msg=name)
    np.testing.assert_allclose(torch.linalg.norm(got[1], dim=1).numpy(), 1.0,
                               rtol=1e-12)


def test_phase_functions_and_radiance_match_jax():
    rng = np.random.default_rng(2)
    cos_a = rng.uniform(-1.0, 1.0, 2000)
    g = rng.uniform(-0.9, 0.99, 2000)
    _close(bw.rayleigh_phase(_t(cos_a)), jbw.rayleigh_phase(jnp.asarray(cos_a)))
    _close(bw.henyey_phase(_t(g), _t(cos_a)),
           jax.jit(jbw.henyey_phase)(jnp.asarray(g), jnp.asarray(cos_a)))
    assert bw.lambertian_phase() == jbw.lambertian_phase()
    assert (bw.COS_HALF_ANGLE, bw.SUN_SOLID_ANGLE) == (jbw.COS_HALF_ANGLE,
                                                       jbw.SUN_SOLID_ANGLE)
    count = rng.random((3, 4))
    _close(bw.count_to_radiance(_t(count), 1361.0, 0.03, 16),
           jbw.count_to_radiance(jnp.asarray(count), 1361.0, 0.03, 16))


def _cloud_fields(cloud_k, nz=8, ny=4, nx=4):
    lwp, iwp, tau = (np.zeros((nz, ny, nx)) for _ in range(3))
    if cloud_k is not None:
        lwp[cloud_k], iwp[cloud_k], tau[cloud_k] = 10.0, 5.0, 2.0
        lwp[cloud_k - 1, 1:3, 2] = 3.0
        tau[cloud_k - 1, 1:3, 2] = 0.5
    return lwp, iwp, tau


@pytest.mark.parametrize("case", ["nadir", "clear", "fisheye_inside"])
def test_accumulate_clouds_matches_jax(case):
    """The three cases of tests/test_cloud_cam.py (8x4x4 cells of
    250x500x500 m), in float64."""
    grid_d, cells = (250.0, 500.0, 500.0), (8, 4, 4)
    cam, k = {
        "nadir": (bw.Camera(position=(0, 0, 0), cam_type=2, nx=4, ny=4), 3),
        "clear": (bw.Camera(position=(0, 0, 0), cam_type=2, nx=4, ny=4), None),
        "fisheye_inside": (bw.Camera(position=(1000.0, 1000.0, 125.0),
                                     cam_type=0, fov=180.0, nx=8, ny=8), 6),
    }[case]
    fields = _cloud_fields(k)
    ref = jax.jit(lambda l, i, t: jbw.accumulate_clouds(
        _jcam(cam), grid_d, cells, l, i, t, dtype=jnp.float64))(
            *map(jnp.asarray, fields))
    got = bw.accumulate_clouds(cam, grid_d, cells, *map(_t, fields))
    for g, r, name in zip(got, ref, ("liwp", "tauc", "dist", "zen")):
        _close(g, r, msg=name)
    if case == "clear":
        assert (got[2] == -1.0).all()
    else:
        assert float(got[0].max()) > 0


def test_tau_levels_closed_form():
    """tau_lev[k] = sum of k_ext over the layers above k along the sun ray,
    each layer sampled at its mid-height: with a vertical sun, the column
    sums; with a drift of two whole cells in x a layer, the sums along the
    diagonal (whole-cell offsets, no interpolation)."""
    rng = np.random.default_rng(3)
    k = rng.uniform(0.0, 1e-3, (5, 3, 7))
    dz, dy, dx = 400.0, 500.0, 200.0
    tau = bw.sun_tau_levels(_t(k), np.array([0.0, 0.0, 1.0]), (dz, dy, dx))
    ref = np.concatenate([np.cumsum(k[::-1], axis=0)[::-1] * dz,
                          np.zeros((1, 3, 7))])
    np.testing.assert_allclose(tau.numpy(), ref, rtol=1e-12)
    s = np.array([1.0, 0.0, 1.0]) / np.sqrt(2.0)     # drift dz/dx = 2 cells
    tau = bw.sun_tau_levels(_t(k), s, (dz, dy, dx)).numpy()
    path = dz * np.sqrt(2.0)
    for lev in range(5):
        want = sum(np.roll(k[j], -(2 * (j - lev) + 1), axis=1)
                   for j in range(lev, 5))
        np.testing.assert_allclose(tau[lev], want * path, rtol=1e-12)


# ---------------------------------------------------------------------------
# Truncated replay against JAX's threefry stream


@pytest.fixture
def jax_stream(monkeypatch):
    monkeypatch.setattr(bw, "_split", lambda key, n=2: list(
        jax.random.split(key, n)))
    monkeypatch.setattr(bw, "_fold_in", jax.random.fold_in)
    monkeypatch.setattr(bw, "_uniform", lambda key, shape, dtype, device:
                        torch.from_numpy(np.array(jax.random.uniform(
                            key, shape, jnp.float64))))


def _domain(seed=3, opaque=True, land=None):
    """A tiny heterogeneous domain (gas, broken cloud, aerosol) above an
    opaque absorbing lowest layer (or none), a 3-layer background column,
    mixed land and water (or everywhere ``land``: 1 land, 0 water)."""
    rng = np.random.default_rng(seed)
    sh = (NZ, NY, NX)
    kg = rng.uniform(1e-5, 1e-4, sh)
    cld = np.where(rng.random(sh) < 0.4, rng.uniform(1e-3, 5e-3, sh), 0.0)
    ka = rng.uniform(0.0, 2e-5, sh)
    k_opaque = np.zeros(sh)
    k_opaque[0] = 50.0 / GRID_D[0] if opaque else 0.0
    fields = [kg + cld + ka + k_opaque, 0.5 * kg, 0.99 * cld, 0.8 * ka,
              np.where(cld > 0, 0.85, 0.0), np.full(sh, 0.7)]
    kbg = 3
    bg = [rng.uniform(1e-6, 1e-5, kbg), rng.uniform(0.3, 0.9, kbg),
          np.tile([1.0, 0.0, 0.0], (kbg, 1)),
          NZ * GRID_D[0] + np.arange(kbg + 1) * 1000.0]
    sfc = [rng.uniform(0.05, 0.3, (NY, NX)),
           (rng.random((NY, NX)) < 0.5).astype(float)]
    if land is not None:
        sfc[1] = np.full((NY, NX), float(land))
    return fields, bg, sfc, rng.uniform(3.0, 15.0, sh)


def _replay(cam, kn, seed, kw, mie=None, eager=False, **domain):
    """JAX's render (compiled, or op by op if ``eager``) against the
    port's with JAX's stream; returns JAX's counts and the port's aux."""
    fields, bg, sfc, reff = _domain(**domain)
    mie_kw, jmie = {}, {}
    if mie is not None:
        mie_kw = dict(r_eff=_t(reff), **{k: _t(v) for k, v in mie.items()})
        jmie = dict(r_eff=jnp.asarray(reff),
                    **{k: jnp.asarray(v) for k, v in mie.items()})
    render = lambda key, f, b, s, m: jbw.trace_rays_bw(
        key, _jcam(cam), *f, *b, *s, kn, GRID_D, jnp.asarray(SUN), MU0,
        **m, **kw)
    args = (jax.random.PRNGKey(seed), [jnp.asarray(a) for a in fields],
            [jnp.asarray(a) for a in bg], [jnp.asarray(a) for a in sfc], jmie)
    if eager:
        with jax.disable_jit():
            ref = render(*args)
    else:
        ref = jax.jit(render)(*args)
    (got, shot), aux = bw.trace_rays_bw(
        jax.random.PRNGKey(seed), cam, *map(_t, fields), *map(_t, bg),
        *map(_t, sfc), kn, GRID_D, SUN, MU0, return_aux=True, **mie_kw, **kw)
    a = np.asarray(ref[0])
    assert a.shape == tuple(got.shape) == (cam.ny, cam.nx)
    np.testing.assert_array_equal(shot.numpy(), np.asarray(ref[1]))
    assert np.abs(a).max() > 0
    assert np.abs(a - got.numpy()).max() <= 1e-9 * np.abs(a).max(), (
        np.abs(a - got.numpy()).max(), np.abs(a).max())
    return a, aux


def test_truncated_replay_pool_walk(jax_stream):
    """Pool respawn, 2 rays a lane (respawn fires), walk NEE, fisheye."""
    _, aux = _replay(CAMERAS[0], KN, 5, dict(
        photons_per_pixel=8, rays_per_lane=2, max_steps=40,
        respawn_mode="pool", nee_mode="walk"))
    assert aux["steps"] == 40 and aux["sub_steps"] > 0


def test_truncated_replay_fifo_walk(jax_stream):
    """Fifo respawn (the global ray queue), walk NEE, TOA camera."""
    _, aux = _replay(CAMERAS[3], KN, 7, dict(
        photons_per_pixel=8, rays_per_lane=2, max_steps=40,
        respawn_mode="fifo", nee_mode="walk"))
    assert aux["steps"] == 40 and aux["sub_steps"] > 0


def test_truncated_replay_mie_field(jax_stream):
    """Mie sampling and the Mie phase value, field NEE; the rectangular
    camera looks at the sun, so the launch pre-pass scores every ray."""
    raw = jsyn.make_mie_raw(nbnd=2, n_re=20)
    mie = dict(mie_cdf=raw["phase_cdf"][1], mie_ang=raw["phase_cdf_angle"][1],
               mie_phase=raw["phase"][1], mie_phase_ang=raw["phase_angle"])
    cam = bw.Camera(cam_type=1, nx=4, ny=3, fov=0.2,
                    yaw_deg=float(np.degrees(np.arctan2(SUN[1], SUN[0]))),
                    pitch_deg=-float(np.degrees(np.arcsin(SUN[2]))),
                    position=(900.0, 700.0, 650.0))
    _replay(cam, (2, 3, 2), 9, dict(
        photons_per_pixel=6, rays_per_lane=2, max_steps=30,
        respawn_mode="pool", nee_mode="field"), mie=mie)


GLINT_CAM = bw.Camera(cam_type=1, nx=4, ny=3, fov=0.3,
                      yaw_deg=float(np.degrees(np.arctan2(SUN[1], SUN[0]))),
                      pitch_deg=float(np.degrees(np.arcsin(SUN[2]))),
                      position=(900.0, 700.0, 650.0))


@pytest.mark.parametrize("case", ["lambertian_specular", "glint"])
def test_truncated_replay_over_ground_eager(jax_stream, case):
    """Rays that reach the surface, against JAX run op by op: a TOA camera
    over mixed land and water for 10 steps (Lambertian bounces, specular
    reflections of direct rays), and a camera looking down at the sun's
    mirror image over water for 3 steps, where the specular NEE scores
    glints (each ~1e4 times a Lambertian event)."""
    kw = dict(photons_per_pixel=8, rays_per_lane=2, nee_mode="walk")
    if case == "glint":
        a, aux = _replay(GLINT_CAM, KN, 5, dict(kw, max_steps=3,
                                                respawn_mode="pool"),
                         eager=True, opaque=False, land=0)
        assert a.max() > 1e-2
    else:
        a, aux = _replay(CAMERAS[3], KN, 7, dict(kw, max_steps=10,
                                                 respawn_mode="fifo"),
                         eager=True, opaque=False)
        assert 0 < a.max() < 1e-4
    assert aux["sub_steps"] > 0


# ---------------------------------------------------------------------------
# Statistical checks (the port alone)

SZ, SY, SX = 4, 8, 8
SD = 500.0


def _simple(seed, k_ext, ksg, albedo=0.2, ppp=64, cam=None, dtype=torch.float32,
            **kw):
    """A homogeneous domain under a near-vacuum background
    (tests/test_raytracer_bw.py's setup)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    zeros = torch.zeros((SZ, SY, SX), dtype=dtype)
    cam = cam or bw.Camera(cam_type=2, nx=SX, ny=SY)
    sun = np.array([np.sqrt(1 - 0.8 ** 2), 0.0, 0.8])
    (count, shot), aux = bw.trace_rays_bw(
        bw._key(seed), cam, t(k_ext), t(ksg), zeros, zeros, zeros, zeros,
        torch.full((2,), 1e-9, dtype=dtype), torch.zeros(2, dtype=dtype),
        torch.zeros((2, 3), dtype=dtype),
        t([SZ * SD, SZ * SD + 1000.0, SZ * SD + 2000.0]),
        torch.full((SY, SX), albedo, dtype=dtype),
        torch.ones((SY, SX), dtype=dtype), (2, 2, 2), (SD, SD, SD), sun, 0.8,
        photons_per_pixel=ppp, return_aux=True, **kw)
    return float(count.double().sum() / shot.double().sum()), aux


def test_vacuum_lambertian_and_absorbing_layer():
    """No atmosphere, Lambertian albedo 0.2: the TOA nadir estimator per
    photon equals albedo * SUN_SOLID_ANGLE / pi (5%); an absorbing layer
    of tau 0.4 attenuates it by exp(-tau (1/mu0 + 1)) (10%)."""
    sh = (SZ, SY, SX)
    vac, aux = _simple(0, np.full(sh, 1e-9), np.zeros(sh))
    expect = 0.2 * bw.SUN_SOLID_ANGLE / np.pi
    assert abs(vac - expect) / expect < 0.05, (vac, expect)
    assert aux["sub_steps"] > 0
    ab, _ = _simple(1, np.full(sh, 2.0e-4), np.zeros(sh))
    tau = 2.0e-4 * SZ * SD
    want = np.exp(-tau / 0.8 - tau)
    assert abs(ab / vac - want) / want < 0.1, (ab / vac, want)


def test_fifo_matches_pool_and_field_matches_walk():
    """Same physics through different ray-to-lane assignments (4 rays a
    lane: respawn fires) and through the two NEE estimators, on a smooth
    scattering domain: domain means within 5% and 8%."""
    sh = (SZ, SY, SX)
    z = np.add.outer(np.arange(SZ) * 0.7, np.add.outer(np.arange(SY) * 0.5,
                                                       np.arange(SX) * 0.9))
    k_ext = 2e-4 + 0.4e-3 * (1.0 + np.sin(z))
    ksg = 0.9 * k_ext
    cam = bw.Camera(cam_type=2, nx=16, ny=16)
    means = {}
    for name, kw in (("pool", dict(respawn_mode="pool")),
                     ("fifo", dict(respawn_mode="fifo")),
                     ("field", dict(respawn_mode="pool", nee_mode="field"))):
        means[name], aux = _simple(11, k_ext, ksg, albedo=0.3, ppp=64,
                                   cam=cam, rays_per_lane=4, **kw)
        assert aux["rpl"] == 4 and np.isfinite(means[name])
    assert abs(means["fifo"] / means["pool"] - 1) < 0.05, means
    assert abs(means["field"] / means["pool"] - 1) < 0.08, means


def test_batched_renders_equal_separate_renders():
    """``trace_rays_bw_batched`` (the solver's lanes mode) renders each
    member with its own keys and loop condition: equal to
    ``trace_rays_bw`` of each up to accumulation order."""
    f1, bg1, sfc1, reff = _domain(seed=8)
    f2, bg2, sfc2, _ = _domain(seed=9)
    raw = jsyn.make_mie_raw(nbnd=2, n_re=20)
    mies = [dict(mie_cdf=_t(raw["phase_cdf"][b]),
                 mie_ang=_t(raw["phase_cdf_angle"][b]),
                 mie_phase=_t(raw["phase"][b])) for b in range(2)]
    common = dict(photons_per_pixel=8, r_eff=_t(reff),
                  mie_phase_ang=_t(raw["phase_angle"]), respawn_mode="fifo",
                  rays_per_lane=2)
    cam = CAMERAS[0]
    sep = [bw.trace_rays_bw(key, cam, *map(_t, f), *map(_t, bg[:3]), _t(bg[3]),
                            _t(sfc[0]), _t(sfc[1]), KN, GRID_D, SUN, MU0,
                            **m, **common)[0]
           for key, f, bg, sfc, m in ((21, f1, bg1, sfc1, mies[0]),
                                      (22, f2, bg2, sfc2, mies[1]))]
    st = lambda a, b: torch.stack([_t(a), _t(b)])
    bat, shot = bw.trace_rays_bw_batched(
        [21, 22], cam, *(st(a, b) for a, b in zip(f1, f2)),
        *(st(a, b) for a, b in zip(bg1[:3], bg2[:3])), _t(bg1[3]),
        st(sfc1[0], sfc2[0]), _t(sfc1[1]), KN, GRID_D, SUN, MU0,
        **{k: torch.stack([m[k] for m in mies]) for k in mies[0]}, **common)
    for b in range(2):
        ref = sep[b].numpy()
        assert ref.max() > 0
        np.testing.assert_allclose(bat[b].numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * ref.max(), err_msg=str(b))


def test_unknown_modes_raise():
    k = torch.ones((1, 1, 2), dtype=torch.float64)
    args = (0, bw.Camera(cam_type=2, nx=2, ny=1), k, k, k, k, k, k,
            torch.ones(1), torch.zeros(1), torch.zeros((1, 3)),
            torch.tensor([1.0, 2.0]), torch.ones((1, 2)), torch.ones((1, 2)),
            (1, 1, 1), (1.0, 1.0, 1.0), SUN, MU0)
    with pytest.raises(ValueError, match="respawn_mode"):
        bw.trace_rays_bw(*args, photons_per_pixel=1, respawn_mode="lifo")
    with pytest.raises(ValueError, match="nee_mode"):
        bw.trace_rays_bw(*args, photons_per_pixel=1, nee_mode="cone")


def test_auto_respawn_resolution(monkeypatch):
    """``respawn_mode="auto"``: RTE_RRTMGP_BW_RESPAWN, else the tuned
    ``bw_render`` winner for the device's kind (none for the CPU), else
    pool (the JAX package's order)."""
    monkeypatch.setenv("RTE_RRTMGP_BW_RESPAWN", "fifo")
    assert bw._resolve_respawn_mode("auto", "cpu") == "fifo"
    monkeypatch.delenv("RTE_RRTMGP_BW_RESPAWN")
    assert bw._resolve_respawn_mode("auto", "cpu") == "pool"
    assert bw._resolve_respawn_mode("fifo", "cpu") == "fifo"
    sh = (SZ, SY, SX)
    _, aux = _simple(0, np.full(sh, 1e-9), np.zeros(sh), ppp=2)
    assert aux["respawn_mode"] == "pool"
