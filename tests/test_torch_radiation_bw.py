"""The port's camera renderer (``rte_rrtmgp_torch/models/radiation_bw.py``)
against the JAX package's, on the same NumPy inputs (a 3 x 2 column
domain, 8 layers, the lowest 4 rendered in 3D, clouds and aerosols).

* ``spectral_weights`` at ``n_sub`` 1 and 3 (toa factors, XYZ factors,
  Bodhaine cross sections) at rtol 1e-12.
* Deterministic, float64 at rtol 1e-10: every spectral step's tracer
  inputs (the six 3D fields from ``step_optics``, the background profile,
  the albedo, the Mie rows of the image layout, the sun) and the XYZ /
  radiance accumulation over windows of steps, with the tracer of both
  packages replaced by the same deterministic function of its inputs.
  The JAX solve runs op by op (``jax.disable_jit``) so its calls can be
  recorded; JAX's k-distribution interpolation is op by op anyway in
  these comparisons (compiled, XLA rounds the eta ratio differently).
* Statistical: one spectral interval rendered by JAX's compiled tracer
  and the port's in float32 at equal photons a pixel, domain means within
  4 pooled sigma.  ``spectral_mode="lanes"`` equal to the scan up to
  accumulation order (the same key a step), in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rte_rrtmgp_tpu.cases.profiles import make_atmosphere
from rte_rrtmgp_tpu.data import synthetic as jsyn
from rte_rrtmgp_tpu.models import AerosolLUT as JAerosolLUT
from rte_rrtmgp_tpu.models import CloudLUT as JCloudLUT
from rte_rrtmgp_tpu.models import KDist as JKDist
from rte_rrtmgp_tpu.models import radiation_bw as jrb
from rte_rrtmgp_tpu.models import raytracer_bw as jbw

from rte_rrtmgp_torch.models import AerosolLUT, CloudLUT, KDist
from rte_rrtmgp_torch.models import radiation_bw as rb
from rte_rrtmgp_torch.models import raytracer_bw as bw

torch.set_num_threads(2)

NY, NX, NZ, NLAY = 2, 3, 4, 8
GRID_D = (3750.0, 1000.0, 1000.0)     # the lower half of rce_grid(8)
GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]
CAM = dict(cam_type=2, nx=3, ny=2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("bw")
    raw = jsyn.make_kdist_raw(False, gpt_per_band=1)
    jsyn.write_cloud_nc(str(d / "c.nc"), jsyn.make_cloud_raw(False))
    jsyn.write_aerosol_nc(str(d / "a.nc"), jsyn.make_aerosol_raw())
    atm = make_atmosphere(NY * NX, NLAY, seed=5)
    mie = jsyn.make_mie_raw(nbnd=14, n_re=20)
    return raw, d, atm, mie


def _tables(case, port, dtype):
    raw, d, _, _ = case
    luts = (str(d / "c.nc"), str(d / "a.nc"))
    if port:
        t = torch.float64 if dtype == np.float64 else torch.float32
        return (KDist.from_raw(raw, GASES, dtype=t, device="cpu"),
                CloudLUT.from_netcdf(luts[0], dtype=t, device="cpu"),
                AerosolLUT.from_netcdf(luts[1], dtype=t, device="cpu"))
    return (JKDist.from_raw(raw, GASES, dtype=dtype),
            JCloudLUT.from_netcdf(luts[0], dtype=dtype),
            JAerosolLUT.from_netcdf(luts[1], dtype=dtype))


def _args(atm, nbnd, **kw):
    ncol = NY * NX
    args = dict(
        gas_concs=atm["gas_concs"], p_lay=atm["p_lay"], p_lev=atm["p_lev"],
        t_lay=atm["t_lay"], mu0=np.full(ncol, 0.7), azi=np.full(ncol, 0.4),
        sfc_alb=np.full((ncol, nbnd), 0.15),
        land_use_map=(np.arange(ncol) % 2).astype(float),
        grid_cells=(NZ, NY, NX), grid_d=GRID_D, kn_grid=(2, 2, 2),
        z_lev=np.asarray(atm["z_lev"]), photons_per_pixel=4)
    args.update(kw)
    return args


@pytest.mark.parametrize("n_sub", [1, 3])
def test_spectral_weights_match_jax(case, n_sub):
    kd_j = _tables(case, False, np.float64)[0]
    kd_p = _tables(case, True, np.float64)[0]
    ref = jrb.spectral_weights(kd_j, n_sub)
    got = rb.spectral_weights(kd_p, n_sub)
    assert len(got) == len(ref) == kd_p.ngpt * n_sub
    for g, r in zip(got, ref):
        assert g[:2] == r[:2]
        for a, b in zip(g[2:], r[2:]):
            np.testing.assert_allclose(a, b, rtol=1e-12)


def _fake_count(cam_nx, cam_ny, fields, bg, alb):
    """A deterministic stand-in for the tracer's count: every input moves
    it, each pixel differently."""
    pattern = 1.0 + 0.1 * np.arange(cam_ny * cam_nx).reshape(cam_ny, cam_nx)
    level = (sum(float(np.mean(np.asarray(f))) * (i + 1)
                 for i, f in enumerate(fields))
             + sum(float(np.mean(np.asarray(b))) for b in bg)
             + float(np.mean(np.asarray(alb))))
    return pattern * level


@pytest.mark.parametrize("mode", ["image_first", "broadband_mean"])
def test_step_inputs_and_accumulation_match_jax(case, mode, monkeypatch):
    """Every step's tracer inputs and the accumulated XYZ / radiance, the
    tracers replaced by :func:`_fake_count`.  ``image_first``: n_sub 2,
    image-layout Mie tables (band, sub-band rows), windows of 5 steps;
    ``broadband_mean``: broadband Mie tables, the mean background
    column, one window."""
    raw_mie = case[3]
    image = mode.startswith("image")
    n_sub = 2 if image else 1
    mie = dict(mie_cdf=raw_mie["phase_cdf"], mie_ang=raw_mie["phase_cdf_angle"],
               mie_phase=raw_mie["phase"], mie_phase_ang=raw_mie["phase_angle"])
    if image:   # (nbnd, n_sub, ...): sub-band s scaled apart
        for k in ("mie_cdf", "mie_ang", "mie_phase"):
            mie[k] = np.stack([mie[k], mie[k] * 0.97], axis=1)
    atm = case[2]
    kw = dict(lwp=atm["lwp"], iwp=np.zeros_like(atm["iwp"]), rel=atm["rel"],
              dei=atm["dei"], rh=atm["rh"], aermr=atm["aermr"],
              delta_cloud=True, delta_aerosol=True,
              mode="image" if image else "broadband", n_sub=n_sub,
              steps_per_dispatch=5 if image else None,
              bg_column="first" if image else "mean")
    rec_j, rec_p = [], []

    def jfake(key, camera, kx, ksg, ksc, ksa, gc3, ga3, kbgp, ssab, asyb,
              z_bg, alb, land, kn, grid_d, sun, mu, **kwa):
        fields = [kx, ksg, ksc, ksa, gc3, ga3]
        rec_j.append(dict(fields=fields, bg=[kbgp, ssab, asyb, z_bg], alb=alb,
                          land=land, sun=sun, mu=mu,
                          mie={k: v for k, v in kwa.items()
                               if k.startswith("mie") or k == "r_eff"}))
        c = _fake_count(camera.nx, camera.ny, fields, [kbgp, ssab], alb)
        return jnp.asarray(c), jnp.ones_like(jnp.asarray(c))

    def pfake(key, camera, kx, ksg, ksc, ksa, gc3, ga3, kbgp, ssab, asyb,
              z_bg, alb, land, kn, grid_d, sun, mu, **kwa):
        fields = [kx, ksg, ksc, ksa, gc3, ga3]
        rec_p.append(dict(fields=fields, bg=[kbgp, ssab, asyb, z_bg], alb=alb,
                          land=land, sun=sun, mu=mu,
                          mie={k: v for k, v in kwa.items()
                               if (k.startswith("mie") or k == "r_eff")
                               and v is not None}))
        c = torch.as_tensor(_fake_count(camera.nx, camera.ny, fields,
                                        [kbgp, ssab], alb))
        return (c, torch.ones_like(c)), {}

    monkeypatch.setattr(jbw, "trace_rays_bw", jfake)
    monkeypatch.setattr(bw, "trace_rays_bw", pfake)
    kd_j, cl_j, ae_j = _tables(case, False, np.float64)
    kd_p, cl_p, ae_p = _tables(case, True, np.float64)
    with jax.disable_jit():
        ref = jrb.RadiationSolverBW(kd_j, cl_j, ae_j, **mie).solve(
            camera=jbw.Camera(**CAM), dtype=np.float64,
            **_args(atm, kd_j.nbnd, **kw))
    got = rb.RadiationSolverBW(kd_p, cl_p, ae_p, **mie).solve(
        camera=bw.Camera(**CAM), dtype=torch.float64,
        **_args(atm, kd_p.nbnd, **kw))

    n_steps = kd_p.ngpt * n_sub
    assert len(rec_p) == n_steps and len(rec_j) >= n_steps   # JAX pads
    close = lambda g, r, msg: np.testing.assert_allclose(
        np.asarray(g), np.asarray(r), rtol=1e-10,
        atol=1e-12 * max(np.abs(np.asarray(r)).max(), 1e-300), err_msg=msg)
    for s, (p, j) in enumerate(zip(rec_p, rec_j)):
        for i, (a, b) in enumerate(zip(p["fields"], j["fields"])):
            close(a, b, f"step {s} field {i}")
        for i, (a, b) in enumerate(zip(p["bg"], j["bg"])):
            close(a, b, f"step {s} background {i}")
        close(p["alb"], j["alb"], f"step {s} albedo")
        close(p["land"], j["land"], f"step {s} land use")
        close(p["sun"], j["sun"], f"step {s} sun")
        close(p["mu"], j["mu"], f"step {s} mu")
        assert sorted(p["mie"]) == sorted(j["mie"]) and p["mie"], s
        for k in p["mie"]:
            close(p["mie"][k], j["mie"][k], f"step {s} {k}")
    for k in ref:
        close(got[k], ref[k], k)
        assert float(got[k].abs().max()) > 0


def test_render_matches_jax_statistically():
    """One spectral interval rendered by JAX's compiled tracer (four keys)
    and the port's (six seeds), float32, over a cloudy 4x6x6 domain with a
    background column, mixed land and water, a fisheye camera: the
    domain-mean count within 4 pooled sigma of the difference (sigma of one
    render from both spreads, 8 degrees of freedom; single renders are
    heavy-tailed: a rare specular glint scores 1 where a Lambertian event
    scores ~2e-5)."""
    rng = np.random.default_rng(12)
    sh = (4, 6, 6)
    kg = rng.uniform(2e-5, 1e-4, sh)
    cld = np.where(rng.random(sh) < 0.3, rng.uniform(5e-4, 2e-3, sh), 0.0)
    f = [kg + cld, 0.7 * kg, 0.99 * cld, np.zeros(sh),
         np.where(cld > 0, 0.85, 0.0), np.zeros(sh)]
    bg = [np.array([2e-6, 1e-6]), np.array([0.8, 0.9]),
          np.tile([1.0, 0.0, 0.0], (2, 1)), np.array([2000.0, 4000.0, 9000.0])]
    sfc = [np.full((6, 6), 0.2), (rng.random((6, 6)) < 0.5).astype(float)]
    sun = np.array([0.5, 0.3, np.sqrt(1 - 0.34)])
    kw = dict(photons_per_pixel=8)
    cam = bw.Camera(cam_type=0, nx=6, ny=5, fov=170.0, pitch_deg=-40.0,
                    position=(1500.0, 1500.0, 300.0))
    grid = ((2, 2, 2), (500.0, 500.0, 500.0))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    jfn = jax.jit(lambda key, f, b, s: jbw.trace_rays_bw(
        key, jbw.Camera(**{k: getattr(cam, k) for k in (
            "position", "cam_type", "yaw_deg", "pitch_deg", "roll_deg",
            "f_zoom", "fov", "nx", "ny")}), *f, *b, *s, *grid, f32(sun),
        float(sun[2]), **kw)[0])
    jargs = ([f32(a) for a in f], [f32(a) for a in bg], [f32(a) for a in sfc])
    jm = [float(np.asarray(jfn(jax.random.PRNGKey(k), *jargs),
                           np.float64).mean()) for k in range(4)]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    pm = []
    for seed in range(6):
        c, _ = bw.trace_rays_bw(bw._key(seed), cam, *map(t, f), *map(t, bg),
                                *map(t, sfc), *grid, sun, float(sun[2]), **kw)
        assert bool(torch.isfinite(c).all())
        pm.append(float(c.double().mean()))
    jm, pm = np.array(jm), np.array(pm)
    pooled = np.sqrt(((len(jm) - 1) * jm.var(ddof=1)
                      + (len(pm) - 1) * pm.var(ddof=1)) / (len(jm) + len(pm) - 2))
    tol = 4 * pooled * np.sqrt(1.0 / len(jm) + 1.0 / len(pm))
    assert pm.mean() > 0 and abs(jm.mean() - pm.mean()) <= tol, (jm, pm)


def test_lanes_equal_scan(case):
    """The same key a step in both modes: equal up to accumulation order.
    In float64: in float32 a ray's surface test (rounding noise against
    eps) can flip between the two, whose array sizes take PyTorch's vector
    and scalar math paths differently."""
    atm = case[2]
    kd = _tables(case, True, np.float64)[0]
    solver = rb.RadiationSolverBW(kd)
    out = {m: solver.solve(camera=bw.Camera(**CAM), seed=3, spectral_mode=m,
                           mode="broadband", steps_per_dispatch=5,
                           dtype=torch.float64,
                           **_args(atm, kd.nbnd, photons_per_pixel=1))["radiance"]
           for m in ("scan", "lanes")}
    assert float(out["scan"].max()) > 0
    np.testing.assert_allclose(out["lanes"].numpy(), out["scan"].numpy(),
                               rtol=1e-12, atol=1e-12 * float(out["scan"].max()))


def test_solver_rejects_a_domain_without_background(case):
    kd = _tables(case, True, np.float64)[0]
    atm = case[2]
    with pytest.raises(ValueError, match="background layer"):
        rb.RadiationSolverBW(kd).solve(
            camera=bw.Camera(**CAM),
            **_args(atm, kd.nbnd, grid_cells=(NLAY, NY, NX)))
