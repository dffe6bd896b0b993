"""Differentiable rendering: gradients vs finite differences.

Acceptance: `allclose` of autodiff pixel gradients against
finite differences for albedo, emission, and black-hole radius (mass
analog). Visibility gradients are out of scope (SURVEY §7)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rrt_tpu.render import diff
from rrt_tpu.render.renderer import make_black_hole
from rrt_tpu.scene.build import load_scene
from rrt_tpu.types import Rays
from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu.scene.cornell import scene_path



def _setup(curved, md=2, n=24):
    cfg = RenderConfig(
        width=64, height=64, ns_aa=1, ns_area_light=2, max_ray_depth=md,
        seed=0, differentiable=True,
        black_hole=BlackHoleConfig(enabled=curved))
    scene, cam = load_scene(scene_path("cornell_lambertian"),
                            64, 64, fov_mode="native")
    bh = make_black_hole(cfg)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0.2, 0.8, (n, 2)).astype(np.float32)
    rays = cam.generate_rays(jnp.asarray(xy))
    params = diff.params_from_scene(scene, bh)
    return scene, bh, cfg, rays, params


def _mean_radiance_fn(scene, bh, cfg, rays):
    def f(params):
        img = diff.render_radiance(
            params, scene, bh, rays, cfg, jax.random.key(1))
        return jnp.mean(img)
    return f


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_grad_albedo_matches_fd(curved):
    scene, bh, cfg, rays, params = _setup(curved)
    f = _mean_radiance_fn(scene, bh, cfg, rays)
    g = jax.grad(lambda p: f(p))(params)
    g_alb = np.asarray(g.reflectance)
    assert np.isfinite(g_alb).all()
    assert np.abs(g_alb).max() > 0  # light reaches some diffuse surface

    # FD check on the most influential albedo entry
    i, c = np.unravel_index(np.abs(g_alb).argmax(), g_alb.shape)
    eps = 3e-3
    def perturbed(sign):
        refl = params.reflectance.at[i, c].add(sign * eps)
        return f(params.replace(reflectance=refl))
    fd = (float(perturbed(+1)) - float(perturbed(-1))) / (2 * eps)
    np.testing.assert_allclose(g_alb[i, c], fd, rtol=5e-2, atol=1e-5)


def test_grad_emission_matches_fd():
    scene, bh, cfg, rays, params = _setup(curved=False)
    # the generated box has no emissive surface: make the green wall one
    from rrt_tpu.types import BSDF_EMISSION
    b = scene.bsdfs
    wall = int(np.argmin(np.abs(np.asarray(b.reflectance)
                                - [0.14, 0.45, 0.091]).sum(-1)))
    scene = scene.replace(bsdfs=b.replace(
        kind=b.kind.at[wall].set(BSDF_EMISSION),
        emission=b.emission.at[wall].set(2.0)))
    params = diff.params_from_scene(scene, bh)
    # hemisphere direct sampling accumulates emission of whatever is hit
    # (part1_code.cpp:15-31), giving emission parameters gradient support
    # from every diffuse vertex
    cfg = cfg.replace(direct_hemisphere_sample=True, ns_area_light=16)
    f = _mean_radiance_fn(scene, bh, cfg, rays)
    g = jax.grad(f)(params)
    g_em = np.asarray(g.emission)
    assert np.isfinite(g_em).all()
    i, c = np.unravel_index(np.abs(g_em).argmax(), g_em.shape)
    assert np.abs(g_em[i, c]) > 0
    eps = 1e-2
    def perturbed(sign):
        em = params.emission.at[i, c].add(sign * eps)
        return f(params.replace(emission=em))
    fd = (float(perturbed(+1)) - float(perturbed(-1))) / (2 * eps)
    np.testing.assert_allclose(g_em[i, c], fd, rtol=5e-2, atol=1e-6)


def test_grad_bh_radius_finite_and_fd():
    """d(radiance)/d(Schwarzschild radius) through the geodesic scan."""
    scene, bh, cfg, rays, params = _setup(curved=True, md=1)
    f = _mean_radiance_fn(scene, bh, cfg, rays)
    g = jax.grad(f)(params)
    g_r = float(g.bh_radius)
    assert np.isfinite(g_r)
    # FD with a larger step (f32 renderer; radiance is piecewise-smooth in
    # r away from visibility events, but chord geometry shifts hit points)
    eps = 2e-3
    fd = (float(f(params.replace(bh_radius=params.bh_radius + eps)))
          - float(f(params.replace(bh_radius=params.bh_radius - eps)))) / (2 * eps)
    # sign + rough magnitude agreement (visibility discontinuities allow
    # only loose tolerance here)
    if abs(fd) > 1e-4 or abs(g_r) > 1e-4:
        assert np.sign(fd) == np.sign(g_r) or abs(fd - g_r) < 0.5 * max(
            abs(fd), abs(g_r)), (g_r, fd)


def test_train_step_reduces_loss():
    scene, bh, cfg, rays, params = _setup(curved=False, md=1)
    target = jnp.full((rays.o.shape[0], 3), 0.3, jnp.float32)
    key = jax.random.key(0)
    loss0 = float(diff.image_loss(params, scene, bh, rays, target, cfg, key))
    p = params
    for i in range(5):
        p, _, loss = diff.train_step(
            p, None, scene, bh, rays, target, cfg, key, lr=0.5)
    assert float(loss) < loss0


def test_trace_diff_matches_primal():
    """trace_diff's reconstructed payload must equal the plain trace
    output bitwise-closely (same discrete winners, re-derived t/p/n)."""
    from rrt_tpu.geometry import trace as T
    scene, bh, cfg, rays, params = _setup(curved=True, n=400)
    hd = T.trace_diff(scene, bh, rays, n_seg=63, backend="xla")
    hx = T.trace(scene, bh, rays, n_seg=63, backend="xla")
    assert (np.asarray(hd.hit) == np.asarray(hx.hit)).all()
    m = np.asarray(hd.hit)
    assert (np.asarray(hd.prim_id)[m] == np.asarray(hx.prim_id)[m]).all()
    # geodesics that wrap through the hole are chaotic: the replayed march
    # (a separately compiled scan) may round a handful of lanes onto
    # different trajectories — require near-total agreement
    close = np.abs(np.asarray(hd.p)[m] - np.asarray(hx.p)[m]).max(-1) < 1e-4
    assert close.mean() > 0.995, close.mean()


def test_image_scale_grads_finite():
    """Full-image depth-5 GI gradient: every parameter leaf finite (NaNs
    used to appear beyond toy batches — grazing sphere hits, the TIR
    boundary, zero-area light denominators)."""
    cfg = RenderConfig(
        width=48, height=48, ns_aa=1, ns_area_light=1, max_ray_depth=5,
        seed=0, differentiable=True, black_hole=BlackHoleConfig(enabled=True))
    scene, cam = load_scene(scene_path("cornell_lambertian"), 48, 48)
    bh = make_black_hole(cfg)
    n = 48 * 48
    xs = (jnp.arange(n) % 48 + 0.5) / 48
    ys = (jnp.arange(n) // 48 + 0.5) / 48
    rays = cam.generate_rays(jnp.stack([xs, ys], axis=-1))
    params = diff.params_from_scene(scene, bh)
    target = jnp.zeros((n, 3))
    g = jax.grad(lambda p: diff.image_loss(
        p, scene, bh, rays, target, cfg, jax.random.key(0)))(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert bool(jnp.isfinite(leaf).all()), "non-finite parameter grad"
