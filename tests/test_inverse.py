"""Closed-loop inverse rendering: parameter RECOVERY from a rendered
target (beyond gradient finiteness/FD checks, the optimizer must
actually converge to the true values).

The reference has no differentiable path at all; this is the flagship
"training" capability of this build.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rrt_tpu.scene.build import load_scene
from rrt_tpu.render import diff
from rrt_tpu.render.renderer import make_black_hole
from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu.scene.cornell import scene_path

SCENE = scene_path("cornell_lambertian")


def _rays(cam, w, h):
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    return cam.generate_rays(jnp.asarray(xy))


@pytest.mark.slow
def test_inverse_recovers_bh_radius():
    """Gradient descent on the L2 image loss recovers the Schwarzschild
    radius from a 32x32 curved full-GI target, starting 40% off."""
    W = H = 32
    cfg = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(SCENE, W, H, fov_mode="native")
    bh = make_black_hole(cfg)
    rays = _rays(cam, W, H)
    key = jax.random.key(7)

    p_true = diff.params_from_scene(scene, bh)
    render = jax.jit(
        lambda p: diff.render_radiance(p, scene, bh, rays, cfg, key))
    target = render(p_true)

    p = p_true.replace(bh_radius=jnp.asarray(0.14, jnp.float32))
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p: diff.image_loss(p, scene, bh, rays, target, cfg, key)))
    for _ in range(40):
        _, g = loss_fn(p)
        p = p.replace(bh_radius=jnp.clip(
            p.bh_radius - 2.0 * g.bh_radius, 0.01, 0.5))
    r = float(p.bh_radius)
    assert abs(r - 0.1) < 0.015, f"recovered radius {r}, true 0.1"


@pytest.mark.slow
def test_inverse_recovers_albedo():
    """Recovers the red wall's reflectance from a flat direct-lit target
    (flat spacetime: the default hole starves NEE of signal — the
    reference's own 800x600 direct render is 99% black)."""
    W = H = 48
    cfg = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                       max_ray_depth=1, seed=0, illum=1,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(SCENE, W, H, fov_mode="native")
    bh = make_black_hole(cfg)
    rays = _rays(cam, W, H)
    key = jax.random.key(7)

    p_true = diff.params_from_scene(scene, bh)
    render = jax.jit(
        lambda p: diff.render_radiance(p, scene, bh, rays, cfg, key))
    target = render(p_true)
    true_r5 = np.asarray(p_true.reflectance[5])

    p = p_true.replace(
        reflectance=p_true.reflectance.at[5].set(
            jnp.array([0.3, 0.4, 0.4], jnp.float32)))
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p: diff.image_loss(p, scene, bh, rays, target, cfg, key)))
    for _ in range(120):
        _, g = loss_fn(p)
        p = p.replace(reflectance=jnp.clip(
            p.reflectance - 60.0 * g.reflectance, 0.0, 1.0))
    got = np.asarray(p.reflectance[5])
    assert np.abs(got - true_r5).max() < 0.08, (got, true_r5)
