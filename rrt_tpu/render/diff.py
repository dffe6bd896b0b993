"""Differentiable rendering: gradients of radiance w.r.t. scene and metric
parameters — a new capability over the reference (which has no autodiff).

`SceneParams` collects the differentiable leaves: BSDF reflectance/
transmittance/emission/eta/k/alpha/ior, light radiance, and black-hole
(position, radius = Schwarzschild mass analog, Δθ). `render_radiance`
rebinds them into the scene pytree and runs the wavefront integrator in
differentiable mode (full-depth scans instead of early-exit while loops).

Discrete structure (hit selection, RR coins, CDF inversion, visibility)
contributes no gradient by construction; gradients flow through the
continuous factors: BSDF values, light radiance, geodesic chords.
Visibility gradients are explicitly out of scope (SURVEY §7 hard parts).

`train_step` is the flagship "training" loop — inverse rendering: L2 image
loss against a target, gradient over the parameter pytree; under a sharded
lane axis GSPMD all-reduces the parameter gradients automatically.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from rrt_tpu.render.integrator import est_radiance
from rrt_tpu.types import BlackHoleParams, Rays, SceneData, pytree_dataclass
from rrt_tpu.utils.config import RenderConfig


@pytree_dataclass
class SceneParams:
    """Differentiable parameter pytree."""

    reflectance: jnp.ndarray    # (B, 3)
    transmittance: jnp.ndarray  # (B, 3)
    emission: jnp.ndarray       # (B, 3)
    eta: jnp.ndarray            # (B, 3)
    k: jnp.ndarray              # (B, 3)
    alpha: jnp.ndarray          # (B,)
    ior: jnp.ndarray            # (B,)
    light_radiance: jnp.ndarray  # (L, 3)
    bh_position: jnp.ndarray    # (3,)
    bh_radius: jnp.ndarray      # () Schwarzschild radius (mass analog)
    bh_delta_theta: jnp.ndarray  # ()


def params_from_scene(scene: SceneData,
                      bh: Optional[BlackHoleParams]) -> SceneParams:
    b = scene.bsdfs
    return SceneParams(
        reflectance=b.reflectance,
        transmittance=b.transmittance,
        emission=b.emission,
        eta=b.eta,
        k=b.k,
        alpha=b.alpha,
        ior=b.ior,
        light_radiance=scene.lights.radiance,
        bh_position=(bh.position if bh is not None
                     else jnp.zeros(3, jnp.float32)),
        bh_radius=(bh.radius if bh is not None
                   else jnp.zeros((), jnp.float32)),
        bh_delta_theta=(bh.delta_theta if bh is not None
                        else jnp.asarray(0.1, jnp.float32)),
    )


def bind_params(scene: SceneData, bh: Optional[BlackHoleParams],
                p: SceneParams) -> Tuple[SceneData, Optional[BlackHoleParams]]:
    scene2 = scene.replace(
        bsdfs=scene.bsdfs.replace(
            reflectance=p.reflectance,
            transmittance=p.transmittance,
            emission=p.emission,
            eta=p.eta,
            k=p.k,
            alpha=p.alpha,
            ior=p.ior,
        ),
        lights=scene.lights.replace(radiance=p.light_radiance),
    )
    bh2 = None
    if bh is not None:
        bh2 = BlackHoleParams(
            position=p.bh_position,
            radius=p.bh_radius,
            delta_theta=p.bh_delta_theta,
            enabled=bh.enabled,
        )
    return scene2, bh2


def render_radiance(params: SceneParams, scene: SceneData,
                    bh: Optional[BlackHoleParams], rays: Rays,
                    cfg: RenderConfig, key) -> jnp.ndarray:
    """Differentiable radiance for a ray batch."""
    cfg = cfg.replace(differentiable=True)
    scene2, bh2 = bind_params(scene, bh, params)
    return est_radiance(scene2, bh2, rays, cfg, key)


def image_loss(params: SceneParams, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays,
               target: jnp.ndarray, cfg: RenderConfig, key) -> jnp.ndarray:
    """Mean L2 loss between rendered radiance and a target image batch.

    Under a sharded lane axis the mean is a cross-device reduction, so
    `jax.grad` of this loss produces psum-all-reduced parameter gradients."""
    img = render_radiance(params, scene, bh, rays, cfg, key)
    return jnp.mean((img - target) ** 2)


def train_step(params: SceneParams, opt_state, scene: SceneData,
               bh: Optional[BlackHoleParams], rays: Rays, target, cfg, key,
               lr: float = 1e-2):
    """One inverse-rendering SGD step (flagship training step: its grads
    all-reduce over the mesh when `rays`/`target` are batch-sharded)."""
    loss, grads = jax.value_and_grad(image_loss)(
        params, scene, bh, rays, target, cfg, key)
    params = jax.tree_util.tree_map(
        lambda p, g: p - lr * jnp.nan_to_num(g), params, grads)
    return params, opt_state, loss
