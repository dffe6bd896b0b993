"""Schwarzschild photon-orbit micro-ray marching.

Re-implements the reference's geodesic stepper
(`pathtracer/src/static_scene/blackhole.cpp:13-40`) as a batched, jittable,
differentiable function. The reference marches every ray as a chain of
straight chord segments: in the plane spanned by the ray and the hole
center, the inverse radius u(φ) obeys the Schwarzschild null-geodesic ODE

    u''(φ) = -u + (3/2) r_s u²            (blackhole.cpp:13-15)

and one Δθ step advances u with the reference's RK-ish update

    u += u'·Δθ + (f1+f2+f3)·Δθ²/6         (blackhole.cpp:28-32)

(the reference computes an unused f4; we don't). The new position is the
polar point (d·cosΔθ, d·sinΔθ) in the step's local frame; the returned
chord is the straight segment between consecutive polar points.

Degenerate radial rays (transverse component dy → 0) are unguarded UB in
the reference (`blackhole.cpp:27` divides by dy); we flag them `dead` —
the same observable outcome (the ray produces no hits) without NaNs
poisoning the batch.

Physics caveat (reproduced deliberately): the reference never carries u'
between steps — it re-derives u' from the secant chord at the new polar
point, which halves the effective curvature. The stepper's converged
deflection is ≈ r_s/b, HALF the GR value 2·r_s/b (pinned by
tests/test_kerr.py::test_reference_stepper_bends_half_of_gr). Render
parity with the reference binary depends on keeping this; for exact-GR
geodesics use physics/kerr.py with a=0.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from rrt_tpu.types import BlackHoleParams

_DY_EPS = 1e-12


def ode_rhs(u, r):
    """f(u) = -u + (3/2)·r·u² (blackhole.cpp:13-15)."""
    return -u + 1.5 * r * u * u


@jax.custom_vjp
def grad_guard(x):
    """Identity whose COTANGENT is sanitized (NaN/inf scrubbed, clipped).

    Near-wrap geodesic steps are chaotic: reverse-mode Jacobian products
    through u→1/u→1e9-scale positions overflow f32 *inside a single
    step's VJP*, and one poisoned lane NaNs the whole summed parameter
    gradient (d/dΔθ especially — `up` appears by value in ∂u_new/∂Δθ).
    Stationing these identity guards between the step's stages bounds
    every backward product: cotangents are clipped to ±1e3 at each guard,
    and the per-stage Jacobians between guards are ≤ ~1e18, so no product
    can reach f32 inf. Forward values are bit-identical — non-AD paths
    (including reference parity) are unaffected."""
    return x


def _gg_fwd(x):
    return x, None


def _gg_bwd(_, ct):
    ct = jnp.nan_to_num(ct, nan=0.0, posinf=0.0, neginf=0.0)
    return (jnp.clip(ct, -1e3, 1e3),)


grad_guard.defvjp(_gg_fwd, _gg_bwd)


def micro_step(pos, direction, bh: BlackHoleParams):
    """One Δθ micro-ray step for a batch of rays.

    Args:
      pos: (...,3) current endpoint (start of the new chord).
      direction: (...,3) unit direction of travel at `pos`.
    Returns:
      (new_dir, chord_len, dead): the next chord's unit direction, its
      length, and a mask of degenerate (radial) rays. The next position is
      `pos + new_dir * chord_len`.
    """
    dt = bh.delta_theta
    x_axis = pos - bh.position
    # safe norms: masked/degenerate lanes must not emit NaN cotangents
    d2 = jnp.sum(x_axis * x_axis, axis=-1)
    at_center = d2 <= 0
    dist = jnp.sqrt(jnp.where(at_center, 1.0, d2))
    # reciprocal-multiply normalizations, NOT per-axis divisions: the
    # fused kernel's march (ops/trace_kernel._kernel.march) repeats these
    # operations in this order, so the two compilations agree on calm
    # lanes (ops/kernel_check.py, tests/test_pallas.py).
    rdist = 1.0 / dist
    x_hat = x_axis * rdist[..., None]
    # Magnitude caps (u ≤ 1e12, |u'| ≤ 1e15, |f| ≤ 1e30): lanes that
    # land pathologically close to the hole center produce u² terms that
    # overflow f32 to inf. Forward, those lanes already yield d_new ≈ 0
    # (a chord collapsing to the center) and the caps keep that limit to
    # within ~1e-27 absolute. The REAL reason for the caps is reverse
    # mode: an inf forward value makes some ∂/∂Δθ partial inf, and the
    # chain rule's 0·inf = NaN then poisons the SUMMED parameter
    # gradient for the whole batch. The reference marches these lanes in
    # double precision where the same garbage just stays finite longer —
    # their values are chaotic either way.
    u = 1.0 / jnp.maximum(dist, 1e-12)   # cap via the denominator, so the
    # intermediate 1/dist² partial can never itself overflow
    dx = jnp.sum(direction * x_hat, axis=-1)
    y_axis = direction - dx[..., None] * x_hat
    y2 = jnp.sum(y_axis * y_axis, axis=-1)
    dead = (y2 < _DY_EPS * _DY_EPS) | at_center
    safe_dy = jnp.sqrt(jnp.where(dead, 1.0, y2))
    rdy = 1.0 / safe_dy
    y_hat = y_axis * rdy[..., None]
    up = grad_guard(jnp.clip(-u * dx * rdy, -1e15, 1e15))
    r = bh.radius
    fclip = lambda f: jnp.clip(f, -1e30, 1e30)
    f1 = fclip(ode_rhs(u, r))
    f2 = fclip(ode_rhs(u + up * dt / 2.0, r))
    f3 = fclip(ode_rhs(u + up * dt / 2.0 + f1 * dt * dt / 4.0, r))
    u_new = u + up * dt + (f1 + f2 + f3) * dt * dt / 6.0
    # u_new <= 0 is NOT an error in the reference: d = 1/u goes negative
    # and the path "teleports" through the hole to the mirrored polar
    # position (blackhole.cpp:33-36, well-defined arithmetic — only dy→0
    # is true UB). Those wrapped chords re-cross the scene and are load-
    # bearing for occlusion statistics (e.g. env-light NEE inside a box),
    # so reproduce them; clamp |d| to keep f32 chord² finite.
    # |u_new| < 1e-9 is the clamp region (|1/u| > 1e9). Branch with
    # `where` on a SAFE denominator instead of clip(1/u): the clip zeroes
    # the gradient there anyway, but reverse-mode still evaluates
    # d(1/u)/du = -1/u² → f32 inf, and inf·0 = NaN poisons d/d(Δθ) on
    # every teleport lane. Forward values are bit-identical to
    # clip(1/u_safe, ±1e9) (and to the fused kernel's copy of this line).
    clip_region = jnp.abs(u_new) < 1e-9
    u_den = jnp.where(clip_region, 1.0, u_new)
    d_new = grad_guard(jnp.where(clip_region,
                                 jnp.where(u_new >= 0, 1e9, -1e9),
                                 1.0 / u_den))
    next_pt = (
        bh.position
        + (d_new * jnp.cos(dt))[..., None] * x_hat
        + (d_new * jnp.sin(dt))[..., None] * y_hat
    )
    chord = grad_guard(next_pt - pos)
    c2 = jnp.sum(chord * chord, axis=-1)
    zero_len = c2 <= 0
    chord_len = jnp.sqrt(jnp.where(zero_len, 1.0, c2))
    new_dir = chord * (1.0 / chord_len)[..., None]
    chord_len = jnp.where(zero_len, 0.0, chord_len)
    dead = dead | ~jnp.isfinite(chord_len) | zero_len
    return new_dir, chord_len, dead


def absorbed_by_hole(o, d, max_t, bh: BlackHoleParams):
    """Does the chord [0, max_t] hit the event-horizon sphere?

    Matches Sphere::intersect used for absorption (`bvh.cpp:107`,
    `sphere.cpp:26-53`): near root preferred, far root accepted (so chords
    *starting inside* the horizon are absorbed too).
    """
    tmp = o - bh.position
    b = 2.0 * jnp.sum(tmp * d, axis=-1)
    c = jnp.sum(tmp * tmp, axis=-1) - bh.radius * bh.radius
    disc = b * b - 4.0 * c
    has = disc >= 0
    sq = jnp.sqrt(jnp.where(has, disc, 1.0))  # safe sqrt for AD
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    ok1 = (0.0 <= t1) & (t1 <= max_t)
    ok2 = (0.0 <= t2) & (t2 <= max_t)
    return has & (ok1 | ok2)


def n_segments(delta_theta: float) -> int:
    """Segment count: j advances while j·Δθ < 2π (bvh.cpp:105)."""
    return int(math.ceil(2.0 * math.pi / float(delta_theta) - 1e-12))
