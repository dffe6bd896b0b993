"""Kerr black hole + emissive accretion disk renderer.

New capability beyond the reference (which has neither Kerr nor a disk):
camera rays are integrated through the Kerr metric (physics/kerr.py) and
shaded against a thin, opaque, Keplerian accretion disk in the equatorial
plane:

  * disk crossing = sign change of the spin-axis coordinate along a chord,
    within [r_in, r_out];
  * emission I(r) ∝ (r_in/r)^q, boosted by the relativistic Doppler +
    gravitational factor g = E_obs/E_emit for a circular Keplerian emitter
    (Ω = √M/(r^{3/2}+a√M)), applied as g^4 beaming — this produces the
    iconic bright approaching side;
  * horizon capture → black; escape → environment map (or a soft
    background gradient).

Everything is one `lax.scan` over RK4 steps with per-lane adaptive step
size — pure XLA, sharding-compatible on the lane axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.physics import kerr
from rrt_tpu.scene import envmap as envlib
from rrt_tpu.types import EnvMap, pytree_dataclass, static_field


@pytree_dataclass
class DiskParams:
    r_in: jnp.ndarray       # () inner radius (≥ ISCO for realism)
    r_out: jnp.ndarray      # ()
    emission: jnp.ndarray   # (3,) base radiance color
    q: jnp.ndarray          # () radial falloff exponent
    beaming: bool = static_field(True)


def default_disk(mass: float = 1.0) -> DiskParams:
    return DiskParams(
        r_in=jnp.asarray(3.0 * mass),      # ~ISCO for a=0.9..0 ballpark
        r_out=jnp.asarray(12.0 * mass),
        emission=jnp.asarray([1.0, 0.85, 0.6]),
        q=jnp.asarray(2.0),
    )


def _doppler_g(x, y, p, mass, a):
    """g = E_obs/E_emit for a Keplerian circular emitter at (x,y,0).

    Photon conserved E = −p_t = 1 (init_momentum normalization) and
    L_z = x p_y − y p_x; emitter 4-velocity u^t(1, 0, 0, Ω)."""
    r = jnp.sqrt(_safe(x * x + y * y))
    sq_m = jnp.sqrt(mass)
    omega = sq_m / (r ** 1.5 + a * sq_m)
    ut_inner = 1.0 - 3.0 * mass / r + 2.0 * a * sq_m / r ** 1.5
    # Clamp floors: ut_inner → 0 at the innermost stable circular orbit
    # (r_isco; r = 3M for a = 0), where a physical Keplerian emitter
    # cannot exist — the disk's inner edge is at r_isco, so clamped
    # samples lie inside the hole's shadow or the disk gap and are
    # discarded by the disk-extent mask downstream; the floor only keeps
    # the masked lanes' forward values finite (g capped at ~1e3·√(1e3),
    # far above any emitted-disk g, which stays O(1-3) outside r_isco —
    # cf. Cunningham 1975's transfer-function tables where g peaks < 2
    # for a ≤ 0.998). denom → 0 would need ω·L_z → 1, i.e. a photon
    # co-rotating exactly with the emitter — same masked-region case.
    ut = 1.0 / jnp.sqrt(jnp.maximum(ut_inner, 1e-3))
    lz = x * p[..., 1] - y * p[..., 0]
    denom = ut * (1.0 - omega * lz)
    return 1.0 / jnp.maximum(denom, 1e-3)


def _safe(v, eps=1e-20):
    return jnp.maximum(v, eps)


def render_rays(o_world, d_world, bh: kerr.KerrParams, disk: DiskParams,
                env: Optional[EnvMap] = None,
                n_steps: int = 600, r_escape: float = 45.0):
    """Trace world rays through the Kerr metric; returns (..., 3) radiance.

    Opaque disk: the first equatorial crossing inside [r_in, r_out] wins.
    """
    st = kerr.make_state(o_world, d_world, bh)
    shape = st.pt.shape
    acc = jnp.zeros(shape + (3,), o_world.dtype)
    hit_disk = jnp.zeros(shape, bool)

    def step(carry, _):
        st, acc, hit_disk = carry
        # adaptive step: fine near the hole, coarse far away
        r = jnp.sqrt(kerr._kerr_r2(
            st.x[..., 0], st.x[..., 1], st.x[..., 2], bh.spin))
        dlam = jnp.clip(0.18 * (r - 0.5 * bh.horizon_radius), 0.02, 2.0)
        frozen = st.captured | st.escaped | hit_disk
        dlam = jnp.where(frozen, 0.0, dlam)
        st2, (xa, xb) = kerr.march_step(st, bh, dlam, r_escape)
        # disk crossing: z sign change along the chord (hole frame)
        za = xa[..., 2]
        zb = xb[..., 2]
        crossing = (za * zb < 0.0) & ~frozen
        s = za / jnp.where(jnp.abs(za - zb) > 1e-20, za - zb, 1.0)
        cx = xa[..., 0] + s * (xb[..., 0] - xa[..., 0])
        cy = xa[..., 1] + s * (xb[..., 1] - xa[..., 1])
        cr = jnp.sqrt(_safe(cx * cx + cy * cy))
        on_disk = crossing & (cr >= disk.r_in) & (cr <= disk.r_out)

        profile = (disk.r_in / cr) ** disk.q
        if disk.beaming:
            g = _doppler_g(cx, cy, st2.p, bh.mass, bh.spin)
            boost = g ** 4
        else:
            boost = jnp.ones_like(cr)
        radiance = disk.emission * (profile * boost)[..., None]
        acc = jnp.where((on_disk & ~hit_disk)[..., None], radiance, acc)
        hit_disk = hit_disk | on_disk
        return (st2, acc, hit_disk), None

    (st, acc, hit_disk), _ = jax.lax.scan(
        step, (st, acc, hit_disk), None, length=n_steps)

    # escaped rays: environment lookup along the final momentum direction
    p_world = jnp.stack(
        [st.p[..., 0], st.p[..., 2], -st.p[..., 1]], axis=-1)
    p_world = p_world / jnp.linalg.norm(p_world + 1e-20, axis=-1,
                                        keepdims=True)
    if env is not None:
        bg = envlib.sample_dir(env, p_world)
    else:
        # soft star-field-ish gradient so lensing is visible without an env
        t = 0.5 * (p_world[..., 1] + 1.0)
        bg = jnp.stack([0.03 + 0.05 * t, 0.04 + 0.06 * t,
                        0.08 + 0.12 * t], axis=-1)
    out = jnp.where(hit_disk[..., None], acc, 0.0)
    out = jnp.where((st.escaped & ~hit_disk)[..., None], bg, out)
    return out


def look_at_rays(eye, target, up, fov_deg, width, height, jitter=None,
                 dtype=jnp.float32):
    """Simple look-at pinhole camera (the Kerr scene has no COLLADA
    camera); returns flat (...,3) origins/directions."""
    eye = jnp.asarray(eye, dtype)
    fwd = jnp.asarray(target, dtype) - eye
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(fwd, jnp.asarray(up, dtype))
    right = right / jnp.linalg.norm(right)
    upv = jnp.cross(right, fwd)
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=dtype), jnp.arange(width, dtype=dtype),
        indexing="ij")
    px = jnp.stack([xs, ys], -1).reshape(-1, 2)
    if jitter is not None:
        px = px + jitter
    else:
        px = px + 0.5
    tan_f = math.tan(math.radians(fov_deg) / 2.0)
    ar = width / height
    sx = (2.0 * px[:, 0] / width - 1.0) * tan_f * ar
    sy = (1.0 - 2.0 * px[:, 1] / height) * tan_f
    d = (fwd[None, :] + sx[:, None] * right[None, :]
         + sy[:, None] * upv[None, :])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(eye, d.shape)
    return o, d


def render_image(width, height, bh: kerr.KerrParams, disk: DiskParams,
                 eye=(0.0, 3.0, 22.0), target=(0.0, 0.0, 0.0),
                 fov_deg=30.0, env: Optional[EnvMap] = None,
                 spp: int = 1, seed: int = 0,
                 n_steps: int = 600, batch: int = 1 << 18,
                 sharding=None) -> np.ndarray:
    """Render the Kerr-disk scene to an (H, W, 3) HDR image, processing
    the pixel lanes in batches (each batch one jit call).

    `sharding` (a NamedSharding over the lane axis, see parallel/sharding)
    shards every batch across the device mesh — same scheme as the main
    renderer's megabatches; GSPMD runs the RK4 scan per-device with no
    cross-device traffic (pixels are independent)."""
    fn = jax.jit(functools_partial_render(bh, disk, env, n_steps, sharding))
    n = width * height
    acc = np.zeros((n, 3), np.float32)
    key = jax.random.key(seed)
    for s in range(spp):
        if spp == 1:
            jitter = None
        else:
            key, k = jax.random.split(key)
            jitter = jax.random.uniform(k, (n, 2), jnp.float32)
        o, d = look_at_rays(eye, target, (0, 1, 0), fov_deg, width, height,
                            jitter)
        for i in range(0, n, batch):
            sl = slice(i, min(i + batch, n))
            ob, db = o[sl], d[sl]
            if ob.shape[0] % _sharding_divisor(sharding) != 0:
                pad = (-ob.shape[0]) % _sharding_divisor(sharding)
                ob = jnp.pad(ob, ((0, pad), (0, 0)))
                db = jnp.pad(db, ((0, pad), (0, 0)), constant_values=1.0)
                acc[sl] += np.asarray(fn(ob, db))[:sl.stop - sl.start]
            else:
                acc[sl] += np.asarray(fn(ob, db))
    return (acc / spp).reshape(height, width, 3)


def _sharding_divisor(sharding) -> int:
    if sharding is None:
        return 1
    return int(np.prod([sharding.mesh.shape[a] for a in sharding.mesh.shape]))


def functools_partial_render(bh, disk, env, n_steps, sharding=None):
    def fn(o, d):
        if sharding is not None:
            o = jax.lax.with_sharding_constraint(o, sharding)
            d = jax.lax.with_sharding_constraint(d, sharding)
        return render_rays(o, d, bh, disk, env, n_steps)
    return fn
