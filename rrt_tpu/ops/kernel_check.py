"""The fused trace kernel against its plain references, at real widths.

`compare()` traces one ray batch three ways — the kernel
(ops/trace_kernel.py), the XLA path (geometry/trace.py) and brute force
(`closest_hit_brute`, every primitive for every chord) — and applies the
acceptance rule:

  * flat: hit and prim_id agree exactly on every lane; hit point within
    atol 2e-4 and shading normal within atol 2e-3;
  * curved: lanes whose march never wraps through the hole (u ≤ 0) nor
    passes within 5 horizon radii of it before its event ("calm" lanes)
    agree exactly on hit. The two compilations' marches differ in the
    last bit (fused multiply-adds are placed differently), so a chord
    that crosses an edge within rounding takes either side: the shared
    edge of two triangles (the same hit point within the flat atol,
    counted as `calm_edge_ties`, allowed) or a silhouette (another
    surface further on, `calm_silhouette_flips`, allowed on at most 1 in
    10,000 calm lanes that both hit). Over all lanes at
    least 99.5 % agree on hit, and of the lanes both hit, 99.5 % on
    prim_id. Wrapped and near-hole chords amplify float32 rounding
    without bound, so the rule there is statistical (tests/test_x64.py
    checks them in float64 instead).

`probe_rays()` builds the batches: a camera grid, and bounce rays leaving
the camera hits in seeded directions over each hit's hemisphere.
Used by tools/kbench.py, chip_smoke.py and tests/test_pallas.py.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.geometry import trace as T
from rrt_tpu.geometry.intersect import build_hit, closest_hit_brute
from rrt_tpu.ops.trace_kernel import pallas_trace
from rrt_tpu.physics import schwarzschild as ss
from rrt_tpu.types import BlackHoleParams, Rays, SceneData

FLAT_P_ATOL = 2e-4
FLAT_N_ATOL = 2e-3
CURVED_MIN_AGREE = 0.995
CALM_MAX_FLIP_SHARE = 1e-4


def probe_rays(scene: SceneData, cam, side: int, seed: int = 0,
               eps: float = 1e-4) -> Dict[str, Rays]:
    """side² camera rays through pixel centres, and as many bounce rays."""
    xs = (jnp.arange(side * side) % side + 0.5) / side
    ys = (jnp.arange(side * side) // side + 0.5) / side
    cam_rays = cam.generate_rays(jnp.stack([xs, ys], axis=-1))
    h = T.trace(scene, None, cam_rays, backend="xla")
    k1, k2 = jax.random.split(jax.random.key(seed))
    d = jax.random.normal(k1, cam_rays.d.shape, jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    n = h.n / jnp.maximum(jnp.linalg.norm(h.n, axis=-1, keepdims=True),
                          1e-20)
    # face the normal toward the camera ray's side of the surface
    n = jnp.where(jnp.sum(n * cam_rays.d, -1, keepdims=True) > 0, -n, n)
    d = jnp.where(jnp.sum(d * n, -1, keepdims=True) < 0, -d, d)
    # lanes whose camera ray missed start at random points in the scene
    glo, ghi = T._scene_bbox(scene)
    u = jax.random.uniform(k2, cam_rays.o.shape, jnp.float32)
    o = jnp.where(h.hit[:, None], h.p + eps * n, glo + u * (ghi - glo))
    m = cam_rays.min_t.shape
    bounce = Rays(o=o, d=d, min_t=jnp.zeros(m, jnp.float32),
                  max_t=jnp.full(m, jnp.inf, jnp.float32))
    return {"camera": cam_rays, "bounce": bounce}


def calm_lanes(bh: BlackHoleParams, rays: Rays, n_seg: int,
               last_seg) -> np.ndarray:
    """Lanes whose march has no wrapped (chord > 50) or near-hole chord up
    to and including segment `last_seg` (per lane)."""
    def step(c, _):
        pos, dirn, dead = c
        nd, clen, sdead = ss.micro_step(pos, dirn, bh)
        dead = dead | sdead
        clen = jnp.where(dead, 0.0, clen)
        near = jnp.linalg.norm(pos - bh.position, axis=-1) < 5.0 * bh.radius
        return (pos + nd * clen[..., None], nd, dead), (clen > 50.0) | near
    _, w = jax.lax.scan(step, (rays.o, rays.d,
                               jnp.zeros(rays.o.shape[0], bool)),
                        None, length=n_seg)
    upto = jnp.arange(n_seg)[:, None] <= jnp.asarray(last_seg)[None]
    return ~np.asarray(jnp.any(w & upto, axis=0))


def brute_trace(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
                n_seg: int):
    """Closest hit by brute force: flat, or the seg-group curved fold with
    every chord tested against every primitive."""
    if bh is None:
        hit, t, pid, b1, b2, _ = closest_hit_brute(
            scene, rays.o, rays.d, rays.min_t, rays.max_t)
        h = build_hit(scene, rays.o, rays.d, hit, t, pid, b1, b2)
        return h, jnp.zeros(t.shape, jnp.int32)
    return T.trace_curved(scene, bh, rays, n_seg=n_seg, accel="brute",
                          return_seg=True)


def check(kern, ref, curved: bool, calm: Optional[np.ndarray]) -> dict:
    """Apply the acceptance rule to two Hit batches (kernel, reference)."""
    ha, hb = np.asarray(kern.hit), np.asarray(ref.hit)
    both = ha & hb
    pa, pb = np.asarray(kern.prim_id), np.asarray(ref.prim_id)
    out = {"lanes": int(ha.size), "hits": int(ha.sum()),
           "hit_agree": float((ha == hb).mean()),
           "prim_agree": float((pa[both] == pb[both]).mean())
           if both.any() else 1.0}
    if not curved:
        dp = np.abs(np.asarray(kern.p) - np.asarray(ref.p))[both]
        dn = np.abs(np.asarray(kern.n) - np.asarray(ref.n))[both]
        out["p_maxdiff"] = float(dp.max()) if dp.size else 0.0
        out["n_maxdiff"] = float(dn.max()) if dn.size else 0.0
        out["ok"] = bool((ha == hb).all() and (pa[both] == pb[both]).all()
                         and out["p_maxdiff"] <= FLAT_P_ATOL
                         and out["n_maxdiff"] <= FLAT_N_ATOL)
    else:
        mc = calm & both
        flip = mc & (pa != pb)
        dp = np.abs(np.asarray(kern.p) - np.asarray(ref.p)).max(-1)[flip]
        out["calm_share"] = float(calm.mean())
        out["calm_hit_agree"] = float((ha[calm] == hb[calm]).mean()) \
            if calm.any() else 1.0
        out["calm_prim_agree"] = float((pa[mc] == pb[mc]).mean()) \
            if mc.any() else 1.0
        out["calm_edge_ties"] = int((dp <= FLAT_P_ATOL).sum())
        out["calm_silhouette_flips"] = int((dp > FLAT_P_ATOL).sum())
        flips = out["calm_silhouette_flips"]
        out["ok"] = bool(out["calm_hit_agree"] == 1.0
                         and flips <= CALM_MAX_FLIP_SHARE * mc.sum()
                         and out["hit_agree"] >= CURVED_MIN_AGREE
                         and out["prim_agree"] >= CURVED_MIN_AGREE)
    return out


def compare(scene: SceneData, bh: Optional[BlackHoleParams], rays: Rays,
            n_seg: int = 63, brute_lanes: Optional[int] = None,
            interpret: bool = False) -> Dict[str, dict]:
    """Kernel vs XLA path vs brute force on one batch. `brute_lanes` caps
    the lanes given to brute force (it tests every primitive)."""
    curved = bh is not None
    nb = rays.o.shape[0] if brute_lanes is None else brute_lanes
    cut = lambda tree: jax.tree_util.tree_map(lambda a: a[:nb], tree)
    with jax.default_matmul_precision("highest"):
        kern, k_seg = jax.jit(lambda r: pallas_trace(
            scene, bh, r, n_seg=n_seg, interpret=interpret,
            return_seg=True))(rays)
        xla, x_seg = jax.jit(lambda r: T.trace_with_seg(
            scene, bh, r, n_seg=n_seg, backend="xla"))(rays)
        brute, b_seg = jax.jit(
            lambda r: brute_trace(scene, bh, r, n_seg))(cut(rays))
    out = {}
    for name, ref, seg, r in (("xla", xla, x_seg, rays),
                              ("brute", brute, b_seg, cut(rays))):
        k = cut(kern) if name == "brute" else kern
        ks = k_seg[:nb] if name == "brute" else k_seg
        calm = calm_lanes(bh, r, n_seg, jnp.maximum(ks, seg)) \
            if curved else None
        out[name] = check(k, ref, curved, calm)
    return out
