"""Per-pixel ray-log dump — the headless analog of the reference's rayLog +
interactive ray drawing (`pathtracer/src/pathtracer.cpp:330-423`: keypress
`V` draws every 500th logged camera ray, yellow for hit / red for miss,
plus the BVH walk). With no GL viewer, the log is files:

  * `<base>_raylog.npz` — per-pixel arrays for every camera ray:
      outcome    (H,W) i8: 0 = miss/escaped, 1 = geometry hit,
                 2 = absorbed by the event horizon
      win_seg    (H,W) i16: winning micro-segment index (n_seg if none)
      marched    (H,W) i16: micro segments actually marched before the
                 ray's event (its traversal depth along the bent path)
      clusters   (H,W) i32: cluster AABBs its marched chords touch — the
                 per-ray traversal-cost figure (reference's per-ray
                 isect-test count analog, bvh.h:140)
      prim       (H,W) i32: winning primitive id (-1 none)
  * `<base>_raylog_cost.png`  — `clusters` heatmap (blue→green→red)
  * `<base>_raylog_seg.png`   — `win_seg` heatmap
  * `<base>_raylog_hit.png`   — outcome map: yellow hit / red miss (the
    reference's ray colors), black absorbed
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.geometry import trace as tracer
from rrt_tpu.render import film
from rrt_tpu.types import SceneData


def _camera_rays(cam, width, height):
    ys, xs = np.meshgrid((np.arange(height) + 0.5) / height,
                         (np.arange(width) + 0.5) / width, indexing="ij")
    xy = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2), jnp.float32)
    return cam.generate_rays(xy)


def ray_log(scene: SceneData, bh, cam, width: int, height: int,
            n_seg: int = 63):
    """Compute the per-pixel ray log arrays (dict of (H,W) ndarrays)."""
    from rrt_tpu.physics import schwarzschild as ss

    rays = _camera_rays(cam, width, height)
    curved = bh is not None and bh.enabled
    hit, seg = tracer.trace_with_seg(scene, bh, rays, n_seg=n_seg,
                                     backend="xla")
    n = width * height
    if curved:
        # replay the march to classify absorption and count touched
        # clusters chord by chord (bvh.cpp:103-113 loop, diagnostics-only)
        def step(c, _):
            pos, dirn, dead = c
            nd, clen, sdead = ss.micro_step(pos, dirn, bh)
            dead = dead | sdead
            clen = jnp.where(dead, 0.0, clen)
            absorbed = ss.absorbed_by_hole(pos, nd, clen, bh) & ~dead
            npos = pos + nd * clen[..., None]
            return (npos, nd, dead), (pos, nd, clen, absorbed)

        (_, _, _), (co, cd, clen, absv) = jax.lax.scan(
            step, (rays.o, rays.d, jnp.zeros(n, bool)), None, length=n_seg)
        # first absorption segment (n_seg if never)
        abs_any = jnp.any(absv, axis=0)
        abs_seg = jnp.where(abs_any, jnp.argmax(absv, axis=0), n_seg)
        marched = jnp.minimum(jnp.minimum(seg, abs_seg) + 1, n_seg)
        absorbed = abs_any & (abs_seg <= seg) & ~hit.hit

        # touched clusters, one segment at a time (the dense (seg, ray,
        # cluster) tensor would be GBs at real frame sizes)
        def count_step(carry, xs):
            s, total = carry
            o_s, d_s, len_s = xs
            inv = 1.0 / jnp.where(jnp.abs(d_s) < 1e-20, 1e-20, d_s)
            t0 = (scene.cluster_lo[None] - o_s[:, None]) * inv[:, None]
            t1 = (scene.cluster_hi[None] - o_s[:, None]) * inv[:, None]
            tmn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tmx = jnp.min(jnp.maximum(t0, t1), axis=-1)
            reach = (tmn <= tmx) & (tmn <= len_s[:, None]) & (tmx >= 0.0)
            cnt = jnp.sum(reach, axis=-1)
            total = total + jnp.where(s < marched, cnt, 0)
            return (s + 1, total), None

        (_, clusters), _ = jax.lax.scan(
            count_step, (jnp.int32(0), jnp.zeros(n, jnp.int32)),
            (co, cd, clen))
    else:
        marched = jnp.ones(n, jnp.int32)
        absorbed = jnp.zeros(n, bool)
        from rrt_tpu.utils.accel_viz import touched_cluster_counts
        clusters = jnp.asarray(touched_cluster_counts(scene, rays))

    outcome = jnp.where(hit.hit, 1, jnp.where(absorbed, 2, 0))
    shape = (height, width)
    return {
        "outcome": np.asarray(outcome, np.int8).reshape(shape),
        "win_seg": np.asarray(seg, np.int16).reshape(shape),
        "marched": np.asarray(marched, np.int16).reshape(shape),
        "clusters": np.asarray(clusters, np.int32).reshape(shape),
        "prim": np.asarray(hit.prim_id, np.int32).reshape(shape),
    }


def dump_ray_log(scene: SceneData, bh, cam, width: int, height: int,
                 base: str, n_seg: int = 63) -> dict:
    """Write `<base>_raylog.npz` + the three PNG panels; returns the log."""
    log = ray_log(scene, bh, cam, width, height, n_seg)
    np.savez(base + "_raylog.npz", **log)

    cmax = max(int(log["clusters"].max()), 1)
    film.save_sampling_rate_image(base + "_raylog_cost.png",
                                  log["clusters"], cmax)
    film.save_sampling_rate_image(base + "_raylog_seg.png",
                                  log["win_seg"].astype(np.int32), n_seg)
    out = log["outcome"]
    img = np.zeros(out.shape + (4,), np.uint8)
    img[..., 3] = 255
    img[out == 1] = (255, 230, 0, 255)     # hit: yellow (pathtracer.cpp:403)
    img[out == 0] = (200, 30, 30, 255)     # miss: red   (pathtracer.cpp:412)
    img[out == 2] = (0, 0, 0, 255)         # absorbed: black (the hole)
    film.write_png(base + "_raylog_hit.png", img[::-1])
    return log
