"""Acceleration-structure visualization — the headless analog of the reference's
interactive BVH visualizer (`pathtracer.cpp:330-423`, keypress `V`: draws
node bboxes and walks the tree).

With no GL viewer, the diagnostics are files:

  * `<base>_accel.json` — the Morton-cluster table (per-cluster AABB +
    triangle row range) plus the scene bbox: the data the reference's
    visualizer draws as wireframes;
  * `<base>_accel.png` — per-pixel count of cluster AABBs the (straight)
    camera ray's [min_t, max_t] segment touches, on the same blue→green→red
    map as the sampling-rate heatmap. This is the traversal-cost heatmap:
    it shows exactly which image regions drag tiles through many granules
    (the quantity the shortlist engine's rounds scale with).
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from rrt_tpu.render import film
from rrt_tpu.types import SceneData


def touched_cluster_counts(scene: SceneData, rays) -> np.ndarray:
    """Per-ray count of cluster AABBs the straight ray segment touches."""
    o = rays.o.reshape(-1, 3)
    d = rays.d.reshape(-1, 3)
    mn = rays.min_t.reshape(-1)
    mx = rays.max_t.reshape(-1)
    sd = jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)
    inv = 1.0 / sd
    t0 = (scene.cluster_lo[None] - o[:, None, :]) * inv[:, None, :]
    t1 = (scene.cluster_hi[None] - o[:, None, :]) * inv[:, None, :]
    tmn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmx = jnp.min(jnp.maximum(t0, t1), axis=-1)
    reach = (tmn <= tmx) & (tmx >= mn[:, None]) & (tmn <= mx[:, None])
    return np.asarray(jnp.sum(reach, axis=-1))


def dump_accel(scene: SceneData, cam, width: int, height: int, base: str):
    """Write `<base>_accel.json` + `<base>_accel.png` (see module doc)."""
    lo = np.asarray(scene.cluster_lo)
    hi = np.asarray(scene.cluster_hi)
    cs = scene.cluster_size
    valid = np.asarray(scene.tri_bsdf >= 0)
    doc = {
        "cluster_size": cs,
        "n_tris": int(scene.n_tris),
        "n_spheres": int(scene.n_spheres),
        "scene_bbox": {
            "lo": np.minimum.reduce(lo[np.isfinite(lo).all(1) & (lo[:, 0] < 1e30)]).tolist()
            if len(lo) else None,
            "hi": np.maximum.reduce(hi[np.isfinite(hi).all(1) & (hi[:, 0] > -1e30)]).tolist()
            if len(hi) else None,
        },
        "clusters": [
            {
                "id": k,
                "lo": lo[k].tolist(),
                "hi": hi[k].tolist(),
                "tri_rows": [k * cs, (k + 1) * cs],
                "n_valid_tris": int(valid[k * cs:(k + 1) * cs].sum()),
            }
            for k in range(len(lo))
        ],
    }
    with open(base + "_accel.json", "w") as f:
        json.dump(doc, f, indent=1)

    ys, xs = np.meshgrid((np.arange(height) + 0.5) / height,
                         (np.arange(width) + 0.5) / width, indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    rays = cam.generate_rays(jnp.asarray(xy))
    counts = touched_cluster_counts(scene, rays).reshape(height, width)
    kmax = max(int(counts.max()), 1)
    film.save_sampling_rate_image(base + "_accel.png", counts, kmax)
    return counts
