"""Interactive acceleration-structure walk — the headless analog of the
reference's VISUALIZE mode BVH navigation.

The reference keeps a selection stack over its binary BVH and navigates it
with arrow keys: UP pops to the parent, LEFT pushes the left child, RIGHT
the right child (`pathtracer.cpp:520-534`); `visualize_accel()` then draws
every node box dim, the selection highlighted, its children brighter, and
the contained primitives shaded per child (`pathtracer.cpp:330-423`).

There is no GL window and no binary BVH here: the accelerator is the
trace kernel's group → cluster → triangle culling hierarchy
(`ops/trace_kernel.build_tables`, derived from the Morton-ordered
triangle rows: TILE triangles per cluster, GROUP clusters per group).
This module mirrors those tables on the host and exposes the same walk
over the N-ary tree:

  up    — pop to the parent (root stays put, like the reference)
  left  — descend into the FIRST child (the reference's "push child")
  right — advance to the next SIBLING (N-ary analog of `l`/`r`)

`render()` rasterizes the view the reference draws with GL: all sibling
boxes dim, the selected node's box bright and thick, its children's boxes
brighter, and the selected node's triangles' edges overlaid — projected
with the render camera (straight lines; the reference's GL draw ignores
curvature too) over an optional base image. Served live by `--serve`
(`utils/serve.py`: /accel.png + POST /control {"accel": "left"|...}).
"""
from __future__ import annotations

import math

import numpy as np

from rrt_tpu.ops import trace_kernel as tk


def _node_boxes(lo_tri, hi_tri, group):
    """Group per-triangle extents into node boxes of `group` rows."""
    n = lo_tri.shape[0]
    pad = (-n) % group
    if pad:
        lo_tri = np.concatenate(
            [lo_tri, np.full((pad, 3), np.inf, lo_tri.dtype)])
        hi_tri = np.concatenate(
            [hi_tri, np.full((pad, 3), -np.inf, hi_tri.dtype)])
    k = lo_tri.shape[0] // group
    return (lo_tri.reshape(k, group, 3).min(axis=1),
            hi_tri.reshape(k, group, 3).max(axis=1))


class KernelHierarchy:
    """Host mirror of the kernel's culling tables: the root, groups of
    GROUP clusters, clusters of TILE triangle rows (`trace_kernel.TILE`,
    `trace_kernel.GROUP`)."""

    def __init__(self, scene):
        v0 = np.asarray(scene.tri_v0, np.float64)
        v1 = np.asarray(scene.tri_v1, np.float64)
        v2 = np.asarray(scene.tri_v2, np.float64)
        live = np.asarray(scene.tri_bsdf) >= 0
        self.tris = np.stack([v0, v1, v2], axis=1)        # (T, 3, 3)
        self.live = live
        lo = np.where(live[:, None],
                      np.minimum(np.minimum(v0, v1), v2), np.inf)
        hi = np.where(live[:, None],
                      np.maximum(np.maximum(v0, v1), v2), -np.inf)
        self.cs = tk.TILE
        # row widths per level: 0 root, 1 groups, 2 clusters
        self.width = (v0.shape[0], tk.TILE * tk.GROUP, tk.TILE)
        self.cl_lo, self.cl_hi = _node_boxes(lo, hi, self.width[2])
        self.grp_lo, self.grp_hi = _node_boxes(lo, hi, self.width[1])
        self.root_lo = self.grp_lo.min(axis=0)
        self.root_hi = self.grp_hi.max(axis=0)

    def boxes(self, level):
        return [(self.root_lo[None], self.root_hi[None]),
                (self.grp_lo, self.grp_hi),
                (self.cl_lo, self.cl_hi)][level]

    def n_children(self, level, idx):
        """Children of node (level, idx) that cover at least one row."""
        if level == len(self.width) - 1:
            return 0
        t0, t1 = self.tri_range(level, idx)
        return -(-(t1 - t0) // self.width[level + 1])

    def child_index(self, level, idx, child):
        """Global index of `child` under node (level, idx)."""
        return idx * (self.width[level] // self.width[level + 1]) + child \
            if level else child

    def tri_range(self, level, idx):
        """[start, stop) triangle rows covered by node (level, idx)."""
        start = idx * self.width[level]
        return start, min(start + self.width[level], self.tris.shape[0])


class AccelWalk:
    """Selection-stack walk + wireframe rasterizer."""

    def __init__(self, scene, camera):
        self.h = KernelHierarchy(scene)
        self.stack = [(0, 0)]                # (level, index), root first
        self.camera = camera

    @property
    def selected(self):
        return self.stack[-1]

    def key(self, action: str) -> bool:
        """Apply one navigation key; returns True if the state changed.
        Mirrors pathtracer.cpp:520-534 (up = pop, left = push child,
        right = sibling)."""
        level, idx = self.stack[-1]
        if action == "up":
            if len(self.stack) > 1:
                self.stack.pop()
                return True
            return False
        if action == "left":
            if self.h.n_children(level, idx) > 0:
                self.stack.append(
                    (level + 1, self.h.child_index(level, idx, 0)))
                return True
            return False
        if action == "right":
            if len(self.stack) > 1:
                plevel, pidx = self.stack[-2]
                nsib = self.h.n_children(plevel, pidx)
                base = self.h.child_index(plevel, pidx, 0)
                nxt = base + (idx - base + 1) % nsib
                self.stack[-1] = (level, nxt)
                return True
            return False
        return False

    # ------------------------------------------------------------ drawing

    def _project(self, pts):
        """World → pixel (straight-line pinhole, like the GL draw).
        Returns (N,2) float pixels + validity mask (in front of cam)."""
        cam = self.camera
        p = (np.asarray(pts, np.float64)
             - np.asarray(cam.pos, np.float64)) @ np.asarray(
            cam.c2w, np.float64)
        z = p[:, 2]
        ok = z < -1e-9
        zs = np.where(ok, z, -1.0)
        bx = math.tan(math.radians(cam.h_fov) / 2)
        by = math.tan(math.radians(cam.v_fov) / 2)
        x01 = (p[:, 0] / (-zs) / bx + 1.0) / 2.0
        y01 = (p[:, 1] / (-zs) / by + 1.0) / 2.0
        return np.stack([x01 * cam.screen_w, y01 * cam.screen_h],
                        axis=1), ok

    def _line(self, img, a, b, color, alpha=1.0):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1))
        n = min(n, 4 * max(img.shape[0], img.shape[1]))
        t = np.linspace(0.0, 1.0, n + 1)
        xs = np.clip((a[0] + (b[0] - a[0]) * t).astype(int),
                     0, img.shape[1] - 1)
        ys = np.clip((a[1] + (b[1] - a[1]) * t).astype(int),
                     0, img.shape[0] - 1)
        img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * np.asarray(color)

    def _draw_box(self, img, lo, hi, color, alpha, thick=1):
        if not np.all(np.isfinite(lo)) or not np.all(np.isfinite(hi)) \
                or np.any(lo > hi):
            return
        c = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                      [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                      [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                      [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
        px, ok = self._project(c)
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                 (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        for i, j in edges:
            if ok[i] and ok[j]:
                for dx in range(thick):
                    self._line(img, px[i] + dx, px[j] + dx, color, alpha)

    def render(self, base=None):
        """(H, W, 3) f32 overlay: the reference's visualize_accel palette
        (dim all-node boxes, bright selection, white children, blue-ish
        selected primitives)."""
        cam = self.camera
        H, W = cam.screen_h, cam.screen_w
        img = (np.zeros((H, W, 3), np.float32) if base is None
               else np.asarray(base, np.float32).copy())
        level, idx = self.selected
        # every box at the selected level, dim grey (cnode .5 α .25)
        lo_all, hi_all = self.h.boxes(level)
        for i in range(lo_all.shape[0]):
            if i != idx:
                self._draw_box(img, lo_all[i], hi_all[i],
                               (0.5, 0.5, 0.5), 0.25)
        # children, white-ish (cnode_hl_child)
        nch = self.h.n_children(level, idx)
        if nch:
            clo, chi = self.h.boxes(level + 1)
            base_i = self.h.child_index(level, idx, 0)
            for c in range(nch):
                j = base_i + c
                if j < clo.shape[0]:
                    self._draw_box(img, clo[j], chi[j], (1.0, 1.0, 1.0),
                                   0.6)
        # selected primitives' edges (cprim_hl_left .6,.6,1)
        t0, t1 = self.h.tri_range(level, idx)
        tris, ok = self.h.tris[t0:t1], self.h.live[t0:t1]
        step = max(1, (t1 - t0) // 512)      # bound the draw cost
        for t in range(0, tris.shape[0], step):
            if not ok[t]:
                continue
            px, vis = self._project(tris[t])
            for i, j in ((0, 1), (1, 2), (2, 0)):
                if vis[i] and vis[j]:
                    self._line(img, px[i], px[j], (0.6, 0.6, 1.0), 1.0)
        # selection box, orange + thick (cnode_hl 1,.25,0 α .6)
        self._draw_box(img, lo_all[idx], hi_all[idx], (1.0, 0.25, 0.0),
                       0.8, thick=3)
        return img

    def status(self):
        level, idx = self.selected
        t0, t1 = self.h.tri_range(level, idx)
        names = ["root", "group", "cluster"]
        return {"level": names[level], "index": int(idx),
                "tri_rows": [int(t0), int(t1)],
                "depth": len(self.stack)}
