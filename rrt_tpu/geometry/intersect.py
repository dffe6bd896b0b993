"""Primitive intersection: batched Möller–Trumbore and sphere tests, plus a
chunked brute-force closest-hit/any-hit query.

Semantics mirror the reference exactly:

* triangles (`triangle.cpp:25-55`): s1=d×e2, s2=s×e1, denom=s1·e1,
  t = s2·e2/denom, b1 = s1·s/denom, b2 = s2·d/denom, accept when
  min_t ≤ t ≤ max_t and b0,b1,b2 ≥ 0; the shading normal is the
  *unnormalized* barycentric blend of vertex normals.
* spheres (`sphere.cpp:10-53`): quadratic with near root preferred, far
  root accepted when the origin is inside; normal = (p−c)/r.

The brute-force query is the reference's `ACCEL == 0` mode (`bvh.h:4`,
`bvh.cpp:55-57`) as a dense path: a `lax.scan` over fixed triangle chunks
bounds the working set and lets XLA fuse the whole test into vector ops; the closest hit is a running min over chunks instead
of mutable `r.max_t` narrowing.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.types import Hit, Rays, SceneData

BIG = 1e30


def tri_intersect(o, d, min_t, max_t, v0, v1, v2, valid):
    """Test rays (...,3) against a chunk of triangles (C,3).

    Returns (ok (...,C), t, b1, b2). Inputs broadcast: rays get a
    trailing chunk axis.
    """
    o = o[..., None, :]
    d = d[..., None, :]
    e1 = v1 - v0
    e2 = v2 - v0
    s = o - v0
    s1 = jnp.cross(d, e2)
    s2 = jnp.cross(s, e1)
    denom = jnp.sum(s1 * e1, axis=-1)
    # denom==0 (parallel / degenerate padded tri) is an explicit miss; the
    # safe divisor keeps reverse-mode AD free of inf·0 NaNs on masked lanes
    ok_denom = denom != 0
    inv = 1.0 / jnp.where(ok_denom, denom, 1.0)
    t = jnp.sum(s2 * e2, axis=-1) * inv
    b1 = jnp.sum(s1 * s, axis=-1) * inv
    b2 = jnp.sum(s2 * d, axis=-1) * inv
    b0 = 1.0 - b1 - b2
    ok = (
        (min_t[..., None] <= t)
        & (t <= max_t[..., None])
        & (b0 >= 0)
        & (b1 >= 0)
        & (b2 >= 0)
        & valid
        & ok_denom
    )
    return ok, t, b1, b2


def sphere_intersect(o, d, min_t, max_t, center, radius):
    """Test rays (...,3) against spheres (S,3)/(S,).

    Returns (ok (...,S), t) with the reference's near-then-far root
    acceptance (sphere.cpp:26-53).
    """
    # dead rows (radius <= 0 — the build pads centers at 1e30) would put
    # c at f32 inf and disc at inf - inf = NaN; the forward masks stay
    # correct but reverse-mode's 0·NaN poisons the padded rows' center
    # gradients. Substitute a benign center for dead rows — the `where`
    # also routes their gradient to an exact zero.
    live = radius > 0
    center = jnp.where(live[..., None], center,
                       jnp.zeros_like(center))
    tmp = o[..., None, :] - center
    b = 2.0 * jnp.sum(tmp * d[..., None, :], axis=-1)
    c = jnp.sum(tmp * tmp, axis=-1) - radius * radius
    disc = b * b - 4.0 * c
    has = disc >= 0
    # safe sqrt: masked lanes (disc<0) otherwise produce NaN cotangents,
    # and d√disc → ∞ at disc → 0⁺ (grazing) poisons reverse-mode even
    # under zero cotangents — treat near-tangent as the exact-tangent
    # limit √disc = 0
    pos = disc > 1e-24
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    ok1 = (min_t[..., None] <= t1) & (t1 <= max_t[..., None])
    ok2 = (min_t[..., None] <= t2) & (t2 <= max_t[..., None])
    t = jnp.where(ok1, t1, t2)
    ok = has & (ok1 | ok2) & (radius > 0)
    return ok, t


def closest_hit_brute(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    min_t: jnp.ndarray,
    max_t: jnp.ndarray,
    chunk: int = 512,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit over all primitives by chunked scan.

    Returns (hit, t, prim_id, b1, b2) where prim_id indexes triangles first
    then spheres (scene flat primitive space); b1/b2 are barycentrics for
    triangle hits (zero for spheres).
    """
    n_t = scene.n_tris
    chunk = min(chunk, n_t)
    while n_t % chunk != 0:   # rows are padded to a multiple of 64
        chunk //= 2
    assert chunk >= 1, "triangle count must be chunk-padded"
    n_chunks = n_t // chunk

    shape = o.shape[:-1]
    init = (
        jnp.full(shape, jnp.inf, o.dtype),          # best t
        jnp.full(shape, -1, jnp.int32),             # best prim
        jnp.zeros(shape, o.dtype),                  # b1
        jnp.zeros(shape, o.dtype),                  # b2
    )

    tri_valid = scene.tri_bsdf >= 0

    def body(carry, ci):
        bt, bp, bb1, bb2 = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, ci * chunk, chunk)
        ok, t, b1, b2 = tri_intersect(
            o, d, min_t, max_t,
            sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2),
            sl(tri_valid),
        )
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
        better = tj < bt
        take = lambda a: jnp.take_along_axis(a, j[..., None], axis=-1)[..., 0]
        return (
            jnp.where(better, tj, bt),
            jnp.where(better, (ci * chunk + j).astype(jnp.int32), bp),
            jnp.where(better, take(b1), bb1),
            jnp.where(better, take(b2), bb2),
        ), None

    (bt, bp, bb1, bb2), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks), unroll=1)

    # spheres (S is tiny; single dense pass)
    ok, t = sphere_intersect(
        o, d, min_t, max_t, scene.sph_center, scene.sph_radius)
    ok = ok & (scene.sph_bsdf >= 0)
    t = jnp.where(ok, t, jnp.inf)
    j = jnp.argmin(t, axis=-1)
    tj = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
    better = tj < bt
    bt = jnp.where(better, tj, bt)
    bp = jnp.where(better, (n_t + j).astype(jnp.int32), bp)
    bb1 = jnp.where(better, 0.0, bb1)
    bb2 = jnp.where(better, 0.0, bb2)

    hit = jnp.isfinite(bt)
    # measured work (reference total_isects analog): brute tests every
    # lane against every primitive; no bbox culling exists on this path
    n_lanes = float(np.prod(shape)) if shape else 1.0
    stats = jnp.array([n_lanes * (n_t + scene.sph_center.shape[0]), 0.0],
                      jnp.float32)
    return hit, jnp.where(hit, bt, max_t), bp, bb1, bb2, stats


def closest_hit_cluster(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    min_t: jnp.ndarray,
    max_t: jnp.ndarray,
    tile: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit with per-tile cluster culling — the XLA analog of the
    reference's hierarchical BVH traversal (`bvh.cpp:115-138`) and of the
    Pallas kernel's dense two-level scheme.

    Rays are processed in tiles of `tile` lanes (`lax.map`, sequential);
    per tile a `lax.scan` over Morton cluster AABBs slab-tests the whole
    tile and `lax.cond`-skips clusters no ray touches, so the triangle
    work scales with touched clusters instead of scene size. Same outputs
    as `closest_hit_brute`.
    """
    cs = scene.cluster_size
    K = scene.cluster_lo.shape[0]
    tri_valid = scene.tri_bsdf >= 0

    shape = o.shape[:-1]
    n = int(np.prod(shape)) if shape else 1
    n_pad = -(-max(n, 1) // tile) * tile
    flat = lambda a, w: jnp.reshape(a, (-1,) + ((w,) if w else ()))
    pad = lambda a: jnp.pad(a, ((0, n_pad - n),) + ((0, 0),) * (a.ndim - 1))
    o_f = pad(flat(o, 3)).reshape(-1, tile, 3)
    d_f = pad(flat(d, 3)).reshape(-1, tile, 3)
    mn_f = pad(flat(min_t, 0)).reshape(-1, tile)
    # padded lanes get max_t = -inf: they can never hit anything
    mx_f = jnp.pad(flat(max_t, 0), ((0, n_pad - n),),
                   constant_values=-jnp.inf).reshape(-1, tile)

    def per_tile(args):
        ot, dt_, mnt, mxt = args
        safe_d = jnp.where(jnp.abs(dt_) < 1e-20, 1e-20, dt_)
        inv = 1.0 / safe_d

        def body(carry, k):
            bt, bp, bb1, bb2, ni = carry
            lo = scene.cluster_lo[k]
            hi = scene.cluster_hi[k]
            t0 = (lo - ot) * inv
            t1 = (hi - ot) * inv
            tmn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tmx = jnp.min(jnp.maximum(t0, t1), axis=-1)
            # cap by the best hit so far: narrower than max_t once a
            # closer hit exists (the r.max_t narrowing of the reference)
            cap = jnp.minimum(mxt, bt)
            reach = (tmn <= tmx) & (tmx >= mnt) & (tmn <= cap) & (
                cap >= mnt)

            def do(c):
                bt, bp, bb1, bb2, ni = c
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, k * cs, cs)
                ok, t, b1, b2 = tri_intersect(
                    ot, dt_, mnt, mxt,
                    sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2),
                    sl(tri_valid))
                t = jnp.where(ok, t, jnp.inf)
                j = jnp.argmin(t, axis=-1)
                take = lambda a: jnp.take_along_axis(
                    a, j[..., None], axis=-1)[..., 0]
                tj = take(t)
                better = tj < bt
                return (
                    jnp.where(better, tj, bt),
                    jnp.where(better, (k * cs + j).astype(jnp.int32), bp),
                    jnp.where(better, take(b1), bb1),
                    jnp.where(better, take(b2), bb2),
                    ni + float(tile * cs),
                )

            carry = jax.lax.cond(jnp.any(reach), do, lambda c: c, carry)
            return carry, None

        init = (
            jnp.full((tile,), jnp.inf, o.dtype),
            jnp.full((tile,), -1, jnp.int32),
            jnp.zeros((tile,), o.dtype),
            jnp.zeros((tile,), o.dtype),
            jnp.float32(0.0),
        )
        (bt, bp, bb1, bb2, ni), _ = jax.lax.scan(body, init, jnp.arange(K))

        # spheres (S is tiny; single dense pass)
        ok, t = sphere_intersect(
            ot, dt_, mnt, mxt, scene.sph_center, scene.sph_radius)
        ok = ok & (scene.sph_bsdf >= 0)
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, (scene.n_tris + j).astype(jnp.int32), bp)
        bb1 = jnp.where(better, 0.0, bb1)
        bb2 = jnp.where(better, 0.0, bb2)
        ni = ni + float(tile * scene.sph_center.shape[0])
        # per-tile measured work: executed clusters × cs prim tests per
        # lane (ni) + the dense K-cluster slab sweep every lane pays
        return bt, bp, bb1, bb2, jnp.stack([ni, jnp.float32(tile * K)])

    bt, bp, bb1, bb2, st = jax.lax.map(per_tile, (o_f, d_f, mn_f, mx_f))
    unflat = lambda a: a.reshape(-1)[:n].reshape(shape)
    stats = jnp.sum(st, axis=0)
    bt, bp, bb1, bb2 = unflat(bt), unflat(bp), unflat(bb1), unflat(bb2)
    hit = jnp.isfinite(bt)
    return hit, jnp.where(hit, bt, max_t), bp, bb1, bb2, stats


def closest_hit_shortlist(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    min_t: jnp.ndarray,
    max_t: jnp.ndarray,
    tile: int = 128,
    m_clusters: int = 8,
    tile_chunk: int = 64,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit via per-tile cluster *shortlists* — dense, branchless,
    fully vectorized XLA (no Pallas, no `lax.cond`).

    The reference walks a pointer BVH per ray (`bvh.cpp:115-138`). The
    dense formulation here:

      1. every `tile`-lane ray tile slab-tests all K Morton-cluster AABBs
         at once (one dense (tile, K) test, any-reduced over lanes);
      2. each tile's touched cluster ids are compacted front-first (one
         argsort over K) — its traversal *shortlist*;
      3. a `while_loop` drains shortlists `m_clusters` clusters per round:
         gather those clusters' triangle rows and run one dense
         (tile × m·cs) Möller–Trumbore batch, running-min merged. Rounds
         stop when the longest shortlist in the tile-chunk is drained, so
         coherent chunks pay 1-2 rounds regardless of scene size.

    Tiles are processed `tile_chunk` at a time under `lax.map` to bound
    intermediates (the (TC, tile, m·cs) test tensor). Compared to
    `closest_hit_cluster` this replaces per-cluster `lax.cond` skipping
    (branchy, serial, slow to compile) with dense gathers sized by what
    the tile actually touches — the XLA-native version of BVH culling.
    """
    cs = scene.cluster_size
    K = scene.cluster_lo.shape[0]
    M = min(m_clusters, K)
    n_t = scene.n_tris
    tri_valid = scene.tri_bsdf >= 0

    # one extra EMPTY cluster at index K: padding target for short rounds
    pad_rows = cs
    v0p = jnp.concatenate([scene.tri_v0, jnp.zeros((pad_rows, 3), o.dtype)])
    v1p = jnp.concatenate([scene.tri_v1, jnp.zeros((pad_rows, 3), o.dtype)])
    v2p = jnp.concatenate([scene.tri_v2, jnp.zeros((pad_rows, 3), o.dtype)])
    validp = jnp.concatenate([tri_valid, jnp.zeros((pad_rows,), bool)])

    shape = o.shape[:-1]
    n = int(np.prod(shape)) if shape else 1
    lanes = tile_chunk * tile
    n_pad = -(-max(n, 1) // lanes) * lanes
    flat = lambda a, w: jnp.reshape(a, (-1,) + ((w,) if w else ()))
    pad = lambda a: jnp.pad(a, ((0, n_pad - n),) + ((0, 0),) * (a.ndim - 1))
    o_f = pad(flat(o, 3)).reshape(-1, tile_chunk, tile, 3)
    d_f = pad(flat(d, 3)).reshape(-1, tile_chunk, tile, 3)
    mn_f = pad(flat(min_t, 0)).reshape(-1, tile_chunk, tile)
    # padded lanes get max_t = -inf: they can never touch anything
    mx_f = jnp.pad(flat(max_t, 0), ((0, n_pad - n),),
                   constant_values=-jnp.inf).reshape(-1, tile_chunk, tile)

    # shortlist slots padded so every dynamic_slice stays in bounds
    n_rounds = -(-K // M)
    K_slots = n_rounds * M

    def per_chunk(args):
        ot, dt_, mnt, mxt = args                 # (TC, tile, 3) / (TC, tile)
        # chunk-level early-out: a chunk whose lanes are ALL masked
        # (mxt < mnt — dead/padded) skips phase 1 + rounds entirely. The
        # curved-trace loop masks resolved lanes this way, and lanes
        # resolve in spatially-clustered groups, so late segments cost
        # only the chunks still carrying live lanes.
        any_live = jnp.any(mxt >= mnt)
        return jax.lax.cond(any_live, _chunk_run, _chunk_skip,
                            (ot, dt_, mnt, mxt))

    def _chunk_skip(args):
        return (jnp.full((tile_chunk, tile), jnp.inf, o.dtype),
                jnp.full((tile_chunk, tile), -1, jnp.int32),
                jnp.zeros((tile_chunk, tile), o.dtype),
                jnp.zeros((tile_chunk, tile), o.dtype),
                jnp.zeros(2, jnp.float32))

    def _chunk_run(args):
        ot, dt_, mnt, mxt = args
        safe_d = jnp.where(jnp.abs(dt_) < 1e-20, 1e-20, dt_)
        inv = 1.0 / safe_d

        # ---- phase 1: dense per-lane reach, any-reduced to tile level
        lo = scene.cluster_lo                    # (K, 3)
        hi = scene.cluster_hi
        t0 = (lo[None, None] - ot[:, :, None, :]) * inv[:, :, None, :]
        t1 = (hi[None, None] - ot[:, :, None, :]) * inv[:, :, None, :]
        tmn = jnp.max(jnp.minimum(t0, t1), axis=-1)      # (TC, tile, K)
        tmx = jnp.min(jnp.maximum(t0, t1), axis=-1)
        reach = ((tmn <= tmx) & (tmx >= mnt[..., None])
                 & (tmn <= mxt[..., None]) & (mxt >= mnt)[..., None])
        touched = jnp.any(reach, axis=1)                 # (TC, K)

        # ---- phase 2: compact touched ids front-first, in Morton order
        count = jnp.sum(touched, axis=-1)                # (TC,)
        ark = jnp.arange(K, dtype=jnp.int32)
        sort_key = jnp.where(touched, ark, K + ark)
        ids = jnp.argsort(sort_key, axis=-1).astype(jnp.int32)  # (TC, K)
        ids = jnp.pad(ids, ((0, 0), (0, K_slots - K)),
                      constant_values=K)
        count_max = jnp.max(count)

        arc = jnp.arange(cs, dtype=jnp.int32)
        arm = jnp.arange(M, dtype=jnp.int32)

        # ---- phase 3: drain shortlists M clusters per round
        def cond(c):
            r = c[0]
            return r * M < count_max

        def body(c):
            r, bt, bp, bb1, bb2, ni = c
            ids_r = jax.lax.dynamic_slice(
                ids, (jnp.int32(0), r * M), (tile_chunk, M))
            slot_ok = (r * M + arm)[None, :] < count[:, None]
            cl_ids = jnp.where(slot_ok, ids_r, K)        # (TC, M)
            tri_idx = (cl_ids[:, :, None] * cs + arc[None, None, :]
                       ).reshape(tile_chunk, M * cs)     # (TC, C)
            mx_eff = jnp.minimum(mxt, bt)
            ok, t, b1, b2 = tri_intersect(
                ot, dt_, mnt, mx_eff,
                v0p[tri_idx][:, None], v1p[tri_idx][:, None],
                v2p[tri_idx][:, None], validp[tri_idx][:, None])
            t = jnp.where(ok, t, jnp.inf)
            j = jnp.argmin(t, axis=-1)                   # (TC, tile)
            take = lambda a: jnp.take_along_axis(
                a, j[..., None], axis=-1)[..., 0]
            tj = take(t)
            better = tj < bt
            pj = jnp.take_along_axis(tri_idx, j, axis=-1)
            return (r + 1,
                    jnp.where(better, tj, bt),
                    jnp.where(better, pj, bp),
                    jnp.where(better, take(b1), bb1),
                    jnp.where(better, take(b2), bb2),
                    ni + float(tile_chunk * tile * M * cs))

        init = (jnp.int32(0),
                jnp.full((tile_chunk, tile), jnp.inf, o.dtype),
                jnp.full((tile_chunk, tile), -1, jnp.int32),
                jnp.zeros((tile_chunk, tile), o.dtype),
                jnp.zeros((tile_chunk, tile), o.dtype),
                jnp.float32(0.0))
        _, bt, bp, bb1, bb2, ni = jax.lax.while_loop(cond, body, init)

        # ---- spheres (S is tiny; single dense pass)
        ok, t = sphere_intersect(
            ot, dt_, mnt, mxt, scene.sph_center, scene.sph_radius)
        ok = ok & (scene.sph_bsdf >= 0)
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, (n_t + j).astype(jnp.int32), bp)
        bb1 = jnp.where(better, 0.0, bb1)
        bb2 = jnp.where(better, 0.0, bb2)
        # measured work per chunk: shortlist rounds × M·cs prim tests per
        # lane + S spheres (ni) + the dense K-cluster slab reach all lanes
        # pay in phase 1 — the XLA analog of the kernel's nisect/ncull
        ni = ni + float(tile_chunk * tile * scene.sph_center.shape[0])
        return bt, bp, bb1, bb2, jnp.stack(
            [ni, jnp.float32(tile_chunk * tile * K)])

    bt, bp, bb1, bb2, st = jax.lax.map(per_chunk, (o_f, d_f, mn_f, mx_f))
    unflat = lambda a: a.reshape(-1)[:n].reshape(shape)
    stats = jnp.sum(st, axis=0)
    bt, bp, bb1, bb2 = unflat(bt), unflat(bp), unflat(bb1), unflat(bb2)
    hit = jnp.isfinite(bt)
    return hit, jnp.where(hit, bt, max_t), bp, bb1, bb2, stats


def trace_chords_shortlist(
    scene: SceneData,
    so_all: jnp.ndarray,      # (S, n, 3) chord origins per segment
    sd_all: jnp.ndarray,      # (S, n, 3) chord unit directions
    slen_all: jnp.ndarray,    # (S, n)   chord lengths
    s_rank: jnp.ndarray,      # (S, n)   per-lane ASCENDING testable seg ids
    count_t: jnp.ndarray,     # (n,)     number of valid entries in s_rank
    n_seg: int,
    tile: int = 128,
    m_clusters: int = 1,
    drain: int = 4,
    tile_chunk: int = 64,
    max_ranks: Optional[int] = None,
):
    """First-hit over per-lane chord sequences — the curved-trace engine.

    Each lane owns an ascending list of *testable* chords (its micro-ray
    segments whose chord touches scene geometry bounds); the first chord
    containing a hit wins (bvh.cpp:103-113 first-event order). All loops
    live INSIDE one `lax.map` chunk so every bound is chunk-local:

      * rank loop: chunk iterates to ITS OWN max testable count — chunks
        of early-resolving lanes stop after a couple of chords while
        straggler (orbiting/wrapped) chunks run longer, instead of every
        lane paying the global maximum;
      * per rank, the per-tile cluster shortlist is sorted NEAR-TO-FAR by
        tile entry-t, and the round loop exits as soon as no lane can
        still improve on its current best (every remaining cluster starts
        beyond every live lane's closest hit) — the dense analog of
        ordered BVH descent with r.max_t narrowing (bvh.cpp:115-138);
      * spheres are tested before the rounds so their t narrows the
        cluster drain too.

    Returns flat (found, t, prim, b1, b2, seg_o, seg_d, seg_id).
    """
    cs = scene.cluster_size
    K = scene.cluster_lo.shape[0]
    n_t = scene.n_tris
    n = count_t.shape[0]
    dt = so_all.dtype
    tri_valid = scene.tri_bsdf >= 0

    # Shortlist GRANULE = a supergroup of `m_clusters` Morton-contiguous
    # clusters (one gather-free triangle slab of m·cs rows). In-box chords
    # are short (≈ distance·Δθ) and touch only 1-3 granules, so the
    # per-lane slab phase costs lanes×G pairs with G ≈ K/m instead of
    # lanes×K for per-cluster reach at equal triangle-round size.
    G = -(-K // m_clusters)                    # number of granules
    rows = m_clusters * cs                     # triangle rows per granule
    big = jnp.asarray(3e37, dt)
    pad_k = G * m_clusters - K
    clo = jnp.concatenate(
        [scene.cluster_lo, jnp.full((pad_k, 3), big, dt)], axis=0)
    chi = jnp.concatenate(
        [scene.cluster_hi, jnp.full((pad_k, 3), -big, dt)], axis=0)
    g_lo = clo.reshape(G, m_clusters, 3).min(axis=1)     # (G, 3)
    g_hi = chi.reshape(G, m_clusters, 3).max(axis=1)

    T_pad = G * rows
    v0p = jnp.concatenate(
        [scene.tri_v0, jnp.zeros((T_pad + rows - n_t, 3), dt)])
    v1p = jnp.concatenate(
        [scene.tri_v1, jnp.zeros((T_pad + rows - n_t, 3), dt)])
    v2p = jnp.concatenate(
        [scene.tri_v2, jnp.zeros((T_pad + rows - n_t, 3), dt)])
    validp = jnp.concatenate(
        [tri_valid, jnp.zeros((T_pad + rows - n_t,), bool)])

    lanes = tile_chunk * tile
    n_pad = -(-max(n, 1) // lanes) * lanes
    nc = n_pad // lanes

    def pad_seg(a):
        """(S, n, ...) → (nc, S, TC, tile, ...) chunk-major layout.

        S is taken from the array: the rank table may carry fewer rows
        than the chord tables (compacted continuation phases)."""
        w = a.shape[2:]
        a = jnp.pad(a, ((0, 0), (0, n_pad - n)) + ((0, 0),) * len(w))
        a = a.reshape((a.shape[0], nc, tile_chunk, tile) + w)
        return jnp.moveaxis(a, 1, 0)

    so_c = pad_seg(so_all)
    sd_c = pad_seg(sd_all)
    sl_c = pad_seg(slen_all)
    rk_c = pad_seg(s_rank)
    cnt_c = jnp.pad(count_t, (0, n_pad - n)).reshape(
        nc, tile_chunk, tile)

    arg = jnp.arange(G, dtype=jnp.int32)
    arr_rows = jnp.arange(rows, dtype=jnp.int32)
    ard = jnp.arange(drain, dtype=jnp.int32)
    n_rounds = -(-G // drain)
    G_slots = n_rounds * drain
    INF = jnp.asarray(jnp.inf, dt)

    def per_chunk(args):
        so_k, sd_k, sl_k, rk_k, cnt = args
        local_max = jnp.max(cnt)
        if max_ranks is not None:
            local_max = jnp.minimum(local_max, max_ranks)

        def one_rank(j, pos, nd, clen, act):
            """Best hit on the active lanes' current chords ([0, clen])."""
            mnt = jnp.zeros((tile_chunk, tile), dt)
            mxt = jnp.where(act, clen, -1.0)
            safe_d = jnp.where(jnp.abs(nd) < 1e-20, 1e-20, nd)
            inv = 1.0 / safe_d

            # spheres first: their t narrows the cluster drain
            okS, tS = sphere_intersect(
                pos, nd, mnt, mxt, scene.sph_center, scene.sph_radius)
            okS = okS & (scene.sph_bsdf >= 0)
            tS = jnp.where(okS, tS, jnp.inf)
            jS = jnp.argmin(tS, axis=-1)
            bt = jnp.take_along_axis(tS, jS[..., None], axis=-1)[..., 0]
            bp = jnp.where(jnp.isfinite(bt),
                           (n_t + jS).astype(jnp.int32), -1)
            bb1 = jnp.zeros((tile_chunk, tile), dt)
            bb2 = jnp.zeros((tile_chunk, tile), dt)

            # per-lane granule reach, folded into a SINGLE min-reduction
            # over lanes: ent[tile_row, granule] = nearest entry-t of any
            # lane (+inf if none reaches). One paired sort yields the
            # near-to-far shortlist AND its entry keys.
            t0 = (g_lo[None, None] - pos[:, :, None, :]) * inv[:, :, None, :]
            t1 = (g_hi[None, None] - pos[:, :, None, :]) * inv[:, :, None, :]
            tmn = jnp.max(jnp.minimum(t0, t1), axis=-1)   # (TC, tile, G)
            tmx = jnp.min(jnp.maximum(t0, t1), axis=-1)
            reach = ((tmn <= tmx) & (tmx >= mnt[..., None])
                     & (tmn <= mxt[..., None]) & (mxt >= mnt)[..., None])
            ent = jnp.min(
                jnp.where(reach, jnp.maximum(tmn, 0.0), INF), axis=1)
            count = jnp.sum(jnp.isfinite(ent), axis=-1)
            ent_sorted, order = jax.lax.sort(
                (ent, jnp.broadcast_to(arg[None], ent.shape)),
                dimension=-1, num_keys=1)
            ids = jnp.pad(order.astype(jnp.int32),
                          ((0, 0), (0, G_slots - G + 1)),
                          constant_values=G)
            ent_sorted = jnp.pad(ent_sorted,
                                 ((0, 0), (0, G_slots - G + 1)),
                                 constant_values=jnp.inf)
            count_max = jnp.max(count)

            def r_cond(c):
                r, improv = c[0], c[1]
                return (r * drain < count_max) & improv

            def r_body(c):
                r, _, bt, bp, bb1, bb2, ni = c
                g_r = jax.lax.dynamic_slice(
                    ids, (jnp.int32(0), r * drain), (tile_chunk, drain))
                slot_ok = (r * drain + ard)[None, :] < count[:, None]
                g_id = jnp.where(slot_ok, g_r, G)         # (TC, drain)
                tri_idx = (g_id[:, :, None] * rows
                           + arr_rows[None, None, :rows]
                           ).reshape(tile_chunk, drain * rows)
                mx_eff = jnp.minimum(mxt, bt)
                ok, t, b1, b2 = tri_intersect(
                    pos, nd, mnt, mx_eff,
                    v0p[tri_idx][:, None], v1p[tri_idx][:, None],
                    v2p[tri_idx][:, None], validp[tri_idx][:, None])
                t = jnp.where(ok, t, jnp.inf)
                jj = jnp.argmin(t, axis=-1)
                take = lambda a: jnp.take_along_axis(
                    a, jj[..., None], axis=-1)[..., 0]
                tj = take(t)
                better = tj < bt
                pj = jnp.take_along_axis(tri_idx, jj, axis=-1)
                bt = jnp.where(better, tj, bt)
                bp = jnp.where(better, pj, bp)
                bb1 = jnp.where(better, take(b1), bb1)
                bb2 = jnp.where(better, take(b2), bb2)
                # can any lane still improve? every remaining granule
                # starts at ent_sorted[:, (r+1)·drain] or later (sorted),
                # so a tile is done once that entry exceeds all its
                # lanes' best-so-far.
                nxt = jax.lax.dynamic_slice(
                    ent_sorted, (jnp.int32(0), (r + 1) * drain),
                    (tile_chunk, 1))
                improv = jnp.any(bt > nxt)
                return (r + 1, improv, bt, bp, bb1, bb2,
                        ni + float(tile_chunk * tile * drain * rows))

            improv0 = count_max > 0
            # measured work this rank: S spheres per lane now, then
            # drain·rows prim tests per lane per executed round (ni); every
            # lane pays the dense G-granule slab reach (ncull)
            ni0 = jnp.float32(
                tile_chunk * tile * scene.sph_center.shape[0])
            _, _, bt, bp, bb1, bb2, ni = jax.lax.while_loop(
                r_cond, r_body,
                (jnp.int32(0), improv0, bt, bp, bb1, bb2, ni0))
            hit = jnp.isfinite(bt) & (bp >= 0)
            stats = jnp.stack([ni, jnp.float32(tile_chunk * tile * G)])
            return hit, jnp.where(hit, bt, 0.0), bp, bb1, bb2, stats

        def j_cond(c):
            j, found = c[0], c[1]
            return (j < local_max) & jnp.any(~found & (j < cnt))

        def j_body(c):
            (j, found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, nst) = c
            sj = jax.lax.dynamic_index_in_dim(rk_k, j, 0, keepdims=False)
            gat = lambda a: jnp.take_along_axis(
                a, sj.reshape((1,) + sj.shape + (1,) * (a.ndim - 3)),
                axis=0)[0]
            pos = gat(so_k)
            nd = gat(sd_k)
            clen = gat(sl_k)
            act = ~found & (j < cnt)

            def run(_):
                return one_rank(j, pos, nd, clen, act)

            def skip(_):
                z = jnp.zeros((tile_chunk, tile), dt)
                return (jnp.zeros((tile_chunk, tile), bool), z,
                        jnp.full((tile_chunk, tile), -1, jnp.int32), z, z,
                        jnp.zeros(2, jnp.float32))

            hit, t, pid, b1, b2, rst = jax.lax.cond(
                jnp.any(act), run, skip, None)
            new = hit & act
            upd = lambda cur, v: jnp.where(new, v, cur)
            upd3 = lambda cur, v: jnp.where(new[..., None], v, cur)
            return (j + 1, found | new,
                    upd(t_b, t), upd(prim_b, pid), upd(b1_b, b1),
                    upd(b2_b, b2), upd3(so_b, pos), upd3(sd_b, nd),
                    upd(seg_b, sj), nst + rst)

        z = jnp.zeros((tile_chunk, tile), dt)
        init = (jnp.int32(0), jnp.zeros((tile_chunk, tile), bool),
                z, jnp.full((tile_chunk, tile), -1, jnp.int32), z, z,
                jnp.zeros((tile_chunk, tile, 3), dt),
                jnp.zeros((tile_chunk, tile, 3), dt),
                jnp.full((tile_chunk, tile), n_seg, jnp.int32),
                jnp.zeros(2, jnp.float32))
        st = jax.lax.while_loop(j_cond, j_body, init)
        (_, found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, nst) = st
        return found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, nst

    outs = jax.lax.map(per_chunk, (so_c, sd_c, sl_c, rk_c, cnt_c))
    unflat = lambda a: a.reshape((-1,) + a.shape[3:])[:n]
    return tuple(unflat(a) for a in outs[:-1]) + (
        jnp.sum(outs[-1], axis=0),)


def closest_hit(scene, o, d, min_t, max_t, chunk: int = 512,
                accel: str = "auto", return_stats: bool = False):
    """Dispatch between the culled and brute closest-hit queries.

    accel: "shortlist" = per-tile cluster shortlists, dense + branchless
    (default when cluster tables exist), "cluster" = per-cluster
    `lax.cond` scan (legacy), "brute" = dense chunked scan (also the
    reverse-AD-friendly choice for tiny batches), "auto" picks shortlist
    when cluster tables are available.

    return_stats=True appends a (2,) f32 of measured work counters
    [prim tests paid, bbox tests paid] — same accounting as the Pallas
    kernel's nisect/ncull (the reference's total_isects, bvh.h:140)."""
    if accel == "auto":
        accel = "shortlist" if scene.cluster_lo is not None else "brute"
    if accel == "shortlist":
        out = closest_hit_shortlist(scene, o, d, min_t, max_t)
    elif accel == "cluster":
        out = closest_hit_cluster(scene, o, d, min_t, max_t)
    else:
        out = closest_hit_brute(scene, o, d, min_t, max_t, chunk)
    return out if return_stats else out[:5]


def build_hit(scene: SceneData, o, d, hit, t, prim_id, b1, b2) -> Hit:
    """Gather shading data for resolved hits (Intersection fields,
    reference triangle.cpp:46-52 / sphere.cpp:32-47)."""
    n_t = scene.n_tris
    is_tri = prim_id < n_t
    tid = jnp.clip(prim_id, 0, n_t - 1)
    sid = jnp.clip(prim_id - n_t, 0, scene.n_spheres - 1)

    b0 = 1.0 - b1 - b2
    n_tri = (
        b0[..., None] * scene.tri_n0[tid]
        + b1[..., None] * scene.tri_n1[tid]
        + b2[..., None] * scene.tri_n2[tid]
    )
    # missed lanes keep t = max_t (possibly inf); anchor their hit point at
    # the origin so masked downstream math (and its AD) stays finite
    t_safe = jnp.where(hit, t, 0.0)
    p = o + t_safe[..., None] * d
    n_sph = (p - scene.sph_center[sid]) / scene.sph_radius[sid][..., None]
    n = jnp.where(is_tri[..., None], n_tri, n_sph)
    bsdf = jnp.where(is_tri, scene.tri_bsdf[tid], scene.sph_bsdf[sid])
    bsdf = jnp.where(hit, bsdf, -1)
    return Hit(
        hit=hit,
        t=t,
        p=p,
        n=n,
        w_out=-d,
        prim_id=jnp.where(hit, prim_id, -1),
        bsdf_id=bsdf,
    )
