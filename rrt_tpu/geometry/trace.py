"""Curved-space trace: geodesic micro-ray marching fused with closest-hit.

This is the batched reformulation of the architectural hook at
`bvh.cpp:103-113`: every ray (camera / bounce / shadow) is marched as up to
⌈2π/Δθ⌉ chord segments; per segment the reference (1) advances the geodesic,
(2) kills the path on event-horizon absorption, (3) runs a full BVH
traversal of the chord and stops at the first segment containing a hit.

Reference semantics faithfully kept:
  * the original ray's min_t/max_t are DISCARDED — each chord carries its
    own [0, chord_len] range (so camera near/far clip and shadow-ray
    distance limits have no effect in curved mode);
  * absorption beats closer geometry within the same segment;
  * rays that march a full 2π without an event are treated as escaped;
  * escaped rays keep their ORIGINAL direction for env-map lookups
    (part1_code.cpp:106-107) — callers use `rays.d`, not the bent
    direction.

Three implementations share these semantics: the fused Triton kernel
(ops/trace_kernel.py, the default on a GPU: per-ray early exit inside a
block, no chord table in memory), the XLA march-once path
(`trace_curved_marched`, any platform), and the segment-group fold
(`trace_curved`, which folds `seg_group` segments into the batch axis and
can run all groups under `lax.scan`; with `accel="brute"` it is the
brute-force reference).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.geometry.intersect import (build_hit, closest_hit,
                                        sphere_intersect, tri_intersect)
from rrt_tpu.physics import schwarzschild as ss
from rrt_tpu.types import BlackHoleParams, Hit, Rays, SceneData


def trace_flat(scene: SceneData, rays: Rays, chunk: int = 512,
               accel: str = "auto", return_stats: bool = False):
    """Straight-ray closest hit honoring min_t/max_t (new capability:
    the reference cannot disable curvature)."""
    hit, t, pid, b1, b2, stats = closest_hit(
        scene, rays.o, rays.d, rays.min_t, rays.max_t, chunk, accel,
        return_stats=True)
    h = build_hit(scene, rays.o, rays.d, hit, t, pid, b1, b2)
    if return_stats:
        return h, stats
    return h


def trace_curved(
    scene: SceneData,
    bh: BlackHoleParams,
    rays: Rays,
    seg_group: int = 9,
    chunk: int = 512,
    early_exit: bool = True,
    n_seg: int = None,
    accel: str = "auto",
    return_seg: bool = False,
) -> Hit:
    """Micro-ray marched closest hit (bvh.cpp:103-113 semantics).

    `early_exit=True` uses a `lax.while_loop` over segment groups (fast,
    not reverse-differentiable); `early_exit=False` runs all groups under
    `lax.scan` so `jax.grad` can flow through the geodesic chords (for
    d(image)/d(black-hole mass/position)).

    `n_seg` (static) must be given when `bh.delta_theta` is traced (e.g.
    when differentiating w.r.t. it); otherwise it is derived from the
    concrete value.
    """
    if n_seg is None:
        n_seg = ss.n_segments(float(bh.delta_theta))
    n_groups = -(-n_seg // seg_group)

    shape = rays.o.shape[:-1]
    dt = rays.o.dtype

    def seg_scan(carry, _):
        pos, dirn, dead = carry
        new_dir, chord, step_dead = ss.micro_step(pos, dirn, bh)
        dead = dead | step_dead
        chord = jnp.where(dead, 0.0, chord)
        new_pos = pos + new_dir * chord[..., None]
        absorbed = ss.absorbed_by_hole(pos, new_dir, chord, bh) & ~dead
        return (new_pos, new_dir, dead), (pos, new_dir, chord, absorbed, dead)

    # resolved state per ray
    init = dict(
        pos=rays.o,
        dirn=rays.d,
        dead=jnp.zeros(shape, bool),
        done=jnp.zeros(shape, bool),        # event found (hit or absorbed)
        absorbed=jnp.zeros(shape, bool),
        t=jnp.zeros(shape, dt),
        prim=jnp.full(shape, -1, jnp.int32),
        b1=jnp.zeros(shape, dt),
        b2=jnp.zeros(shape, dt),
        seg_o=rays.o,                        # winning chord origin/direction
        seg_d=rays.d,
        seg=jnp.full(shape, n_seg, jnp.int32),  # winning segment index
        group=jnp.array(0, jnp.int32),
    )

    def cond(st):
        return (st["group"] < n_groups) & ~jnp.all(st["done"] | st["dead"])

    def body(st):
        g = seg_group
        (pos, dirn, dead), (so, sd, slen, sabs, sdead) = jax.lax.scan(
            seg_scan, (st["pos"], st["dirn"], st["dead"]), None, length=g)
        # fold segments into the batch axis for one dense intersection pass
        hit, t, pid, b1, b2 = closest_hit(
            scene, so, sd,
            jnp.zeros_like(slen), slen, chunk, accel)
        # first event (absorption-before-hit within a segment:
        # absorption wins, bvh.cpp:107-109)
        event = (hit | sabs) & ~sdead                      # (g, ...)
        idx = jnp.argmax(event, axis=0)                    # first True
        any_event = jnp.any(event, axis=0)

        def sel(a):
            """Pick a[idx] along the segment axis (works for scalars and
            trailing-3 vectors)."""
            ix = idx.reshape(idx.shape + (1,) * (a.ndim - 1 - idx.ndim))
            ix = jnp.broadcast_to(ix[None], (1,) + a.shape[1:])
            return jnp.take_along_axis(a, ix, axis=0)[0]
        new_done = any_event & ~st["done"]
        upd = lambda cur, new: jnp.where(new_done, new, cur)
        upd3 = lambda cur, new: jnp.where(new_done[..., None], new, cur)
        return dict(
            pos=pos,
            dirn=dirn,
            dead=dead,
            done=st["done"] | any_event,
            absorbed=upd(st["absorbed"], sel(sabs)),
            t=upd(st["t"], sel(t)),
            prim=upd(st["prim"], sel(pid)),
            b1=upd(st["b1"], sel(b1)),
            b2=upd(st["b2"], sel(b2)),
            seg_o=upd3(st["seg_o"], sel(so)),
            seg_d=upd3(st["seg_d"], sel(sd)),
            seg=upd(st["seg"],
                    st["group"] * seg_group + idx.astype(jnp.int32)),
            group=st["group"] + 1,
        )

    if early_exit:
        st = jax.lax.while_loop(cond, body, init)
    else:
        st, _ = jax.lax.scan(
            lambda s, _: (body(s), None), init, None, length=n_groups)

    ok = st["done"] & ~st["absorbed"]
    hit = build_hit(
        scene, st["seg_o"], st["seg_d"], ok, st["t"], st["prim"],
        st["b1"], st["b2"])
    if return_seg:
        return hit, st["seg"]
    return hit


@jax.custom_vjp
def _grad_guard(x):
    """Identity whose COTANGENT is sanitized: NaN/inf scrubbed and
    clipped. Near-wrap geodesic chords are chaotic — their parameter
    Jacobians legitimately overflow f32 — and one poisoned lane would NaN
    the whole psum'd parameter gradient. Forward values untouched."""
    return x


def _grad_guard_fwd(x):
    return x, None


def _grad_guard_bwd(_, ct):
    ct = jnp.nan_to_num(ct, nan=0.0, posinf=0.0, neginf=0.0)
    return (jnp.clip(ct, -1e3, 1e3),)


_grad_guard.defvjp(_grad_guard_fwd, _grad_guard_bwd)


def _morton7(v):
    """Spread the low 7 bits of int32 v three apart (21-bit Morton)."""
    v = v & 0x7F
    v = (v | (v << 8)) & 0x0700F
    v = (v | (v << 4)) & 0x430C3
    v = (v | (v << 2)) & 0x49249
    return v


def _scene_bbox(scene: SceneData):
    """Global bbox of triangles ∪ live spheres."""
    if scene.cluster_lo is not None:
        glo_t = jnp.min(scene.cluster_lo, axis=0)
        ghi_t = jnp.max(scene.cluster_hi, axis=0)
    else:
        valid = (scene.tri_bsdf >= 0)[:, None]
        big = jnp.asarray(3e37, scene.tri_v0.dtype)
        mins = jnp.minimum(jnp.minimum(scene.tri_v0, scene.tri_v1),
                           scene.tri_v2)
        maxs = jnp.maximum(jnp.maximum(scene.tri_v0, scene.tri_v1),
                           scene.tri_v2)
        glo_t = jnp.min(jnp.where(valid, mins, big), axis=0)
        ghi_t = jnp.max(jnp.where(valid, maxs, -big), axis=0)
    live = (scene.sph_radius > 0) & (scene.sph_bsdf >= 0)
    big = jnp.asarray(3e37, glo_t.dtype)
    slo = jnp.where(live[:, None],
                    scene.sph_center - scene.sph_radius[:, None], big)
    shi = jnp.where(live[:, None],
                    scene.sph_center + scene.sph_radius[:, None], -big)
    return (jnp.minimum(glo_t, jnp.min(slo, axis=0)),
            jnp.maximum(ghi_t, jnp.max(shi, axis=0)))


def should_sort(n_lanes: int, n_clusters: int) -> bool:
    """Lane-sort gate: the (octant, origin-Morton) sort pays only when
    per-block culling has clusters to skip AND the batch amortizes the
    argsort."""
    return n_lanes >= 2048 and n_clusters >= 32


def lane_order(scene: SceneData, o, d):
    """Permutation grouping flat (n, 3) lanes by direction octant, then
    origin Morton cell, or None where `should_sort` says it does not pay.
    Both traversals (the XLA shortlist and the fused kernel) use it."""
    if scene.cluster_lo is None or not should_sort(
            o.shape[0], scene.cluster_lo.shape[0]):
        return None
    glo, ghi = _scene_bbox(scene)
    ext = jnp.where(ghi > glo, ghi - glo, 1.0)
    q = jnp.clip(((o - glo) / ext) * 127.0, 0.0, 127.0).astype(jnp.int32)
    m = _morton7(q[:, 0]) << 2 | _morton7(q[:, 1]) << 1 | _morton7(q[:, 2])
    octant = ((d[:, 0] < 0).astype(jnp.int32) * 4
              + (d[:, 1] < 0).astype(jnp.int32) * 2
              + (d[:, 2] < 0).astype(jnp.int32))
    return jnp.argsort(octant * (1 << 21) + m)


# chord storage per lane is n_seg·7 f32 ≈ 1.7 KB; one slab bounds the
# phase-A tables (~1.8 GB at 1M lanes) regardless of caller batch size
LANE_SLAB = 1 << 20


def trace_curved_marched(
    scene: SceneData,
    bh: BlackHoleParams,
    rays: Rays,
    n_seg: int,
    chunk: int = 512,
    accel: str = "auto",
    return_seg: bool = False,
    return_stats: bool = False,
):
    """Lane-slab wrapper over `_trace_curved_marched_slab`: giant batches
    (NEE chunks can reach lanes × ns_area_light) are processed LANE_SLAB
    lanes at a time under `lax.map` so the march-once chord tables never
    exceed ~2 GB. Lanes are independent, so results are identical."""
    shape = rays.o.shape[:-1]
    n = int(np.prod(shape)) if shape else 1
    if n <= LANE_SLAB:
        return _trace_curved_marched_slab(scene, bh, rays, n_seg, chunk,
                                          accel, return_seg, return_stats)
    flat = Rays(o=rays.o.reshape(-1, 3), d=rays.d.reshape(-1, 3),
                min_t=rays.min_t.reshape(-1), max_t=rays.max_t.reshape(-1))
    n_pad = -(-n // LANE_SLAB) * LANE_SLAB
    pad1 = lambda a: jnp.pad(a, (0, n_pad - n)).reshape(-1, LANE_SLAB)
    pad3 = lambda a: jnp.pad(a, ((0, n_pad - n), (0, 0))).reshape(
        -1, LANE_SLAB, 3)
    batched = Rays(o=pad3(flat.o),
                   d=pad3(jnp.where(jnp.abs(flat.d) < 1e-20, 1.0, flat.d)),
                   min_t=pad1(flat.min_t),
                   max_t=jnp.pad(flat.max_t, (0, n_pad - n),
                                 constant_values=-1.0).reshape(
                       -1, LANE_SLAB))

    def one(rs):
        return _trace_curved_marched_slab(scene, bh, rs, n_seg, chunk,
                                          accel, True, True)

    h, seg, st = jax.lax.map(one, batched)
    cut = lambda a: a.reshape((-1,) + a.shape[2:])[:n].reshape(
        shape + a.shape[2:])
    h = jax.tree_util.tree_map(cut, h)
    seg = cut(seg)
    stats = jnp.sum(st, axis=0)
    out = (h,)
    if return_seg:
        out = out + (seg,)
    if return_stats:
        out = out + (stats,)
    return out if len(out) > 1 else h


def _trace_curved_marched_slab(
    scene: SceneData,
    bh: BlackHoleParams,
    rays: Rays,
    n_seg: int,
    chunk: int = 512,
    accel: str = "auto",
    return_seg: bool = False,
    return_stats: bool = False,
):
    """Micro-ray marched closest hit, march-once formulation (the XLA
    path; ops/trace_kernel.py fuses the same semantics on a GPU).

    The grouped fold in `trace_curved` tests EVERY chord of every group
    for every lane: a batch with escaped lanes never early-exits and pays
    all ⌈2π/Δθ⌉ full traversals. Here:

      phase A: one cheap `lax.scan` marches all chords and records only
        BOOLEAN facts per (segment, lane): event-horizon absorption,
        degenerate death, and whether the chord touches the global scene
        bbox. From these: `end_seg` (first absorb/death — geometry may
        only land strictly earlier, bvh.cpp:107-108), and `last_touch`
        (the last bbox-touching segment — nothing can hit after it, even
        through wrapped-chord re-entry).
      phase B: a `while_loop` re-marches the chords one segment at a time
        (identical FP ops — bit-identical chords) and runs ONE masked
        closest-hit per segment, `lax.cond`-skipped entirely when no lane
        is active. Lanes deactivate the moment they hit, die, absorb, or
        pass their last touching segment, so the loop runs to
        max(last_touch) only over still-testable lanes instead of 2π for
        everyone.
    """
    shape = rays.o.shape[:-1]
    o = rays.o.reshape(-1, 3)
    d = rays.d.reshape(-1, 3)
    n_real = o.shape[0]
    dt = o.dtype
    glo, ghi = _scene_bbox(scene)
    # Pad the lanes to whole 128-lane tiles with lanes that die on their
    # first step (origin at the hole's centre). Every real lane is then
    # computed by the same vectorized code whatever the batch size, so its
    # result does not depend on its batch (sharded == unsharded, bit for
    # bit, also for chaotic wrapped lanes). Cut off on return.
    pad = (-n_real) % 128
    if pad:
        o = jnp.concatenate(
            [o, jnp.broadcast_to(jnp.asarray(bh.position, dt), (pad, 3))])
        d = jnp.concatenate(
            [d, jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dt),
                                 (pad, 3))])
    n = o.shape[0]

    # Lanes are sorted once per trace by (direction octant, origin Morton
    # cell): the shortlist traversal culls per 128-lane tile, and lanes
    # that resolve together leave whole chunks dead for the chunk-level
    # early-out. The permutation is undone on return.
    perm = lane_order(scene, o, d)
    sort = perm is not None
    if sort:
        o = o[perm]
        d = d[perm]

    # Coarse culling boxes for the phase-A chord test. The global scene
    # bbox is uselessly coarse for a Cornell box: its interior is empty
    # (walls are thin), yet every interior-crossing chord "touches" it,
    # which keeps the phase-B loop hot for rays that can never hit
    # anything. Testing against per-16-cluster SUPERCLUSTER boxes (≈28
    # for a 28.6k-triangle mesh) instead collapses that to the handful of chords that pass near actual
    # geometry. Live spheres contribute one union box.
    boxes = []
    if scene.cluster_lo is not None:
        SB = 16
        K = scene.cluster_lo.shape[0]
        n_sup = -(-K // SB)
        big = jnp.asarray(3e37, dt)
        clo = jnp.concatenate(
            [scene.cluster_lo,
             jnp.full((n_sup * SB - K, 3), big, dt)], axis=0)
        chi = jnp.concatenate(
            [scene.cluster_hi,
             jnp.full((n_sup * SB - K, 3), -big, dt)], axis=0)
        sup_lo = clo.reshape(n_sup, SB, 3).min(axis=1)
        sup_hi = chi.reshape(n_sup, SB, 3).max(axis=1)
        for k in range(n_sup):
            boxes.append((sup_lo[k], sup_hi[k]))
        live = (scene.sph_radius > 0) & (scene.sph_bsdf >= 0)
        slo = jnp.where(live[:, None],
                        scene.sph_center - scene.sph_radius[:, None], big)
        shi = jnp.where(live[:, None],
                        scene.sph_center + scene.sph_radius[:, None], -big)
        boxes.append((jnp.min(slo, axis=0), jnp.max(shi, axis=0)))
    else:
        boxes.append((glo, ghi))

    def chord_touch(pos, nd, clen):
        px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
        sd2 = jnp.where(jnp.abs(nd) < 1e-20, 1e-20, nd)
        ivx = 1.0 / sd2[..., 0]
        ivy = 1.0 / sd2[..., 1]
        ivz = 1.0 / sd2[..., 2]
        touch = jnp.zeros(px.shape, bool)
        for lo_b, hi_b in boxes:
            tx0 = (lo_b[0] - px) * ivx
            tx1 = (hi_b[0] - px) * ivx
            ty0 = (lo_b[1] - py) * ivy
            ty1 = (hi_b[1] - py) * ivy
            tz0 = (lo_b[2] - pz) * ivz
            tz1 = (hi_b[2] - pz) * ivz
            tmn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                          jnp.minimum(ty0, ty1)),
                              jnp.minimum(tz0, tz1))
            tmx = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                          jnp.maximum(ty0, ty1)),
                              jnp.maximum(tz0, tz1))
            touch = touch | ((tmn <= tmx) & (tmx >= 0.0) & (tmn <= clen))
        return touch

    def seg_scan(carry, _):
        pos, dirn, dead = carry
        nd, clen, sdead = ss.micro_step(pos, dirn, bh)
        dead = dead | sdead
        clen = jnp.where(dead, 0.0, clen)
        npos = pos + nd * clen[..., None]
        absorbed = ss.absorbed_by_hole(pos, nd, clen, bh) & ~dead
        touch = chord_touch(pos, nd, clen) & ~dead
        return (npos, nd, dead), (pos, nd, clen, absorbed, dead, touch)

    # chords are STORED, not re-marched in phase B: a second compilation
    # of the same FP ops can fuse differently, and wrapped (u<=0 teleport)
    # chords amplify any f32 difference chaotically. (n_seg, n, 7) f32 ≈
    # 0.5 GB at the renderer's max pass size — cheap next to exactness.
    zeros_b = jnp.zeros((n,), bool)
    _, (so_all, sd_all, slen_all, sabs, sdead, stouch) = jax.lax.scan(
        seg_scan, (o, d, zeros_b), None, length=n_seg, unroll=4)

    evt = sabs | sdead                           # (S, n); dead is monotone
    any_evt = jnp.any(evt, axis=0)
    first_evt = jnp.argmax(evt, axis=0).astype(jnp.int32)
    end_seg = jnp.where(any_evt, first_evt, n_seg)
    absorbed = any_evt & jnp.take_along_axis(
        sabs, first_evt[None], axis=0)[0]
    s_ix = jnp.arange(n_seg, dtype=jnp.int32)[:, None]
    testable = stouch & (s_ix < end_seg[None])   # (S, n)
    count_t = jnp.sum(testable, axis=0).astype(jnp.int32)   # (n,)

    # Per-lane ascending list of testable segment ids. Phase B iterates j
    # over each lane's j-th TESTABLE segment (rank-major, not
    # segment-major): most lanes hit on their first or second testable
    # chord, so nearly all lanes deactivate within a few full-width
    # iterations; stragglers (wrapped/grazing lanes with long testable
    # lists) ride out the tail masked, where the chunk-level early-out in
    # closest_hit_shortlist skips their dead neighbors. First-event order
    # is preserved: each lane's own segments are visited ascending.
    s_rank = jnp.argsort(
        jnp.where(testable, s_ix, n_seg + s_ix), axis=0).astype(jnp.int32)

    if scene.cluster_lo is not None:
        from rrt_tpu.geometry.intersect import trace_chords_shortlist

        (found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, tstats) = \
            trace_chords_shortlist(scene, so_all, sd_all, slen_all,
                                   s_rank, count_t, n_seg)
        # lanes whose winning chord was never set keep the ORIGINAL ray
        # (escaped lanes read the envmap with rays.d, part1_code.cpp:106)
        so_b = jnp.where(found[:, None], so_b, o)
        sd_b = jnp.where(found[:, None], sd_b, d)
    else:
        max_count = jnp.max(count_t)

        def cond(c):
            j, found = c[0], c[1]
            return (j < max_count) & jnp.any(~found & (j < count_t))

        def body(c):
            (j, found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, nst) = c
            sj = jax.lax.dynamic_index_in_dim(s_rank, j, 0, keepdims=False)
            gat = lambda a: jnp.take_along_axis(
                a, sj.reshape((1,) + sj.shape + (1,) * (a.ndim - 2)),
                axis=0)[0]
            pos = gat(so_all)
            nd = gat(sd_all)
            clen = gat(slen_all)
            act = ~found & (j < count_t)
            hit, t, pid, b1, b2, rst = closest_hit(
                scene, pos, nd, jnp.zeros((n,), dt),
                jnp.where(act, clen, -1.0), chunk, accel,
                return_stats=True)
            new = hit & act
            upd = lambda cur, v: jnp.where(new, v, cur)
            upd3 = lambda cur, v: jnp.where(new[..., None], v, cur)
            return (j + 1, found | new,
                    upd(t_b, t), upd(prim_b, pid), upd(b1_b, b1),
                    upd(b2_b, b2), upd3(so_b, pos), upd3(sd_b, nd),
                    upd(seg_b, sj), nst + rst)

        init = (jnp.int32(0), zeros_b,
                jnp.zeros((n,), dt), jnp.full((n,), -1, jnp.int32),
                jnp.zeros((n,), dt), jnp.zeros((n,), dt), o, d,
                jnp.full((n,), n_seg, jnp.int32),
                jnp.zeros(2, jnp.float32))
        st = jax.lax.while_loop(cond, body, init)
        (_, found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b, tstats) = st

    if sort:
        inv_perm = jnp.argsort(perm)
        unp = lambda a: a[inv_perm]
        found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b = (
            unp(found), unp(t_b), unp(prim_b), unp(b1_b), unp(b2_b),
            unp(so_b), unp(sd_b), unp(seg_b))

    cut = lambda a: a[:n_real]
    found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b = map(
        cut, (found, t_b, prim_b, b1_b, b2_b, so_b, sd_b, seg_b))
    hit = build_hit(scene, so_b, sd_b, found, t_b, prim_b, b1_b, b2_b)
    seg = seg_b
    if shape != found.shape:
        hit = jax.tree_util.tree_map(
            lambda a: a.reshape(shape + a.shape[1:]), hit)
        seg = seg.reshape(shape)
    out = (hit,)
    if return_seg:
        out = out + (seg,)
    if return_stats:
        out = out + (tstats,)
    return out if len(out) > 1 else hit


def _resolve_backend(backend: str) -> str:
    """"auto" is the fused kernel on a CUDA GPU and the XLA path elsewhere;
    "pallas" where the kernel cannot compile is an error."""
    from rrt_tpu.ops.trace_kernel import kernel_available
    if backend == "auto":
        return "pallas" if kernel_available() else "xla"
    if backend == "pallas" and not kernel_available():
        raise ValueError(
            "trace backend 'pallas' needs a CUDA GPU; this platform is "
            f"{jax.default_backend()!r} (use 'auto' or 'xla')")
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown trace backend {backend!r}")
    return backend


def _trace_sharded(scene, bh, rays, chunk, seg_group, early_exit, n_seg,
                   backend, accel, return_stats, occlusion,
                   mesh, axis):
    """Device-mesh trace: `shard_map` over the lane axis.

    Closest-hit is embarrassingly parallel per lane — the only cross-lane
    machinery is the coherence lane sort, a pure perf heuristic. Under
    GSPMD, the traversal's internal (lanes) → (tiles, 128) reshapes cross
    shard boundaries and emit all-gather/collective-permute chains
    (hundreds of collectives on an 8-device mesh).
    Running the WHOLE per-shard trace inside `shard_map` makes every
    reshape, sort and tile loop shard-local by construction: the compiled
    program's only collective is one (2,)-psum of the work counters.

    Lanes are padded to a multiple of the mesh size with immediately-
    terminating rays (origin at the hole in curved mode — dead on
    segment 1; max_t < min_t in flat mode), exactly the renderer's
    masked-lane convention. Results are bit-identical to the unsharded
    trace because every per-lane result is independent of its batch.
    """
    from jax.sharding import PartitionSpec as P

    nb = rays.min_t.ndim              # lane axis is the LAST batch dim
    n = rays.min_t.shape[-1]
    ndev = mesh.shape[axis]
    pad = (-n) % ndev
    dt = rays.o.dtype
    if pad:
        curved = bh is not None and getattr(bh, "enabled", True)
        po = jnp.asarray(bh.position, dt) if curved \
            else jnp.zeros(3, dt)

        def cat(a, fill):
            ps = a.shape[:nb - 1] + (pad,) + a.shape[nb:]
            return jnp.concatenate(
                [a, jnp.broadcast_to(jnp.asarray(fill, dt), ps)],
                axis=nb - 1)

        rays = Rays(o=cat(rays.o, po),
                    d=cat(rays.d, jnp.array([1.0, 0.0, 0.0], dt)),
                    min_t=cat(rays.min_t, 0.0),
                    max_t=cat(rays.max_t, -1.0))

    def lspec(leaf):
        parts = [None] * leaf.ndim
        parts[nb - 1] = axis
        return P(*parts)

    ray_specs = jax.tree_util.tree_map(lspec, rays)
    repl = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)

    def local(sc, b, r):
        h, st = trace(sc, b, r, chunk, seg_group, early_exit, n_seg,
                      backend, accel, return_stats=True,
                      occlusion=occlusion)
        return h, jax.lax.psum(st, axis)

    hit_spec = Hit(hit=lspec(rays.min_t), t=lspec(rays.min_t),
                   p=lspec(rays.o), n=lspec(rays.o), w_out=lspec(rays.o),
                   prim_id=lspec(rays.min_t), bsdf_id=lspec(rays.min_t))
    # check_vma off: the traversal's while_loop carries mix replicated
    # constants into per-shard state, which the varying-axes checker
    # can't type; correctness holds (outputs are per-lane + one psum)
    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(repl(scene), repl(bh), ray_specs),
                      out_specs=(hit_spec, P()), check_vma=False)
    h, st = f(scene, bh, rays)
    if pad:
        cut = lambda a: jax.lax.slice_in_dim(a, 0, n, axis=nb - 1)
        h = jax.tree_util.tree_map(cut, h)
    if return_stats:
        return h, st
    return h


def trace(scene: SceneData, bh: BlackHoleParams, rays: Rays,
          chunk: int = 512, seg_group: int = 9,
          early_exit: bool = True, n_seg: int = None,
          backend: str = "auto", accel: str = "auto",
          return_stats: bool = False,
          occlusion: bool = False, mesh=None, lane_axis: str = "batch"):
    """Dispatch on the (static) curvature flag and backend.

    backend: "pallas" = the fused Triton kernel (ops/trace_kernel.py, CUDA
    GPUs only), "xla" = composed XLA ops (any platform), "auto" = pallas
    on a GPU, xla elsewhere. Differentiable renders go through
    `trace_diff`, which uses this trace only for its detached discrete
    decisions.

    mesh/lane_axis: when a multi-device `jax.sharding.Mesh` is given, the
    trace runs under `shard_map` over the lane axis so every tile reshape
    and sort stays shard-local (see `_trace_sharded`).

    return_stats=True additionally returns a (2,) f32 of measured work
    counters [primitive tests paid, bbox slab tests paid] summed over
    lanes — the reference's total_isects analog (bvh.h:140). Both the
    kernel and the XLA paths measure them (the legacy seg-group fold,
    early_exit=False, reports zeros).
    """
    backend = _resolve_backend(backend)
    if mesh is not None and lane_axis not in mesh.shape \
            and len(mesh.axis_names) == 1:
        lane_axis = mesh.axis_names[0]   # 1-D mesh: use its axis name
    if mesh is not None and mesh.shape.get(lane_axis, 1) > 1 \
            and rays.min_t.shape[-1] >= mesh.shape[lane_axis]:
        if n_seg is None:
            n_seg = ss.n_segments(float(bh.delta_theta)) if (
                bh is not None and bh.enabled) else 1
        return _trace_sharded(scene, bh, rays, chunk, seg_group,
                              early_exit, n_seg, backend, accel,
                              return_stats, occlusion,
                              mesh, lane_axis)
    if backend == "pallas":
        from rrt_tpu.ops.trace_kernel import pallas_trace
        if n_seg is None:
            n_seg = ss.n_segments(float(bh.delta_theta)) if (
                bh is not None and bh.enabled) else 1
        return pallas_trace(scene, bh, rays, n_seg=n_seg,
                            return_stats=return_stats, occlusion=occlusion)
    if bh is not None and bh.enabled:
        if n_seg is None:
            n_seg = ss.n_segments(float(bh.delta_theta))
        if early_exit:
            out = trace_curved_marched(scene, bh, rays, n_seg, chunk,
                                       accel, return_stats=return_stats)
            return out if return_stats else out
        h = trace_curved(scene, bh, rays, seg_group, chunk, early_exit,
                         n_seg, accel)
        if return_stats:
            return h, jnp.zeros(2, jnp.float32)
        return h
    return trace_flat(scene, rays, chunk, accel, return_stats=return_stats)


def trace_with_seg(scene: SceneData, bh: BlackHoleParams, rays: Rays,
                   n_seg: int = None, backend: str = "auto",
                   chunk: int = 512, seg_group: int = 9):
    """Closest hit plus the winning micro-segment index per ray (n_seg for
    rays with no geometry event). Used by the differentiable
    reconstruction below."""
    curved = bh is not None and bh.enabled
    backend = _resolve_backend(backend)
    if n_seg is None:
        n_seg = ss.n_segments(float(bh.delta_theta)) if curved else 1
    if backend == "pallas":
        from rrt_tpu.ops.trace_kernel import pallas_trace
        return pallas_trace(scene, bh, rays, n_seg=n_seg, return_seg=True)
    if curved:
        return trace_curved_marched(scene, bh, rays, n_seg, chunk,
                                    return_seg=True)
    h = trace_flat(scene, rays, chunk)
    return h, jnp.zeros(h.t.shape, jnp.int32)


def trace_diff(scene: SceneData, bh: BlackHoleParams, rays: Rays,
               n_seg: int = None, backend: str = "auto",
               chunk: int = 512) -> Hit:
    """Differentiable closest hit: fast discrete primal + continuous
    reconstruction.

    The discrete structure (winning primitive, winning segment, hit/absorb
    masks) comes from the non-differentiable fast path (the fused kernel
    on a GPU) under stop_gradient; the continuous payload is then
    RE-DERIVED differentiably: the geodesic march is replayed as a
    `lax.scan` (cheap — no intersections) to get the winning chord as a
    function of the black-hole parameters, and only the ONE winning
    primitive per ray is re-intersected. Gradients flow through chord
    geometry → t/p/n → shading exactly as in the monolithic XLA autodiff
    path, at a tiny fraction of its cost (which brute-forced rays × tris ×
    segments through reverse mode).

    Matches the AD decomposition promised in SURVEY §7: detached discrete
    decisions, reparameterized continuous factors. Visibility gradients
    remain out of scope.
    """
    curved = bh is not None and bh.enabled
    if n_seg is None:
        n_seg = ss.n_segments(float(bh.delta_theta)) if curved else 1
    sg = lambda t: jax.tree_util.tree_map(jax.lax.stop_gradient, t)
    h0, seg = trace_with_seg(sg(scene), sg(bh), sg(rays),
                             n_seg=n_seg, backend=backend, chunk=chunk)
    hitm = h0.hit
    prim = h0.prim_id
    shape = h0.t.shape

    if curved:
        # winning segment; lanes without a hit need no chord at all (their
        # payload is the original ray, like the non-differentiable trace)
        sgc = jnp.where(hitm, jnp.clip(seg, 0, n_seg - 1), 0)
        o0 = jax.lax.stop_gradient(rays.o)
        d0 = jax.lax.stop_gradient(rays.d)

        # Replay the march differentiably; collect every chord's (o, d).
        # Past its winning segment a lane's steps are discarded, and they
        # are evaluated on the lane's detached first ray instead of its
        # frozen state: marched further (wrapped chords at 1e9 scale,
        # absorbed lanes inside the horizon) a lane can reach inf, and an
        # inf forward value poisons the backward pass with NaN even under
        # zero cotangents, whatever the compiler's float modes.
        def step(c, s):
            pos, dirn, dead = c
            past = (s > sgc)[..., None]
            nd, clen, sdead = ss.micro_step(jnp.where(past, o0, pos),
                                            jnp.where(past, d0, dirn), bh)
            # Teleport (u<=0 wrap) chords: freeze the AD chain. The wrap
            # region is chaotic — Jacobians through consecutive 1e9-scale
            # chords explode (and overflow f32 to inf/NaN in reverse
            # mode), so d(image)/d(bh params) through a wrapped path is
            # numerically meaningless noise. Forward values are
            # untouched; lanes whose winning chord precedes their first
            # wrap keep exact gradients.
            wrapped = jax.lax.stop_gradient(clen) > 50.0
            nd = jnp.where(wrapped[..., None],
                           jax.lax.stop_gradient(nd), nd)
            clen = jnp.where(wrapped, jax.lax.stop_gradient(clen), clen)
            # catch-all for sub-threshold chaos: sanitize the cotangents
            # flowing back through each chord (see _grad_guard)
            nd = _grad_guard(nd)
            clen = _grad_guard(clen)
            dead = dead | sdead
            clen = jnp.where(dead | (s >= sgc), 0.0, clen)
            nxt = _grad_guard(pos + nd * clen[..., None])
            return (nxt, nd, dead), (pos, nd)
        (_, _, _), (so_all, sd_all) = jax.lax.scan(
            step, (rays.o, rays.d, jnp.zeros(shape, bool)),
            jnp.arange(n_seg))
        ix = sgc[None, ..., None]
        so = jnp.take_along_axis(
            so_all, jnp.broadcast_to(ix, (1,) + shape + (3,)), axis=0)[0]
        sd = jnp.take_along_axis(
            sd_all, jnp.broadcast_to(ix, (1,) + shape + (3,)), axis=0)[0]
    else:
        so, sd = rays.o, rays.d

    # re-intersect only the winning primitive, differentiably
    n_t = scene.n_tris
    is_tri = hitm & (prim >= 0) & (prim < n_t)
    is_sph = hitm & (prim >= n_t)
    tid = jnp.clip(prim, 0, n_t - 1)
    sid = jnp.clip(prim - n_t, 0, scene.n_spheres - 1)
    neg = jnp.full(shape, -jnp.inf, h0.t.dtype)
    pos_inf = jnp.full(shape, jnp.inf, h0.t.dtype)
    okT, tT, b1, b2 = tri_intersect(
        so, sd, neg, pos_inf,
        scene.tri_v0[tid][..., None, :],
        scene.tri_v1[tid][..., None, :],
        scene.tri_v2[tid][..., None, :],
        jnp.ones(shape + (1,), bool))
    okS, tS = sphere_intersect(
        so, sd, jnp.zeros_like(neg), pos_inf,
        scene.sph_center[sid][..., None, :],
        scene.sph_radius[sid][..., None])
    t = jnp.where(is_tri, tT[..., 0], jnp.where(is_sph, tS[..., 0], 0.0))
    b1 = jnp.clip(jnp.where(is_tri, b1[..., 0], 0.0), 0.0, 1.0)
    b2 = jnp.clip(jnp.where(is_tri, b2[..., 0], 0.0), 0.0, 1.0)
    b2 = jnp.minimum(b2, 1.0 - b1)
    return build_hit(scene, so, sd, hitm, t, prim, b1, b2)


def occluded(scene: SceneData, bh: BlackHoleParams, rays: Rays,
             chunk: int = 512, seg_group: int = 9,
             early_exit: bool = True, n_seg: int = None,
             backend: str = "auto", return_stats: bool = False,
             mesh=None, lane_axis: str = "batch"):
    """Shadow query: does `bvh->intersect(ray)` report a hit?

    Note the reference quirks this inherits: in curved mode the shadow
    ray's distance-to-light max_t is ignored (chords carry their own
    ranges), and a path absorbed by the hole reports NO occlusion
    (bvh.cpp:107-108 returns false).

    Occlusion is purely discrete (a bool), so inputs are detached from
    autodiff unconditionally — this keeps the fast early-exit while-loop
    usable under `jax.grad` (visibility gradients are out of scope).
    """
    sg = lambda t: jax.tree_util.tree_map(jax.lax.stop_gradient, t)
    # any-hit: shadow queries consume only the hit bool, so the kernel
    # may stop refining a lane at its FIRST geometry hit (the closest-t
    # same-segment rescans across parts vanish; absorption-beats-geometry
    # ordering is preserved because absorption still seeds the segment
    # bound, bvh.cpp:107-108)
    out = trace(sg(scene), sg(bh), sg(rays), chunk, seg_group, early_exit,
                n_seg, backend, return_stats=return_stats,
                occlusion=True, mesh=mesh,
                lane_axis=lane_axis)
    if return_stats:
        h, st = out
        return h.hit, st
    return out.hit
