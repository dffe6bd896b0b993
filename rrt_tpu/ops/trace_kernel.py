"""Fused trace kernel for NVIDIA GPUs: geodesic march + closest hit.

Pallas through Triton (`backend="triton"`). One program owns a block of
LANES rays and carries their whole trace in registers:

  * the Schwarzschild march (`physics/schwarzschild.micro_step`, the same
    float32 operations in the same order) advances every lane one chord per
    iteration; a lane stops at its first event (hit, absorption by the
    horizon, a degenerate step) and the block stops when all of its lanes
    have, or after ⌈2π/Δθ⌉ chords. No chord table is written to memory;
  * each iteration tests the block's live chords against the scene through
    a box hierarchy kept in device memory (and so in L1/L2):
    a root box, GROUP clusters per group box, TILE Morton-consecutive
    triangles per cluster box. A box is entered when ANY live lane's chord [0, len]
    (capped by that lane's best hit so far) reaches it, a per-block
    decision; a cluster's triangles are tested as one (LANES, TILE)
    Möller–Trumbore tile (`geometry/intersect.tri_intersect`'s arithmetic);
  * spheres (the scene's live prefix) are tested before triangles so that
    their hits narrow the box tests;
  * flat mode is the same kernel with one chord: the ray with its own
    [min_t, max_t]; `occlusion` stops refining a lane at its first hit.

Outputs per lane: the winning chord (origin, direction), chord-local t,
primitive id, barycentrics, winning segment index (n_seg when no hit), a
hit/absorbed flag and two work counters (primitive tests and box tests
paid while the lane was live), summed by the wrapper into the (2,) stats
that `Renderer.stats()` reports.

Blocks are independent and run in any order; nothing is carried between
them. `interpret=True` runs the same kernel through the Pallas interpreter
on the CPU (tests only).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rrt_tpu.geometry.intersect import build_hit
from rrt_tpu.types import BlackHoleParams, Rays, SceneData

LANES = 32       # rays per program (power of two; 32 measured fastest
                 # of 32/64/128 on an H100, PERF.md)
TILE = 16        # triangles per cluster: one (LANES, TILE) test tile
GROUP = 16       # clusters per group box
NUM_WARPS = 4
BIG = 3e37
# conservative box padding: boxes may only ever be too large, so culling
# never drops a hit the triangle test would accept
_BOX_PAD = 1e-6

def kernel_available() -> bool:
    """The compiled kernel exists for CUDA GPUs only."""
    return jax.default_backend() == "gpu"


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The kernel's static table shapes for one scene (host-side view,
    also walked by utils/accel_walk.py)."""
    n_tris: int          # triangle rows incl. padding to a TILE multiple
    n_clusters: int      # TILE-triangle clusters incl. padding to GROUP
    n_groups: int

    @classmethod
    def of(cls, n_tri_rows: int) -> "Hierarchy":
        t = -(-max(n_tri_rows, 1) // TILE) * TILE
        k = -(-(t // TILE) // GROUP) * GROUP
        return cls(n_tris=t, n_clusters=k, n_groups=k // GROUP)


def _boxes(lo, hi):
    """Pad valid boxes outward; empty ones (lo > hi) become a point at
    +BIG, which fails every slab test (an inverted box would pass the
    min/max form)."""
    empty = jnp.any(lo > hi, axis=-1, keepdims=True)
    pad = _BOX_PAD * (1.0 + jnp.maximum(jnp.abs(lo), jnp.abs(hi)))
    lo = jnp.where(empty, BIG, lo - pad)
    hi = jnp.where(empty, BIG, hi + pad)
    return jnp.concatenate([lo.T, hi.T], axis=0)          # (6, n)


def build_tables(scene: SceneData):
    """Device tables: triangles (10, T) as v0, e1, e2, valid rows;
    cluster boxes (6, K); group boxes (6, G + 1), the last the root box
    around all triangles; spheres (4, S)."""
    h = Hierarchy.of(scene.n_tris)
    dt = jnp.float32
    v0 = jnp.asarray(scene.tri_v0, dt)
    e1 = jnp.asarray(scene.tri_v1, dt) - v0
    e2 = jnp.asarray(scene.tri_v2, dt) - v0
    valid = scene.tri_bsdf >= 0
    pad = h.n_tris - scene.n_tris
    tri = jnp.concatenate(
        [v0.T, e1.T, e2.T, valid.astype(dt)[None]], axis=0)
    tri = jnp.pad(tri, ((0, 0), (0, pad)))
    vmin = jnp.minimum(jnp.minimum(scene.tri_v0, scene.tri_v1),
                       scene.tri_v2).astype(dt)
    vmax = jnp.maximum(jnp.maximum(scene.tri_v0, scene.tri_v1),
                       scene.tri_v2).astype(dt)
    kpad = ((0, h.n_clusters * TILE - scene.n_tris), (0, 0))
    vmin = jnp.pad(jnp.where(valid[:, None], vmin, BIG), kpad,
                   constant_values=BIG)
    vmax = jnp.pad(jnp.where(valid[:, None], vmax, -BIG), kpad,
                   constant_values=-BIG)
    c_lo = vmin.reshape(h.n_clusters, TILE, 3).min(axis=1)
    c_hi = vmax.reshape(h.n_clusters, TILE, 3).max(axis=1)
    g_lo = c_lo.reshape(h.n_groups, GROUP, 3).min(axis=1)
    g_hi = c_hi.reshape(h.n_groups, GROUP, 3).max(axis=1)
    # the last column is the root: the union of every group
    g_lo = jnp.concatenate([g_lo, g_lo.min(axis=0, keepdims=True)])
    g_hi = jnp.concatenate([g_hi, g_hi.max(axis=0, keepdims=True)])
    live = (scene.sph_radius > 0) & (scene.sph_bsdf >= 0)
    sph = jnp.concatenate(
        [jnp.asarray(scene.sph_center, dt).T,
         jnp.where(live, scene.sph_radius, 0.0).astype(dt)[None]], axis=0)
    return tri, _boxes(c_lo, c_hi), _boxes(g_lo, g_hi), sph


def _any(x):
    return jnp.max(x.astype(jnp.int32)) > 0


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _kernel(par_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            mn_ref, mx_ref, tri_ref, cbox_ref, gbox_ref, sph_ref,
            t_ref, b1_ref, b2_ref, sox_ref, soy_ref, soz_ref,
            sdx_ref, sdy_ref, sdz_ref, prim_ref, seg_ref, flag_ref,
            nprim_ref, nbox_ref,
            *, curved: bool, n_seg: int, n_groups: int, n_sph: int,
            n_tri_rows: int, occlusion: bool):
    f32, i32 = jnp.float32, jnp.int32
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    R = ox.shape[0]
    inf = jnp.full((R,), jnp.inf, f32)
    zeros = jnp.zeros((R,), f32)
    izeros = jnp.zeros((R,), i32)
    col = jax.lax.broadcasted_iota(i32, (R, TILE), 1)
    # par: hole x, y, z, radius, Δθ, cos Δθ, sin Δθ, unused
    bpx, bpy, bpz = par_ref[0], par_ref[1], par_ref[2]
    br, bdt, cdt, sdt = par_ref[3], par_ref[4], par_ref[5], par_ref[6]

    def slab(box_ref, k, px, py, pz, ix, iy, iz, tmin, cap):
        """Per-lane: does the chord [tmin, cap] reach box k?"""
        tx0 = (box_ref[0, k] - px) * ix
        tx1 = (box_ref[3, k] - px) * ix
        ty0 = (box_ref[1, k] - py) * iy
        ty1 = (box_ref[4, k] - py) * iy
        tz0 = (box_ref[2, k] - pz) * iz
        tz1 = (box_ref[5, k] - pz) * iz
        tmn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                      jnp.minimum(ty0, ty1)),
                          jnp.minimum(tz0, tz1))
        tmx = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                      jnp.maximum(ty0, ty1)),
                          jnp.maximum(tz0, tz1))
        return (tmn <= tmx) & (tmx >= tmin) & (tmn <= cap) & (cap >= tmin)

    def closest(px, py, pz, ux, uy, uz, tmin, tmax, live):
        """Best (t, prim, b1, b2) of the chords [tmin, tmax] on live lanes,
        plus the primitive and box tests paid per lane."""
        sd = lambda a: jnp.where(jnp.abs(a) < 1e-20, 1e-20, a)
        ix, iy, iz = 1.0 / sd(ux), 1.0 / sd(uy), 1.0 / sd(uz)
        bt, bp, bb1, bb2 = inf, jnp.full((R,), -1, i32), zeros, zeros
        live_i = live.astype(i32)
        # spheres (sphere_intersect's arithmetic; near root preferred)
        for s in range(n_sph):
            cx, cy, cz, rad = (sph_ref[0, s], sph_ref[1, s], sph_ref[2, s],
                               sph_ref[3, s])
            qx, qy, qz = px - cx, py - cy, pz - cz
            b = 2.0 * _dot(qx, qy, qz, ux, uy, uz)
            c = _dot(qx, qy, qz, qx, qy, qz) - rad * rad
            disc = b * b - 4.0 * c
            pos = disc > 1e-24
            sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
            t1 = (-b - sq) / 2.0
            t2 = (-b + sq) / 2.0
            ok1 = (tmin <= t1) & (t1 <= tmax)
            ok2 = (tmin <= t2) & (t2 <= tmax)
            ts = jnp.where(ok1, t1, t2)
            ok = (disc >= 0) & (ok1 | ok2) & (rad > 0) & live
            better = ok & (ts < bt)
            bt = jnp.where(better, ts, bt)
            bp = jnp.where(better, n_tri_rows + s, bp)
            bb1 = jnp.where(better, 0.0, bb1)
            bb2 = jnp.where(better, 0.0, bb2)

        def cap_of(bt, bp):
            cap = jnp.minimum(tmax, bt)
            if occlusion:
                cap = jnp.where(bp >= 0, -1.0, cap)
            return jnp.where(live, cap, -1.0)

        def tile(k, carry):
            """One cluster's TILE triangles against every lane."""
            bt, bp, bb1, bb2, nprim = carry
            cap = cap_of(bt, bp)
            sl = pl.ds(k * TILE, TILE)
            row = lambda r: tri_ref[r, sl][None, :]
            v0x, v0y, v0z = row(0), row(1), row(2)
            e1x, e1y, e1z = row(3), row(4), row(5)
            e2x, e2y, e2z = row(6), row(7), row(8)
            valid = row(9) > 0
            qx, qy, qz = px[:, None], py[:, None], pz[:, None]
            wx, wy, wz = ux[:, None], uy[:, None], uz[:, None]
            sx, sy, sz = qx - v0x, qy - v0y, qz - v0z
            s1x = wy * e2z - wz * e2y
            s1y = wz * e2x - wx * e2z
            s1z = wx * e2y - wy * e2x
            s2x = sy * e1z - sz * e1y
            s2y = sz * e1x - sx * e1z
            s2z = sx * e1y - sy * e1x
            denom = _dot(s1x, s1y, s1z, e1x, e1y, e1z)
            ok_d = denom != 0
            inv = 1.0 / jnp.where(ok_d, denom, 1.0)
            t = _dot(s2x, s2y, s2z, e2x, e2y, e2z) * inv
            b1 = _dot(s1x, s1y, s1z, sx, sy, sz) * inv
            b2 = _dot(s2x, s2y, s2z, wx, wy, wz) * inv
            b0 = 1.0 - b1 - b2
            ok = ((tmin[:, None] <= t) & (t <= cap[:, None]) & (b0 >= 0)
                  & (b1 >= 0) & (b2 >= 0) & valid & ok_d)
            tt = jnp.where(ok, t, jnp.inf)
            tbest = jnp.min(tt, axis=1)
            j = jnp.argmin(tt, axis=1).astype(i32)
            pick = col == j[:, None]
            take = lambda a: jnp.max(jnp.where(pick, a, -jnp.inf), axis=1)
            better = tbest < bt
            return (jnp.where(better, tbest, bt),
                    jnp.where(better, k * TILE + j, bp),
                    jnp.where(better, take(b1), bb1),
                    jnp.where(better, take(b2), bb2),
                    nprim + TILE * live_i)

        def cluster(k, carry):
            bt, bp, bb1, bb2, nprim, nbox = carry
            cap = cap_of(bt, bp)
            reach = slab(cbox_ref, k, px, py, pz, ix, iy, iz, tmin, cap)
            nbox = nbox + live_i
            bt, bp, bb1, bb2, nprim = jax.lax.cond(
                _any(reach), functools.partial(tile, k), lambda c: c,
                (bt, bp, bb1, bb2, nprim))
            return bt, bp, bb1, bb2, nprim, nbox

        def group_cond(c):
            g, bt, bp = c[0], c[1], c[2]
            return (g < n_groups) & _any(cap_of(bt, bp) >= tmin)

        def group(c):
            g, bt, bp, bb1, bb2, nprim, nbox = c
            cap = cap_of(bt, bp)
            reach = slab(gbox_ref, g, px, py, pz, ix, iy, iz, tmin, cap)
            nbox = nbox + live_i
            inner = lambda cc: jax.lax.fori_loop(
                g * GROUP, (g + 1) * GROUP, cluster, cc)
            out = jax.lax.cond(_any(reach), inner, lambda cc: cc,
                               (bt, bp, bb1, bb2, nprim, nbox))
            return (g + 1,) + out

        # the root box: chords that miss every triangle's bounds (escaped
        # or wrapped lanes, most late chords) skip the group loop
        root = slab(gbox_ref, n_groups, px, py, pz, ix, iy, iz, tmin,
                    cap_of(bt, bp))
        g0 = n_groups * (1 - jnp.max(root.astype(i32)))
        _, bt, bp, bb1, bb2, nprim, nbox = jax.lax.while_loop(
            group_cond, group,
            (g0, bt, bp, bb1, bb2, n_sph * live_i, live_i))
        return bt, bp, bb1, bb2, nprim, nbox

    if not curved:
        mn, mx = mn_ref[...], mx_ref[...]
        bt, bp, bb1, bb2, nprim, nbox = closest(
            ox, oy, oz, dx, dy, dz, mn, mx, mx >= mn)
        hit = bp >= 0
        outs = (bt, bb1, bb2, ox, oy, oz, dx, dy, dz, bp,
                jnp.zeros((R,), i32), hit.astype(i32), nprim, nbox)
    else:
        def march(px, py, pz, ux, uy, uz):
            """physics/schwarzschild.micro_step, component form."""
            xx, xy, xz = px - bpx, py - bpy, pz - bpz
            d2 = _dot(xx, xy, xz, xx, xy, xz)
            at_c = d2 <= 0
            dist = jnp.sqrt(jnp.where(at_c, 1.0, d2))
            rdist = 1.0 / dist
            hx, hy, hz = xx * rdist, xy * rdist, xz * rdist
            u = 1.0 / jnp.maximum(dist, 1e-12)
            ddx = _dot(ux, uy, uz, hx, hy, hz)
            yx, yy, yz = ux - ddx * hx, uy - ddx * hy, uz - ddx * hz
            y2 = _dot(yx, yy, yz, yx, yy, yz)
            dead = (y2 < 1e-24) | at_c
            rdy = 1.0 / jnp.sqrt(jnp.where(dead, 1.0, y2))
            yhx, yhy, yhz = yx * rdy, yy * rdy, yz * rdy
            up = jnp.clip(-u * ddx * rdy, -1e15, 1e15)
            f = lambda v: jnp.clip(-v + 1.5 * br * v * v, -1e30, 1e30)
            f1 = f(u)
            f2 = f(u + up * bdt / 2.0)
            f3 = f(u + up * bdt / 2.0 + f1 * bdt * bdt / 4.0)
            u_new = u + up * bdt + (f1 + f2 + f3) * bdt * bdt / 6.0
            clip_region = jnp.abs(u_new) < 1e-9
            d_new = jnp.where(clip_region,
                              jnp.where(u_new >= 0, 1e9, -1e9),
                              1.0 / jnp.where(clip_region, 1.0, u_new))
            a, b = d_new * cdt, d_new * sdt
            cx = bpx + a * hx + b * yhx - px
            cy = bpy + a * hy + b * yhy - py
            cz = bpz + a * hz + b * yhz - pz
            c2 = _dot(cx, cy, cz, cx, cy, cz)
            zero = c2 <= 0
            clen = jnp.sqrt(jnp.where(zero, 1.0, c2))
            rc = 1.0 / clen
            clen = jnp.where(zero, 0.0, clen)
            dead = dead | ~jnp.isfinite(clen) | zero
            return cx * rc, cy * rc, cz * rc, clen, dead

        def absorbed_by_hole(px, py, pz, ux, uy, uz, clen):
            qx, qy, qz = px - bpx, py - bpy, pz - bpz
            b = 2.0 * _dot(qx, qy, qz, ux, uy, uz)
            c = _dot(qx, qy, qz, qx, qy, qz) - br * br
            disc = b * b - 4.0 * c
            has = disc >= 0
            sq = jnp.sqrt(jnp.where(has, disc, 1.0))
            t1 = (-b - sq) / 2.0
            t2 = (-b + sq) / 2.0
            return has & (((0.0 <= t1) & (t1 <= clen))
                          | ((0.0 <= t2) & (t2 <= clen)))

        def seg_cond(c):
            return (c[0] < n_seg) & _any(c[7] == 0)

        def seg_body(c):
            (s, px, py, pz, ux, uy, uz, flag, bt, bb1, bb2, bp, seg,
             sox, soy, soz, sdx, sdy, sdz, nprim, nbox) = c
            open_ = flag == 0
            nx, ny, nz, clen, dead = march(px, py, pz, ux, uy, uz)
            clen = jnp.where(dead, 0.0, clen)
            absd = absorbed_by_hole(px, py, pz, nx, ny, nz, clen) & ~dead
            live = open_ & ~dead & ~absd
            t, p, b1, b2, np_, nb_ = jax.lax.cond(
                _any(live),
                lambda: closest(px, py, pz, nx, ny, nz, zeros, clen, live),
                lambda: (inf, jnp.full((R,), -1, i32), zeros, zeros,
                         izeros, izeros))
            new = live & (p >= 0)
            upd = lambda cur, v: jnp.where(new, v, cur)
            # flag: 0 open, 1 hit, 2 absorbed, 3 dead (no event)
            flag = jnp.where(new, 1, flag)
            flag = jnp.where(open_ & absd, 2, flag)
            flag = jnp.where(open_ & dead, 3, flag)
            return (s + 1,
                    px + nx * clen, py + ny * clen, pz + nz * clen,
                    nx, ny, nz, flag,
                    upd(bt, t), upd(bb1, b1), upd(bb2, b2), upd(bp, p),
                    upd(seg, s), upd(sox, px), upd(soy, py), upd(soz, pz),
                    upd(sdx, nx), upd(sdy, ny), upd(sdz, nz),
                    nprim + np_, nbox + nb_)

        init = (jnp.int32(0), ox, oy, oz, dx, dy, dz, izeros,
                zeros, zeros, zeros, jnp.full((R,), -1, i32),
                jnp.full((R,), n_seg, i32), ox, oy, oz, dx, dy, dz,
                izeros, izeros)
        (_, _, _, _, _, _, _, flag, bt, bb1, bb2, bp, seg,
         sox, soy, soz, sdx, sdy, sdz, nprim, nbox) = jax.lax.while_loop(
            seg_cond, seg_body, init)
        outs = (bt, bb1, bb2, sox, soy, soz, sdx, sdy, sdz, bp, seg, flag,
                nprim, nbox)

    refs = (t_ref, b1_ref, b2_ref, sox_ref, soy_ref, soz_ref, sdx_ref,
            sdy_ref, sdz_ref, prim_ref, seg_ref, flag_ref, nprim_ref,
            nbox_ref)
    for ref, v in zip(refs, outs):
        ref[...] = v.astype(ref.dtype)


@functools.partial(
    jax.jit, static_argnames=("curved", "n_seg", "occlusion", "interpret",
                              "lanes"))
def pallas_trace_raw(scene: SceneData, bh: Optional[BlackHoleParams],
                     rays: Rays, curved: bool, n_seg: int,
                     occlusion: bool = False, interpret: bool = False,
                     lanes: int = LANES):
    """Run the kernel over flat (n,) lanes. Returns flat
    (flag, t, prim, b1, b2, seg, seg_o, seg_d, stats)."""
    n = rays.o.shape[0]
    n_pad = -(-n // lanes) * lanes
    f32 = jnp.float32
    if curved:
        par = jnp.stack([
            *jnp.asarray(bh.position, f32).reshape(3),
            jnp.asarray(bh.radius, f32), jnp.asarray(bh.delta_theta, f32),
            jnp.cos(jnp.asarray(bh.delta_theta, f32)),
            jnp.sin(jnp.asarray(bh.delta_theta, f32)), jnp.zeros((), f32)])
        o_fill = jnp.asarray(bh.position, f32).reshape(3)
    else:
        par = jnp.zeros((8,), f32)
        o_fill = jnp.zeros((3,), f32)
    # padding lanes terminate at once: curved ones start at the hole's
    # centre (a degenerate step), flat ones have max_t < min_t
    padv = lambda a, v: jnp.concatenate(
        [a.astype(f32), jnp.full((n_pad - n,), v, f32)])
    ins = ([padv(rays.o[:, i], o_fill[i]) for i in range(3)]
           + [padv(rays.d[:, i], 1.0 if i == 0 else 0.0) for i in range(3)]
           + [padv(rays.min_t, 0.0), padv(rays.max_t, -1.0)])
    tri, cbox, gbox, sph = build_tables(scene)
    h = Hierarchy.of(scene.n_tris)
    n_sph = scene.n_spheres if scene.n_live_spheres < 0 \
        else min(scene.n_live_spheres, scene.n_spheres)
    lane = pl.BlockSpec((lanes,), lambda i: (i,))
    whole = pl.BlockSpec()          # the full array, indexed in-kernel
    out_dtypes = [f32] * 9 + [jnp.int32] * 5
    kernel = functools.partial(
        _kernel, curved=curved, n_seg=n_seg, n_groups=h.n_groups,
        n_sph=n_sph, n_tri_rows=scene.n_tris, occlusion=occlusion)
    outs = pl.pallas_call(
        kernel,
        grid=(n_pad // lanes,),
        in_specs=[whole] + [lane] * 8 + [whole] * 4,
        out_specs=[lane] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), d) for d in out_dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="rrt_trace",
    )(par, *ins, tri, cbox, gbox, sph)
    cut = lambda a: a[:n]
    (t, b1, b2, sox, soy, soz, sdx, sdy, sdz, prim, seg, flag, nprim,
     nbox) = map(cut, outs)
    stats = jnp.stack([jnp.sum(nprim, dtype=f32), jnp.sum(nbox, dtype=f32)])
    seg_o = jnp.stack([sox, soy, soz], axis=-1)
    seg_d = jnp.stack([sdx, sdy, sdz], axis=-1)
    return flag, t, prim, b1, b2, seg, seg_o, seg_d, stats


def pallas_trace(scene: SceneData, bh: Optional[BlackHoleParams],
                 rays: Rays, n_seg: int, interpret: bool = False,
                 return_seg: bool = False, return_stats: bool = False,
                 occlusion: bool = False, lanes: int = LANES):
    """Closest hit (or any hit with `occlusion`) through the kernel, with
    the same Hit payload and optional (seg, stats) as the XLA paths."""
    from rrt_tpu.geometry.trace import lane_order

    curved = bh is not None and bh.enabled
    shape = rays.o.shape[:-1]
    flat = Rays(o=rays.o.reshape(-1, 3), d=rays.d.reshape(-1, 3),
                min_t=rays.min_t.reshape(-1), max_t=rays.max_t.reshape(-1))
    perm = lane_order(scene, flat.o, flat.d)
    if perm is not None:
        flat = jax.tree_util.tree_map(lambda a: a[perm], flat)
    flag, t, prim, b1, b2, seg, seg_o, seg_d, stats = pallas_trace_raw(
        scene, bh, flat, curved, n_seg if curved else 1, occlusion,
        interpret, lanes)
    if perm is not None:
        inv = jnp.argsort(perm)
        flag, t, prim, b1, b2, seg, seg_o, seg_d = (
            a[inv] for a in (flag, t, prim, b1, b2, seg, seg_o, seg_d))
    hit = flag == 1
    # misses report t = max_t in flat mode and 0 in curved mode, as the
    # XLA paths do
    t_miss = 0.0 if curved else rays.max_t.reshape(-1)
    h = build_hit(scene, seg_o, seg_d, hit, jnp.where(hit, t, t_miss), prim,
                  b1, b2)
    if shape != hit.shape:
        h = jax.tree_util.tree_map(lambda a: a.reshape(shape + a.shape[1:]),
                                   h)
        seg = seg.reshape(shape)
    out = (h,)
    if return_seg:
        out = out + (seg,)
    if return_stats:
        out = out + (stats,)
    return out if len(out) > 1 else h
