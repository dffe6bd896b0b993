"""Geometry layer: batched intersection vs the scalar float64 oracle, and
curved-space trace semantics."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from rrt_tpu.geometry import intersect as I
from rrt_tpu.geometry import trace as T
from rrt_tpu.types import BlackHoleParams, Rays
from rrt_tpu.scene.build import load_scene
from rrt_tpu.scene.cornell import scene_path



def _rand_unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_tri_intersect_matches_oracle():
    rng = np.random.default_rng(0)
    N, C = 64, 16
    o = rng.uniform(-2, 2, (N, 3))
    d = _rand_unit(rng, N)
    v0 = rng.uniform(-2, 2, (C, 3))
    v1 = v0 + rng.uniform(-1.5, 1.5, (C, 3))
    v2 = v0 + rng.uniform(-1.5, 1.5, (C, 3))
    min_t = np.zeros(N)
    max_t = np.full(N, 100.0)
    ok, t, b1, b2 = jax.jit(I.tri_intersect)(
        o.astype(np.float32), d.astype(np.float32),
        min_t.astype(np.float32), max_t.astype(np.float32),
        v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32),
        np.ones(C, bool))
    ok = np.asarray(ok)
    t = np.asarray(t)
    agree = 0
    for i in range(N):
        for j in range(C):
            ref = oracle.tri_hit(o[i], d[i], 0.0, 100.0, v0[j], v1[j], v2[j])
            if ref is None:
                # allow borderline fp disagreements only near b=0/t bounds
                if ok[i, j]:
                    continue
                agree += 1
            else:
                assert ok[i, j], (i, j, ref)
                np.testing.assert_allclose(t[i, j], ref[0], rtol=2e-3,
                                           atol=2e-4)
                agree += 1
    assert agree > 0.95 * N * C


def test_sphere_intersect_matches_oracle_inside_outside():
    rng = np.random.default_rng(1)
    N = 128
    o = rng.uniform(-2, 2, (N, 3))
    d = _rand_unit(rng, N)
    c = np.array([[0.2, -0.1, 0.4], [0, 0, 0]])
    r = np.array([0.7, 2.5])  # second sphere often contains the origin
    ok, t = jax.jit(I.sphere_intersect)(
        o.astype(np.float32), d.astype(np.float32),
        np.zeros(N, np.float32), np.full(N, 50.0, np.float32),
        c.astype(np.float32), r.astype(np.float32))
    ok = np.asarray(ok)
    t = np.asarray(t)
    for i in range(N):
        for j in range(2):
            ref = oracle.sphere_hit(o[i], d[i], 0.0, 50.0, c[j], r[j])
            assert ok[i, j] == (ref is not None)
            if ref is not None:
                np.testing.assert_allclose(t[i, j], ref, rtol=1e-3, atol=1e-4)


def test_closest_hit_brute_matches_oracle_scene():
    scene, cam = load_scene(scene_path("cornell_lambertian"))
    rng = np.random.default_rng(2)
    N = 128
    # rays from inside the box
    o = rng.uniform(-0.8, 0.8, (N, 3)) * np.array([1, 0.5, 1]) + [0, 0.75, 0]
    d = _rand_unit(rng, N)
    hit, t, pid, b1, b2, _st = jax.jit(
        lambda o, d, mn, mx: I.closest_hit_brute(scene, o, d, mn, mx, 64))(
        o.astype(np.float32), d.astype(np.float32),
        np.zeros(N, np.float32), np.full(N, 1e9, np.float32))
    hit = np.asarray(hit)
    t = np.asarray(t)
    pid = np.asarray(pid)

    nt = int(np.sum(np.asarray(scene.tri_bsdf) >= 0))
    tris = [(np.asarray(scene.tri_v0[i], np.float64),
             np.asarray(scene.tri_v1[i], np.float64),
             np.asarray(scene.tri_v2[i], np.float64)) for i in range(nt)]
    ns = int(np.sum(np.asarray(scene.sph_bsdf) >= 0))
    sphs = [(np.asarray(scene.sph_center[j], np.float64),
             float(scene.sph_radius[j])) for j in range(ns)]
    n_tri_rows = scene.n_tris
    matched = 0
    for i in range(N):
        ref = oracle.closest_hit(o[i], d[i], 0.0, 1e9, tris, sphs)
        assert hit[i] == (ref is not None)
        if ref is not None:
            ref_pid, ref_t = ref
            # map oracle sphere ids (offset nt) to scene flat ids (offset rows)
            if ref_pid >= len(tris):
                ref_pid = n_tri_rows + (ref_pid - len(tris))
            if pid[i] == ref_pid:
                matched += 1
                np.testing.assert_allclose(t[i], ref_t, rtol=2e-3, atol=2e-4)
    assert matched >= 0.97 * hit.sum()


def test_micro_step_matches_oracle():
    from rrt_tpu.physics import schwarzschild as ss
    rng = np.random.default_rng(3)
    N = 256
    pos = rng.uniform(-3, 3, (N, 3))
    dirn = _rand_unit(rng, N)
    bh = BlackHoleParams(
        position=jnp.array([0.0, 1.0, 0.0]),
        radius=jnp.array(0.1),
        delta_theta=jnp.array(0.1))
    nd, ln, dead = jax.jit(ss.micro_step)(
        pos.astype(np.float32), dirn.astype(np.float32), bh)
    nd = np.asarray(nd)
    ln = np.asarray(ln)
    dead = np.asarray(dead)
    checked = 0
    for i in range(N):
        ref_d, ref_l = oracle.micro_step(
            pos[i], dirn[i], np.array([0, 1.0, 0]), 0.1, 0.1)
        if dead[i]:
            continue
        np.testing.assert_allclose(nd[i], ref_d, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(ln[i], ref_l, rtol=5e-3, atol=5e-4)
        checked += 1
    assert checked > 0.9 * N


def test_segment_count():
    from rrt_tpu.physics import schwarzschild as ss
    assert ss.n_segments(0.1) == 63
    assert ss.n_segments(np.pi) == 2
    assert ss.n_segments(2 * np.pi / 10) == 10


def test_curved_trace_near_flat_far_hole():
    """With a distant microscopic hole the chords are straight: curved trace
    must agree with flat trace (where the march reaches the geometry)."""
    scene, cam = load_scene(scene_path("cornell_lambertian"))
    rng = np.random.default_rng(4)
    N = 64
    o = np.tile([[0.0, 0.75, 0.0]], (N, 1)) + rng.uniform(-0.2, 0.2, (N, 3))
    d = _rand_unit(rng, N)
    rays = Rays(o=jnp.asarray(o, jnp.float32), d=jnp.asarray(d, jnp.float32),
                min_t=jnp.zeros(N, jnp.float32),
                max_t=jnp.full(N, 1e9, jnp.float32))
    # hole 50 units away, r=1e-7: chords are ~5 long and nearly straight,
    # every boxed ray reaches geometry within a couple of segments
    bh = BlackHoleParams(
        position=jnp.array([0.0, 0.75, -50.0]),
        radius=jnp.array(1e-7),
        delta_theta=jnp.array(0.1))
    hc = jax.jit(lambda r: T.trace_curved(scene, bh, r, chunk=64))(rays)
    hf = jax.jit(lambda r: T.trace_flat(scene, r, chunk=64))(rays)
    hitc = np.asarray(hc.hit)
    hitf = np.asarray(hf.hit)
    # the Cornell box is open at the front, so some rays escape in both modes
    assert hitf.sum() >= 0.6 * N
    assert hitc.sum() >= 0.9 * hitf.sum()
    same = hitc & hitf
    # chord polygonization leaves O(Δθ²·d) deviation; compare loosely
    np.testing.assert_allclose(
        np.asarray(hc.p)[same], np.asarray(hf.p)[same], atol=6e-2)
    assert (np.asarray(hc.prim_id)[same] ==
            np.asarray(hf.prim_id)[same]).mean() > 0.9


def test_absorption_kills_ray():
    scene, cam = load_scene(scene_path("cornell_lambertian"))
    bh = BlackHoleParams(
        position=jnp.array([0.0, 0.75, 0.0]),
        radius=jnp.array(0.3),
        delta_theta=jnp.array(0.1))
    # ray pointed slightly off the hole center (exact radial aim is the
    # reference's UB path) from inside the box: gets bent in and absorbed
    o = jnp.array([[0.9, 0.75, 0.0]], jnp.float32)
    d = jnp.asarray(np.array([[-1.0, 0.02, 0.0]]) /
                    np.linalg.norm([-1.0, 0.02, 0.0]), jnp.float32)
    rays = Rays(o=o, d=d, min_t=jnp.zeros(1, jnp.float32),
                max_t=jnp.full(1, 1e9, jnp.float32))
    h = jax.jit(lambda r: T.trace_curved(scene, bh, r, chunk=64))(rays)
    assert not bool(h.hit[0])


def test_occluded_flat_respects_max_t():
    scene, _ = load_scene(scene_path("cornell_lambertian"))
    # ray toward the back wall (t = 1): occluded with long max_t, clear
    # with short
    o = jnp.array([[0.0, 0.2, 0.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
    mk = lambda mt: Rays(o=o, d=d, min_t=jnp.zeros(1, jnp.float32),
                         max_t=jnp.full(1, mt, jnp.float32))
    assert bool(T.occluded(scene, None, mk(10.0))[0])
    assert not bool(T.occluded(scene, None, mk(0.5))[0])


def test_cluster_closest_hit_matches_brute():
    """The tile-culled query (the XLA analog of the reference's BVH
    traversal, bvh.cpp:115-138) must agree with the brute scan exactly —
    coherent camera rays, incoherent random rays, and clipped max_t."""
    from rrt_tpu.geometry.intersect import (closest_hit_brute,
                                            closest_hit_cluster)
    scene, cam = load_scene(scene_path("torus"))
    n = 900                                   # not a tile multiple
    w = 30
    xs = (jnp.arange(n) % w + 0.5) / w
    ys = (jnp.arange(n) // w + 0.5) / w
    cam_rays = cam.generate_rays(jnp.stack([xs, ys], axis=-1))
    rng = np.random.default_rng(3)
    ro = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    rd = rng.normal(size=(n, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True),
                     jnp.float32)
    cases = [
        (cam_rays.o, cam_rays.d, cam_rays.min_t, cam_rays.max_t),
        (ro, rd, jnp.zeros(n), jnp.full(n, 1e9)),
        (ro, rd, jnp.zeros(n), jnp.full(n, 2.0)),   # clipped
    ]
    for o, d, mn, mx in cases:
        hb = closest_hit_brute(scene, o, d, mn, mx)
        hc = closest_hit_cluster(scene, o, d, mn, mx)
        assert (np.asarray(hb[0]) == np.asarray(hc[0])).all()
        m = np.asarray(hb[0])
        assert (np.asarray(hb[2])[m] == np.asarray(hc[2])[m]).all()
        np.testing.assert_allclose(np.asarray(hb[1])[m],
                                   np.asarray(hc[1])[m], rtol=1e-6)


def test_curved_marched_lane_slabs_match():
    """The LANE_SLAB wrapper (bounds the march-once chord tables for giant
    NEE batches) must be invisible: slabbed == direct, lane for lane."""
    import rrt_tpu.geometry.trace as T
    from rrt_tpu.io import collada
    from rrt_tpu.scene.build import build_scene
    from rrt_tpu.types import BlackHoleParams, Rays

    scene, cam = build_scene(
        collada.load(scene_path("cornell_lambertian")), 128, 128)
    bh = BlackHoleParams(position=jnp.array([0.0, 1.0, 0.0]),
                         radius=jnp.float32(0.1),
                         delta_theta=jnp.float32(0.1))
    n = 4096
    xs = (jnp.arange(n) % 64 + 0.5) / 64
    ys = (jnp.arange(n) // 64 + 0.5) / 64
    rays = cam.generate_rays(jnp.stack([xs, ys], axis=-1))
    direct = T._trace_curved_marched_slab(scene, bh, rays, 63)
    old = T.LANE_SLAB
    try:
        T.LANE_SLAB = 1024          # force 4 slabs + padding
        slabbed, seg = T.trace_curved_marched(scene, bh, rays, 63,
                                              return_seg=True)
    finally:
        T.LANE_SLAB = old
    assert bool(jnp.all(direct.hit == slabbed.hit))
    m = np.asarray(direct.hit)
    assert (np.asarray(direct.prim_id)[m]
            == np.asarray(slabbed.prim_id)[m]).all()
    assert seg.shape == (n,)
