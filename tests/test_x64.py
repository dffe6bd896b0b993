"""Float64 validation of the curved-space marcher.

The f32 parity suite excludes WRAPPED lanes (u<=0 teleport chords,
blackhole.cpp:33-36) behind a chaotic-lane classifier: consecutive
1e9-scale chords amplify any f32 ulp difference without bound. Running
the same math in f64 turns that exclusion into a verification — against
the scalar float64 oracle (tests/oracle.py::micro_step, a transcription
of blackhole.cpp:17-40 in double precision, the reference's own type),
wrapped chords must agree step-for-step, and the full curved closest-hit
must agree discretely with an oracle march+intersect loop.

Uses jax.experimental.enable_x64 so the rest of the suite stays f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import contextlib


@contextlib.contextmanager
def enable_x64():
    """Scoped jax_enable_x64 (this JAX version has no experimental
    context manager for it)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)

from tests import oracle
from rrt_tpu.physics import schwarzschild as ss
from rrt_tpu.scene.build import load_scene
from rrt_tpu.types import BlackHoleParams, Rays
from rrt_tpu.scene.cornell import scene_path

BH_O = np.array([0.0, 1.0, 0.0])
BH_R = 0.1
DT = 0.1


def _bh(dtype):
    return BlackHoleParams(position=jnp.asarray(BH_O, dtype),
                           radius=jnp.asarray(BH_R, dtype),
                           delta_theta=jnp.asarray(DT, dtype))


def _wrapped_rays(n=256, seed=5):
    """Rays aimed near the hole so a good fraction wrap (teleport)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)) * [1, 0.4, 1] + [0, 1.0, 0]
    # aim at points within ~2 radii of the hole center
    tgt = BH_O + rng.normal(scale=2.0 * BH_R, size=(n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_f64_march_matches_oracle_stepwise():
    """Each Δθ step in f64 reproduces the oracle bit-for-bit-ish —
    INCLUDING wrapped chords (no classifier)."""
    o, d = _wrapped_rays()
    with enable_x64():
        bh = _bh(jnp.float64)
        pos = jnp.asarray(o, jnp.float64)
        dirn = jnp.asarray(d, jnp.float64)
        n_wrapped = 0
        for s in range(63):
            nd, clen, dead = ss.micro_step(pos, dirn, bh)
            nd_np, clen_np = np.asarray(nd), np.asarray(clen)
            dead_np = np.asarray(dead)
            for i in range(o.shape[0]):
                if dead_np[i]:
                    continue
                ond, olen = oracle.micro_step(
                    np.asarray(pos[i], np.float64),
                    np.asarray(dirn[i], np.float64), BH_O, BH_R, DT)
                if not np.all(np.isfinite(ond)) or olen > 1e8 \
                        or olen < 1e-9:
                    # beyond the implementation's 1e9 teleport clamp, or a
                    # near-zero chord (both endpoints cancel — direction
                    # is noise in any precision); the unclamped oracle
                    # diverges there by design
                    continue
                np.testing.assert_allclose(nd_np[i], ond, rtol=1e-9,
                                           atol=1e-9)
                # wrapped chords: clen ~ 1/u_new where u_new comes from
                # catastrophic cancellation — two equivalent f64 codes
                # legitimately differ by eps·|u|/|u_new|; scale tolerance
                rtol = 1e-9 if clen_np[i] < 1e3 else 1e-4
                np.testing.assert_allclose(clen_np[i], olen, rtol=rtol)
            n_wrapped += int(np.sum(clen_np[~dead_np] > 50.0))
            pos = pos + nd * clen[..., None]
            dirn = nd
        assert n_wrapped > 10  # the set genuinely exercises teleports


@pytest.mark.slow
def test_f64_curved_trace_matches_oracle_wrapped():
    """Full curved closest-hit in f64 vs an oracle march+intersect loop:
    discrete agreement (hit, absorbed, winning segment/prim) on every
    lane, wrapped ones included."""
    from rrt_tpu.geometry.trace import trace_curved_marched

    scene, _ = load_scene(
        scene_path("cornell_lambertian"))
    o, d = _wrapped_rays(n=64, seed=7)
    nt = int(scene.n_tris)
    valid = np.asarray(scene.tri_bsdf) >= 0
    tris = [(np.asarray(scene.tri_v0[i], np.float64),
             np.asarray(scene.tri_v1[i], np.float64),
             np.asarray(scene.tri_v2[i], np.float64))
            for i in range(nt) if valid[i]]
    tri_ids = [i for i in range(nt) if valid[i]]
    live_s = np.asarray(scene.sph_radius) > 0
    sphs = [(np.asarray(scene.sph_center[j], np.float64),
             float(scene.sph_radius[j]))
            for j in range(scene.sph_center.shape[0]) if live_s[j]]
    sph_ids = [nt + j for j in range(scene.sph_center.shape[0])
               if live_s[j]]

    def oracle_curved(o1, d1):
        pos, dirn = o1.copy(), d1.copy()
        for s in range(63):
            nd, clen = oracle.micro_step(pos, dirn, BH_O, BH_R, DT)
            if clen == 0.0:
                return ("dead", s, -1)
            # absorption beats same-segment geometry (bvh.cpp:107-108)
            if oracle.sphere_hit(pos, nd, 0.0, clen, BH_O, BH_R) is not None:
                return ("absorbed", s, -1)
            best_t, best_p = np.inf, -1
            for (v0, v1, v2), pid in zip(tris, tri_ids):
                res = oracle.tri_hit(pos, nd, 0.0, clen, v0, v1, v2)
                if res is not None and res[0] < best_t:
                    best_t, best_p = res[0], pid
            for (c, r), pid in zip(sphs, sph_ids):
                t = oracle.sphere_hit(pos, nd, 0.0, clen, c, r)
                if t is not None and t < best_t:
                    best_t, best_p = t, pid
            if best_p >= 0:
                return ("hit", s, best_p)
            pos = pos + nd * clen
            dirn = nd
        return ("escaped", 63, -1)

    with enable_x64():
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        scene64 = jax.tree_util.tree_map(
            lambda a: f64(a) if hasattr(a, "dtype")
            and jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
            scene)
        rays = Rays(o=f64(o), d=f64(d),
                    min_t=jnp.zeros(o.shape[0], jnp.float64),
                    max_t=jnp.full(o.shape[0], 1e9, jnp.float64))
        h, seg = trace_curved_marched(scene64, _bh(jnp.float64), rays, 63,
                                      return_seg=True)
        hitm = np.asarray(h.hit)
        prim = np.asarray(h.prim_id)
        segw = np.asarray(seg)

    n_wrapped_checked = 0
    for i in range(o.shape[0]):
        kind, s, pid = oracle_curved(o[i].astype(np.float64),
                                     d[i].astype(np.float64))
        if kind == "hit":
            assert hitm[i], i
            assert segw[i] == s, (i, segw[i], s)
            assert prim[i] == pid, (i, prim[i], pid)
        elif kind in ("absorbed", "escaped", "dead"):
            assert not hitm[i], (i, kind)
        if s > 0:
            n_wrapped_checked += 1
    assert o.shape[0] >= 64
