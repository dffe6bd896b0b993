"""Wavefront path-tracing integrator.

The reference integrator is a per-pixel recursion
(`part1_code.cpp:15-123`): est_radiance_global_illumination →
{zero,one,at_least_one}_bounce_radiance with next-event estimation,
Russian roulette (continue-prob 0.7, always-continue at the first vertex,
and the 1/0.7 weight applied even there — reproduced faithfully), delta-BSDF
emission pickup, and envmap misses.

Batched reformulation: the recursion becomes an iterative wavefront over a flat
lane batch — every vertex step shades ALL lanes in lockstep (masked), does
one batched NEE occlusion trace and one batched bounce trace, and carries
(L, β, alive) through a `lax.scan` over the remaining depth. Discrete
decisions (hits, coin flips, light CDF inversion) are detached from
autodiff; radiance stays differentiable w.r.t. material/emission/metric
parameters through the continuous factors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from rrt_tpu.geometry import trace as tracer
from rrt_tpu.render import bsdf as bsdflib
from rrt_tpu.render import lights as lightlib
from rrt_tpu.scene import envmap as envlib
from rrt_tpu.types import BlackHoleParams, Hit, Rays, SceneData
from rrt_tpu.utils import math3d as m3
from rrt_tpu.utils.config import Illum, RenderConfig

PI = math.pi
RR_PROB = 0.7  # Russian roulette continue probability (part1_code.cpp:82)


def _frames(hit: Hit):
    return m3.make_coord_space(hit.n)


def _n_seg(cfg: RenderConfig):
    """Static segment count from the config's nominal Δθ (needed when
    bh.delta_theta is a traced parameter under autodiff)."""
    from rrt_tpu.physics import schwarzschild as ss
    return ss.n_segments(cfg.black_hole.delta_theta)


STATS0 = jnp.zeros(2, jnp.float32)  # [prim tests, bbox tests] measured


def _trace(scene, bh, rays, cfg: RenderConfig, mesh=None):
    """Closest hit for radiance: under autodiff, the fast discrete primal
    (the fused kernel on a GPU) + differentiable reconstruction
    (`trace_diff`); otherwise the fast path directly.

    Returns (Hit, (2,) measured work counters) — see geometry.trace.trace.
    """
    if cfg.differentiable:
        return tracer.trace_diff(scene, bh, rays, n_seg=_n_seg(cfg),
                                 backend=cfg.trace_backend), STATS0
    return tracer.trace(scene, bh, rays, n_seg=_n_seg(cfg),
                        backend=cfg.trace_backend, return_stats=True,
                        mesh=mesh)


def _trace_discrete(scene, bh, rays, cfg: RenderConfig, mesh=None):
    """Closest hit whose continuous payload is never differentiated (only
    hit masks / bsdf ids are consumed): always use the fast path with
    detached inputs. Returns (Hit, measured work counters)."""
    sg = lambda t: jax.tree_util.tree_map(jax.lax.stop_gradient, t)
    return tracer.trace(sg(scene), sg(bh), sg(rays), n_seg=_n_seg(cfg),
                        backend=cfg.trace_backend, return_stats=True,
                        mesh=mesh)


def _mask_rays(rays: Rays, active, bh) -> Rays:
    """Replace inactive lanes with rays that terminate immediately:
    origin at the hole center (curved: degenerate→dead on segment 1) or
    max_t < min_t (flat). Lets done kernel tiles early-exit instead of
    marching stale lanes through all 63 segments."""
    if bh is not None and bh.enabled:
        o = jnp.where(active[..., None],
                      rays.o, jnp.broadcast_to(bh.position, rays.o.shape))
        return rays.replace(o=o)
    return rays.replace(max_t=jnp.where(active, rays.max_t, -1.0))


def direct_lighting_importance(
    scene: SceneData,
    bh: Optional[BlackHoleParams],
    hit: Hit,
    cfg: RenderConfig,
    key,
    mesh=None,
) -> jnp.ndarray:
    """estimate_direct_lighting_importance (part1_code.cpp:33-57) for a
    batch of shading points: per light ℓ, 1 (delta) or ns_area_light
    samples; ONE batched occlusion trace covers all (light, sample) pairs."""
    n_lights = scene.lights.kind.shape[0]
    if n_lights == 0:
        return jnp.zeros_like(hit.p), STATS0

    fx, fy, fz = _frames(hit)
    wo = m3.to_local(fx, fy, fz, hit.w_out)
    shape = hit.t.shape

    rads, wis, dists, pdfs = [], [], [], []
    total = 0
    for li in range(n_lights):
        ns = 1 if lightlib.is_delta_light(scene.lights, li) \
            else cfg.ns_area_light
        total += ns
        for s in range(ns):
            key, k = jax.random.split(key)
            ls = lightlib.sample_light(
                scene.lights, li, hit.p, k, scene.env,
                env_importance=cfg.env_importance_sampling)
            rads.append(ls.radiance)
            wis.append(ls.wi)
            dists.append(ls.dist)
            pdfs.append(ls.pdf)

    rad = jnp.stack(rads)          # (S, ..., 3)
    wi_w = jnp.stack(wis)
    dist = jnp.stack(dists)
    pdf = jnp.stack(pdfs)

    def sum_chunk(chunk):
        """Summed (unnormalized) contribution of a (c, ...) slice of the
        stacked (light, sample) axis: ONE occlusion trace per chunk."""
        rad, wi_w, dist, pdf = chunk
        wi_l = m3.to_local(fx[None], fy[None], fz[None], wi_w)
        facing = wi_l[..., 2] >= 0     # reference skips w_in.z < 0
        shadow = Rays(
            o=hit.p[None] + cfg.ray_eps * wi_w,
            d=wi_w,
            min_t=jnp.zeros_like(dist),
            max_t=dist,            # honored in flat mode; discarded curved
        )
        shadow = _mask_rays(shadow, facing & hit.hit[None], bh)
        # occluded() detaches its inputs internally: the fast early-exit
        # path stays usable under autodiff (visibility grads out of scope)
        occ, tstats = tracer.occluded(
            scene, bh, shadow, n_seg=_n_seg(cfg),
            backend=cfg.trace_backend, return_stats=True, mesh=mesh)
        f_val = bsdflib.evaluate(
            scene.bsdfs, hit.bsdf_id[None], wo[None], wi_l)
        contrib = rad * f_val * (wi_l[..., 2:3]) / pdf[..., None]
        ok = (facing & ~occ & hit.hit[None])[..., None]
        return jnp.sum(jnp.where(ok, contrib, 0.0), axis=0), tstats

    # Lane-blow-up guard: at -l 64 the stacked axis would multiply every
    # shading lane 64-128x through one trace (memory blow-up). Chunk the
    # axis at cfg.nee_chunk and lax.map sequentially over chunks; the
    # common case (few lights, small -l) stays a single fused trace.
    S = total
    c = max(1, cfg.nee_chunk)
    if S <= c:
        L, tstats = sum_chunk((rad, wi_w, dist, pdf))
        return L / total, tstats
    pad = (-S) % c
    if pad:
        # padded entries: rad=0 kills their contribution; pdf=1 avoids 0/0
        zpad = lambda a, fill: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        rad, wi_w, dist, pdf = (zpad(rad, 0.0), zpad(wi_w, 1.0),
                                zpad(dist, 1.0), zpad(pdf, 1.0))
    chunked = jax.tree_util.tree_map(
        lambda a: a.reshape((-(S // -c), c) + a.shape[1:]),
        (rad, wi_w, dist, pdf))
    per_chunk, cstats = jax.lax.map(sum_chunk, chunked)  # (nc, ..., 3)
    return jnp.sum(per_chunk, axis=0) / total, jnp.sum(cstats, axis=0)


def direct_lighting_hemisphere(
    scene: SceneData,
    bh: Optional[BlackHoleParams],
    hit: Hit,
    cfg: RenderConfig,
    key,
    mesh=None,
) -> jnp.ndarray:
    """estimate_direct_lighting_hemisphere (part1_code.cpp:15-31): uniform
    hemisphere sampling, emission of whatever is hit."""
    n_lights = scene.lights.kind.shape[0]
    num = max(n_lights * cfg.ns_area_light, 1)
    fx, fy, fz = _frames(hit)
    wo = m3.to_local(fx, fy, fz, hit.w_out)
    shape = hit.t.shape
    dt = hit.p.dtype

    xi = jax.random.uniform(key, (num,) + shape + (2,), dt)
    theta = jnp.arccos(xi[..., 0])
    phi = 2.0 * PI * xi[..., 1]
    wi_l = jnp.stack([jnp.sin(theta) * jnp.cos(phi),
                      jnp.sin(theta) * jnp.sin(phi),
                      jnp.cos(theta)], axis=-1)
    wi_w = m3.to_world(fx[None], fy[None], fz[None], wi_l)
    rays = Rays(
        o=hit.p[None] + cfg.ray_eps * wi_w,
        d=wi_w,
        min_t=jnp.zeros((num,) + shape, dt),
        max_t=jnp.full((num,) + shape, jnp.inf, dt),
    )
    # only h2.hit / h2.bsdf_id are consumed; the emission gather below
    # reads the LIVE (differentiable) bsdf table
    h2, tstats = _trace_discrete(scene, bh, rays, cfg, mesh)
    emit = bsdflib.emission(scene.bsdfs, h2.bsdf_id)
    f_val = bsdflib.evaluate(scene.bsdfs, hit.bsdf_id[None], wo[None], wi_l)
    contrib = emit * f_val * wi_l[..., 2:3]
    ok = (h2.hit & hit.hit[None])[..., None]
    return (jnp.sum(jnp.where(ok, contrib, 0.0), axis=0) * 2.0 * PI / num,
            tstats)


def _direct(scene, bh, hit, cfg, key, mesh=None):
    if cfg.direct_hemisphere_sample:
        return direct_lighting_hemisphere(scene, bh, hit, cfg, key, mesh)
    return direct_lighting_importance(scene, bh, hit, cfg, key, mesh)


def est_radiance(
    scene: SceneData,
    bh: Optional[BlackHoleParams],
    rays: Rays,
    cfg: RenderConfig,
    key,
    with_stats: bool = False,
    mesh=None,
):
    """est_radiance_global_illumination (part1_code.cpp:103-123) for a flat
    batch of camera rays. Returns (..., 3) radiance; with_stats=True also
    returns the summed (2,) measured trace-work counters of every trace
    this estimate issued (kernel-measured; see geometry.trace.trace)."""
    ret = (lambda L, st: (L, st)) if with_stats else (lambda L, st: L)
    hit, stats = _trace(scene, bh, rays, cfg, mesh=mesh)
    miss = ~hit.hit

    if scene.env is not None:
        L_miss = envlib.sample_dir(scene.env, rays.d)  # ORIGINAL direction
    else:
        L_miss = jnp.zeros_like(rays.d)
    L = jnp.where(miss[..., None], L_miss, 0.0)

    if cfg.illum == Illum.NORMAL:
        # normal_shading(isect.n): raw interpolated normal (pathtracer.h:199)
        ns = hit.n * 0.5 + 0.5
        return ret(jnp.where(hit.hit[..., None], ns, L), stats)

    if cfg.illum == Illum.DIRECT:
        key, k = jax.random.split(key)
        Ld, st_d = _direct(scene, bh, hit, cfg, k, mesh)
        return ret(L + Ld, stats + st_d)

    md = cfg.max_ray_depth

    if cfg.illum == Illum.FULL:
        L = L + bsdflib.emission(scene.bsdfs, hit.bsdf_id)  # zero bounce
        if md == 0:
            return ret(L, stats)

    # ---- at_least_one_bounce wavefront ----
    beta = jnp.ones_like(rays.d)
    alive = hit.hit
    delta = bsdflib.is_delta(scene.bsdfs, hit.bsdf_id)

    def vertex(carry, kk, first, do_bounce, rr):
        """One path vertex: NEE (+ optional RR'd BSDF bounce).

        `first`, `do_bounce`, `rr` are static: the first vertex always
        bounces (no coin) yet still divides by 0.7 — the reference applies
        the RR weight unconditionally (part1_code.cpp:97).
        """
        (L, beta, alive, hit, stats) = carry
        k_nee, k_coin, k_bsdf = jax.random.split(kk, 3)
        delta = bsdflib.is_delta(scene.bsdfs, hit.bsdf_id)

        do_nee = alive & ~delta
        if not (first and cfg.illum == Illum.INDIRECT):
            nee, st_n = _direct(scene, bh, hit, cfg, k_nee, mesh)
            L = L + jnp.where(do_nee[..., None], beta * nee, 0.0)
            stats = stats + st_n

        if not do_bounce:
            return (L, beta, alive, hit, stats)

        cont = alive
        if rr:
            coin = jax.random.uniform(k_coin, alive.shape) < RR_PROB
            cont = cont & coin

        fx, fy, fz = _frames(hit)
        wo = m3.to_local(fx, fy, fz, hit.w_out)
        smp = bsdflib.sample(scene.bsdfs, hit.bsdf_id, wo, k_bsdf,
                             microfacet_hemi=cfg.microfacet_hemi)
        cont = cont & (smp.pdf > 0)
        wi_w = m3.to_world(fx, fy, fz, smp.wi)
        nxt = Rays(
            o=hit.p + cfg.ray_eps * wi_w,
            d=wi_w,
            min_t=jnp.zeros_like(hit.t),
            max_t=jnp.full_like(hit.t, jnp.inf),
        )
        nxt = _mask_rays(nxt, cont, bh)
        h2, st_b = _trace(scene, bh, nxt, cfg, mesh=mesh)
        stats = stats + st_b
        cont = cont & h2.hit
        w = smp.value * (jnp.abs(smp.wi[..., 2:3])
                         / jnp.maximum(smp.pdf, 1e-30)[..., None]) / RR_PROB
        beta2 = beta * w
        # delta BSDFs pick up the next hit's emission explicitly
        emit2 = bsdflib.emission(scene.bsdfs, h2.bsdf_id)
        L = L + jnp.where((cont & delta)[..., None], beta2 * emit2, 0.0)
        return (L, jnp.where(cont[..., None], beta2, beta), cont, h2, stats)

    # vertex d=md: NEE + unconditional bounce (when md >= 2)
    key, k0 = jax.random.split(key)
    carry = vertex((L, beta, alive, hit, stats), k0,
                   first=True, do_bounce=md >= 2, rr=False)

    # vertices d=md-1 .. 2: NEE + RR bounce
    if md >= 3:
        key, ks = jax.random.split(key)
        keys = jax.random.split(ks, md - 2)

        def scan_body(carry, kk):
            return vertex(carry, kk, first=False, do_bounce=True,
                          rr=True), None

        # RRT_UNROLL_DEBUG=1 unrolls the scan so jax_debug_nans can
        # attribute NaNs to a concrete op inside a vertex (lax.scan hides
        # the failing primitive behind one opaque 'scan' frame)
        import os
        if os.environ.get("RRT_UNROLL_DEBUG"):
            for _i in range(md - 2):
                carry = vertex(carry, keys[_i], first=False,
                               do_bounce=True, rr=True)
        else:
            carry, _ = jax.lax.scan(scan_body, carry, keys)

    # final vertex d == 1: NEE only
    if md >= 2:
        key, k_last = jax.random.split(key)
        carry = vertex(carry, k_last, first=False, do_bounce=False, rr=False)

    return ret(carry[0], carry[4])
