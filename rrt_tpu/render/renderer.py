"""Render driver: the replacement for the reference's tile scheduler.

The reference fills a mutex-guarded WorkQueue with 32×32 tiles and spawns
worker std::threads (`pathtracer.cpp:224-282`, `work_queue.h`). Here a
render is a host loop over *sample passes*: each pass traces one or more
jittered samples for every pixel as a single jitted megabatch (optionally
sharded over a device mesh), accumulating into device buffers. Adaptive
sampling (`part1_code.cpp:147-159`) runs the same passes with per-pixel
stop masks: converged pixels stop accumulating (their sample count
freezes), keeping every pass the same static shape.

Render lifecycle (reference `stop()`/`continueRaytracing`,
pathtracer.cpp:180-202):
  * `stop()` (or Ctrl-C) cancels cleanly between passes;
  * `checkpoint_path=` persists the accumulator + pass index so an
    interrupted render resumes bit-exactly (per-pass PRNG keys derive only
    from (seed, pass index), so resume == uninterrupted);
  * `preview_path=` writes a progressive partial-frame PNG during the
    render — the analog of the viewer's `update_screen` blit
    (pathtracer.cpp:156-178).

Cell rendering (`-p x y dx dy`, pathtracer.cpp:583-609) generates rays
ONLY for the cell rectangle, so wall-time scales with cell area.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rrt_tpu.render import film
from rrt_tpu.render.integrator import est_radiance
from rrt_tpu.render.integrator import _mask_rays as _mask_lanes
from rrt_tpu.scene.camera import Camera
from rrt_tpu.types import BlackHoleParams, Rays, SceneData
from rrt_tpu.utils.config import RenderConfig


def make_black_hole(cfg: RenderConfig, dtype=jnp.float32) -> Optional[BlackHoleParams]:
    b = cfg.black_hole
    if not b.enabled:
        return None
    return BlackHoleParams(
        position=jnp.asarray(b.position, dtype),
        radius=jnp.asarray(b.radius, dtype),
        delta_theta=jnp.asarray(b.delta_theta, dtype),
        enabled=True,
    )


class RenderCancelled(Exception):
    """Raised (optionally) when a render is stopped before completion."""


class Renderer:
    """Progressive whole-frame renderer with adaptive sampling."""

    def __init__(self, scene: SceneData, camera: Camera, cfg: RenderConfig,
                 sharding=None):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.bh = make_black_hole(cfg)
        self.sharding = sharding
        # shard_map mesh for the trace: every traversal reshape/sort runs
        # shard-local (no cross-device collectives; see trace._trace_sharded)
        self.mesh = sharding.mesh if sharding is not None else None
        self.lane_axis = (sharding.spec[0]
                          if sharding is not None and sharding.spec
                          else "batch")
        self._pass_fns = {}  # (samples-per-pass k, rw, rh) -> jitted fn
        self._stop = False
        from rrt_tpu.utils.stats import PhaseTimer
        self.timer = PhaseTimer()   # compile / passes / io phases

    def stop(self):
        """Request clean cancellation between passes (the reference's
        `stop()` → `continueRaytracing=false`, pathtracer.cpp:180-202)."""
        self._stop = True

    def _pass_fn(self, k: int, rw: int, rh: int):
        """One compiled program serves every pass of the render: the
        region/band origin and the number of live samples are dynamic
        arguments, so cells, row bands and the tail pass all share it
        (no per-shape recompiles)."""
        fn = self._pass_fns.get((k, rw, rh))
        if fn is None:
            fn = jax.jit(
                functools.partial(self._sample_pass, k=k, rw=rw, rh=rh),
                donate_argnums=(0,))
            self._pass_fns[(k, rw, rh)] = fn
        return fn

    # -------------------------------------------------------- pass kernel

    def _rays_for(self, xy_jitter, key, k: int, rw: int, rh: int, origin):
        cfg, cam = self.cfg, self.camera
        x0 = origin[0].astype(jnp.float32)
        y0 = origin[1].astype(jnp.float32)
        ys, xs = jnp.meshgrid(
            y0 + jnp.arange(rh, dtype=jnp.float32),
            x0 + jnp.arange(rw, dtype=jnp.float32), indexing="ij")
        px = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
        if k > 1:
            px = jnp.tile(px, (k, 1))
        m = px.shape[0]
        if xy_jitter.shape[0] != m:          # centered single-sample case
            xy_jitter = jnp.broadcast_to(xy_jitter[:1], (m, 2))
        xy = (px + xy_jitter) / jnp.array([cfg.width, cfg.height],
                                          jnp.float32)
        if cfg.thin_lens:
            k1, k2 = jax.random.split(key)
            rnd_r = jax.random.uniform(k1, (m,))
            rnd_th = jax.random.uniform(k2, (m,)) * 2.0 * jnp.pi
            return cam.generate_rays_thin_lens(xy, rnd_r, rnd_th)
        return cam.generate_rays(xy)

    def _sample_pass(self, acc, key, sample_idx, n_valid, origin,
                     k: int, rw: int, rh: int):
        """Trace `k` jittered samples for every pixel of a rw×rh window at
        `origin` (dynamic (x0, y0)) in ONE megabatch (k·N lanes),
        masked-accumulate.

        acc = (radiance_sum (N,3), s1, s2, count, done) with N = rw·rh.
        `sample_idx` is the first sample index of the pass; `n_valid ≤ k`
        (dynamic) is how many of the k samples are live — the tail pass
        runs the same program with its surplus samples masked out instead
        of compiling a second, smaller one. When adaptive, k divides
        samples_per_batch so convergence tests still happen exactly at
        batch boundaries (part1_code.cpp:147-159).
        """
        cfg = self.cfg
        rad_sum, s1, s2, count, done = acc
        k_jit, k_lens, k_rad = jax.random.split(key, 3)
        n = rw * rh
        if cfg.ns_aa == 1:
            jitter = jnp.full((n, 2), 0.5, jnp.float32)
        else:
            jitter = jax.random.uniform(k_jit, (k * n, 2), jnp.float32)
        rays = self._rays_for(jitter, k_lens, k, rw, rh, origin)
        # done pixels (converged under adaptive sampling, or off-frame
        # band padding) still occupy lanes but their camera rays are
        # terminated immediately — after the kernel's lane sort they pack
        # into tiles the traversal skips, so convergence actually saves
        # device time, not just accumulation.
        active = ~done
        valid_k = jnp.arange(k) < n_valid                    # (k,)
        lane_live = jnp.tile(active, (k,)) & jnp.repeat(valid_k, n)
        rays = _mask_lanes(rays, lane_live, self.bh)
        if self.sharding is not None:
            rays = jax.lax.with_sharding_constraint(rays, self.sharding)
        L, tstats = est_radiance(self.scene, self.bh, rays, cfg, k_rad,
                                 with_stats=True, mesh=self.mesh)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        L = L.reshape(k, n, 3)
        L = jnp.where(valid_k[:, None, None], L, 0.0)

        rad_sum = rad_sum + jnp.where(active[:, None], L.sum(0), 0.0)
        illum = (0.2126 * L[..., 0] + 0.7152 * L[..., 1]
                 + 0.0722 * L[..., 2])                       # (k, n)
        s1 = s1 + jnp.where(active, illum.sum(0), 0.0)
        s2 = s2 + jnp.where(active, (illum * illum).sum(0), 0.0)
        count = count + n_valid * active.astype(jnp.int32)

        if cfg.adaptive:
            # convergence test at batch boundaries (part1_code.cpp:147-159):
            # i+1 = count, avg = s1/(i+1), sd² = (s2 − avg·s1)/i
            at_batch = (sample_idx + n_valid) % cfg.samples_per_batch == 0
            i1 = count.astype(jnp.float32)
            avg = s1 / jnp.maximum(i1, 1.0)
            var = (s2 - avg * s1) / jnp.maximum(i1 - 1.0, 1.0)
            sd = jnp.sqrt(jnp.maximum(var, 0.0))
            conv = 1.96 * sd / jnp.sqrt(jnp.maximum(i1, 1.0)) \
                <= cfg.max_tolerance * avg
            done = done | (at_batch & active & conv)

        return (rad_sum, s1, s2, count, done), tstats

    # -------------------------------------------------------- dispatch plan

    def _planner_constants(self, k, n, calls, lane_cost, n_seg, T):
        """Measured (alpha, beta) for the dispatch cost model.
        Conservative priors decide cheaply whether the budget
        could bind at all; only then is the one-shot trace probe run (and
        persisted per device+backend in the JAX cache dir). Tests can
        inject `self._cal_runner` (a fake-clock probe)."""
        from rrt_tpu.utils import dispatch_cal as dc
        # with 2x-safety priors, does the largest candidate dispatch fit?
        est_prior = calls * (2 * dc.PRIOR_ALPHA) \
            + k * n * lane_cost * (2 * dc.PRIOR_BETA)
        runner = getattr(self, "_cal_runner", None)
        if est_prior <= T and runner is None:
            return dc.PRIOR_ALPHA, dc.PRIOR_BETA
        from rrt_tpu.utils.jax_cache import cache_dir as _cache_dir
        dev = jax.devices()[0]
        cache_dir = _cache_dir()
        backend = self.cfg.trace_backend
        if runner is None:
            def runner_factory():
                return dc.make_trace_runner(
                    self.scene, self.bh, n_seg, backend)
            # only build the real probe outside the env-override/cache
            # fast paths (building it costs nothing, running it compiles)
            runner = None
            if not (os.environ.get("RRT_DISPATCH_ALPHA")
                    or os.environ.get("RRT_DISPATCH_BETA")
                    or os.path.exists(dc.cache_path(
                        cache_dir, dev.device_kind, backend))):
                runner = runner_factory()
        return dc.load_or_calibrate(
            cache_dir, dev.device_kind, backend, runner,
            lane_cost_unit=n_seg)

    def _dispatch_plan(self, n: int, rw: int, rh: int):
        """Bound per-dispatch device work, so that heavy settings (many
        light samples, deep paths) still return to the host between
        passes for previews, checkpoints and cancellation.

        Cost model per pass: `calls` sequential trace invocations at ALPHA
        seconds fixed cost each, plus BETA seconds per traced
        lane-segment. Returns (k samples/pass, band_rows, n_bands): k is
        capped so one whole-window pass fits `cfg.max_dispatch_seconds`;
        if even k=1 does not fit, the frame is split into row bands
        rendered as separate dispatches per pass.
        """
        cfg = self.cfg
        k = max(1, min(cfg.ns_aa, cfg.max_pass_lanes // max(n, 1)))
        if cfg.adaptive:
            while cfg.samples_per_batch % k != 0:
                k -= 1
        T = float(getattr(cfg, "max_dispatch_seconds", 0.0) or 0.0)
        if T <= 0.0:
            return k, rh, 1
        from rrt_tpu.physics import schwarzschild as ss
        from rrt_tpu.render.lights import is_delta_light
        n_seg = ss.n_segments(cfg.black_hole.delta_theta) \
            if cfg.black_hole.enabled else 1
        S = sum(
            1 if is_delta_light(self.scene.lights, i) else cfg.ns_area_light
            for i in range(len(self.scene.lights.kind_host)))
        if cfg.illum == 0:           # NORMAL: one camera trace, no shading
            depth_eff = 0
        elif cfg.illum == 1:         # DIRECT: one NEE round
            depth_eff = 1
        else:
            depth_eff = max(1, cfg.max_ray_depth)
        nee_traces = -(-S // max(1, cfg.nee_chunk)) if S else 0
        calls = 1 + depth_eff * (nee_traces + 1)
        lane_cost = n_seg * (1 + depth_eff * (S + 1))
        alpha, beta = self._planner_constants(
            k, n, calls, lane_cost, n_seg, T)
        fixed = calls * alpha

        def est(kk, lanes):
            return fixed + kk * lanes * lane_cost * beta

        while k > 1 and est(k, n) > T:
            k -= 1
            if cfg.adaptive:
                while cfg.samples_per_batch % k != 0:
                    k -= 1
        if est(1, n) <= T or rh <= 1:
            return k, rh, 1
        # row bands: shrink the per-dispatch lane count; the fixed
        # per-call cost is irreducible, so aim the variable term at
        # whatever budget headroom remains (at least a quarter of T)
        room = max(T - fixed, 0.25 * T)
        B = min(rh, max(2, int(-(-(n * lane_cost * beta) // room))))
        band_rows = -(-rh // B)
        return 1, band_rows, -(-rh // band_rows)

    # -------------------------------------------------------- checkpoints

    def _fingerprint(self, region):
        cfg = self.cfg
        return np.array([cfg.width, cfg.height, cfg.ns_aa, cfg.seed,
                         *region], np.int64)

    def save_checkpoint(self, path: str, accs, s: int, region):
        """Persist the (band-concatenated, unpadded) accumulator."""
        n = region[2] * region[3]
        cat = [np.concatenate([np.asarray(a[i]) for a in accs])[:n]
               for i in range(5)]
        rad_sum, s1, s2, count, done = cat
        tmp = path + ".tmp.npz"
        np.savez(tmp, rad_sum=rad_sum, s1=s1, s2=s2, count=count, done=done,
                 s=np.int64(s), fingerprint=self._fingerprint(region))
        os.replace(tmp, path)

    def load_checkpoint(self, path: str, region, band_rows=None,
                        n_bands=1):
        if band_rows is None:
            band_rows = region[3]
        z = np.load(path)
        if not np.array_equal(z["fingerprint"], self._fingerprint(region)):
            raise ValueError(
                f"checkpoint {path} does not match this render config")
        acc = (z["rad_sum"], z["s1"], z["s2"], z["count"], z["done"])
        accs = self._split_bands(acc, region, band_rows, n_bands)
        return accs, int(z["s"])

    def _split_bands(self, acc_np, region, band_rows, n_bands):
        """(n,)-lane host arrays → per-band device accumulators (padded
        rows appended to the last band, marked done)."""
        rw, rh = region[2], region[3]
        n = rw * rh
        m = band_rows * rw
        pad = n_bands * m - n
        accs = []
        for b in range(n_bands):
            sl = slice(b * m, min((b + 1) * m, n))
            parts = []
            for i, a in enumerate(acc_np):
                seg = np.asarray(a[sl])
                if seg.shape[0] < m:
                    fill = np.ones if i == 4 else np.zeros  # pads are done
                    seg = np.concatenate(
                        [seg, fill((m - seg.shape[0],) + seg.shape[1:],
                                   seg.dtype)])
                parts.append(jnp.asarray(seg))
            accs.append(tuple(parts))
        return accs

    # -------------------------------------------------------- driver

    def render(self, progress=None, region=None, checkpoint_path=None,
               checkpoint_every: Optional[int] = None,
               preview_path=None, preview_every: Optional[int] = None,
               resume: bool = False, stop_after: Optional[int] = None,
               control=None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Render `region` (default full frame). Returns
        (hdr (rh,rw,3), sample_count (rh,rw)).

        checkpoint_path/-_every: persist the accumulator every N samples
        (and on cancellation); `resume=True` continues from the checkpoint.
        preview_path/-_every: write a progressive PNG every N samples.
        stop_after: cancel after that many samples (test hook for the
        cancellation path).
        control: optional mutable mapping polled between passes — the
        runtime key_press analog (pathtracer.cpp:463-547) driven by
        `--serve`'s POST /control: {"stop": True} cancels cleanly,
        {"spp_cap": N} finishes early at N samples/pixel,
        {"preview_every": N} changes the preview cadence live.
        """
        cfg = self.cfg
        if region is None:
            region = (0, 0, cfg.width, cfg.height)
        region = tuple(int(v) for v in region)
        x0, y0, rw, rh = region
        n = rw * rh
        # samples per pass + row-band split, bounded per dispatch.
        # NOTE: the plan must depend only on config+scene — per-(pass,band)
        # PRNG keys derive from (pass first-sample index, band index), so
        # resume bit-matches an uninterrupted render only if the partition
        # is identical. Checkpoints/previews/stops land on pass boundaries.
        k, band_rows, n_bands = self._dispatch_plan(n, rw, rh)
        m = band_rows * rw                  # lanes per band dispatch
        s = 0
        accs = None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            accs, s = self.load_checkpoint(
                checkpoint_path, region, band_rows, n_bands)
        if accs is None:
            zero = (np.zeros((n, 3), np.float32), np.zeros(n, np.float32),
                    np.zeros(n, np.float32), np.zeros(n, np.int32),
                    np.zeros(n, bool))
            accs = self._split_bands(zero, region, band_rows, n_bands)
        base = jax.random.key(cfg.seed)
        # measured kernel work counters, accumulated ON DEVICE across all
        # passes (no per-pass host sync); pulled once at the end
        kstats = jnp.zeros(2, jnp.float32)
        self._stop = False
        cancelled = False
        try:
            while s < cfg.ns_aa:
                ks = min(k, cfg.ns_aa - s)
                first = (k, rw, band_rows) not in self._pass_fns
                ph = "compile+first-pass" if first else "passes"
                fn = self._pass_fn(k, rw, band_rows)
                with self.timer.phase(ph):
                    for b in range(n_bands):
                        kb = jax.random.fold_in(
                            jax.random.fold_in(base, s), b)
                        origin = jnp.array(
                            [x0, y0 + b * band_rows], jnp.int32)
                        accs[b], tstats = fn(
                            accs[b], kb, jnp.asarray(s, jnp.int32),
                            jnp.asarray(ks, jnp.int32), origin)
                        kstats = kstats + tstats
                    if first:
                        jax.block_until_ready(accs[0])
                s += ks
                if cfg.adaptive and s % cfg.samples_per_batch == 0:
                    if all(bool(jnp.all(a[4])) for a in accs):
                        break
                if progress is not None:
                    progress(s, cfg.ns_aa)
                if checkpoint_path and checkpoint_every \
                        and s // checkpoint_every > (s - ks) // checkpoint_every:
                    self.save_checkpoint(checkpoint_path, accs, s, region)
                pv_every = preview_every
                spp_cap = None
                if control is not None:
                    # runtime control (pathtracer.cpp:463-547 analog)
                    if control.get("stop"):
                        self._stop = True
                    pv_every = control.get("preview_every", preview_every)
                    spp_cap = control.get("spp_cap")
                if preview_path and pv_every and s < cfg.ns_aa \
                        and s // pv_every > (s - ks) // pv_every:
                    self._write_preview(preview_path, accs, region)
                if (stop_after is not None and s >= stop_after) \
                        or (spp_cap is not None and s >= int(spp_cap)) \
                        or self._stop:
                    cancelled = True
                    break
        except KeyboardInterrupt:
            # the input accumulator was donated to the in-flight pass; the
            # pass result may or may not have materialized — save
            # best-effort and report the interruption either way
            cancelled = True
        if cancelled and checkpoint_path:
            try:
                self.save_checkpoint(checkpoint_path, accs, s, region)
            except Exception:
                pass  # donated/deleted buffers: keep the last periodic save
        with self.timer.phase("passes"):    # drain in-flight device work
            rad_sum = np.concatenate(
                [np.asarray(a[0]) for a in accs])[:n]
            count = np.concatenate(
                [np.asarray(a[3]) for a in accs])[:n].reshape(rh, rw)
        hdr = (rad_sum.reshape(rh, rw, 3)
               / np.maximum(count[..., None], 1))
        self.last_sample_count = count
        self.last_kernel_stats = np.asarray(kstats)
        self.samples_done = s
        self.cancelled = cancelled
        return hdr, count

    def _write_preview(self, path: str, accs, region):
        x0, y0, rw, rh = region
        n = rw * rh
        rad_sum = np.concatenate([np.asarray(a[0]) for a in accs])[:n]
        count_np = np.concatenate(
            [np.asarray(a[3]) for a in accs])[:n].reshape(rh, rw)
        hdr = (rad_sum.reshape(rh, rw, 3)
               / np.maximum(count_np[..., None], 1))
        film.save_image(path, hdr)

    def stats(self, wall_seconds: float = 0.0):
        """Trace-count accounting (reference total_rays analog,
        pathtracer.cpp:637-638). Counts are exact: every lane is traced in
        lockstep, and the per-pixel sample counter is the measured one."""
        from rrt_tpu.render.lights import is_delta_light
        from rrt_tpu.utils.stats import expected_stats
        nls = sum(
            1 if is_delta_light(self.scene.lights, i) else
            self.cfg.ns_area_light
            for i in range(len(self.scene.lights.kind_host)))
        counts = getattr(self, "last_sample_count", None)
        if counts is not None:
            total_samples = int(counts.sum())
        else:
            total_samples = (self.cfg.ns_aa
                             * self.cfg.width * self.cfg.height)
        st = expected_stats(self.cfg, nls, total_lane_samples=total_samples)
        st.wall_seconds = wall_seconds
        ks = getattr(self, "last_kernel_stats", None)
        if ks is not None:
            st.measured_isect_tests = float(ks[0])
            st.measured_bbox_tests = float(ks[1])
        return st

    def render_cell(self, x, y, dx, dy, **kw) -> np.ndarray:
        """Re-render a sub-rectangle (`-p x y dx dy`, pathtracer.cpp:583-609).
        Rays are generated only for the cell: wall-time ∝ cell area."""
        hdr, _ = self.render(region=(x, y, dx, dy), **kw)
        return hdr

    def render_to_file(self, path: str, cell=None, progress=None, **kw):
        """Headless render → PNG (+ the reference's unconditional
        sampling-rate heatmap companion, pathtracer.cpp:684)."""
        if cell is not None:
            x, y, dx, dy = cell
            hdr_cell, count_cell = self.render(
                region=(x, y, dx, dy), progress=progress, **kw)
            hdr = np.zeros((self.cfg.height, self.cfg.width, 3), np.float32)
            hdr[y:y + dy, x:x + dx] = hdr_cell
            count = np.zeros((self.cfg.height, self.cfg.width), np.int32)
            count[y:y + dy, x:x + dx] = count_cell
        else:
            hdr, count = self.render(progress=progress, **kw)
        film.save_image(path, hdr)
        base = path[:-4] if path.endswith(".png") else path
        film.save_sampling_rate_image(base + "_rate.png", count, self.cfg.ns_aa)
        return hdr
