"""Trace microbenchmark: the fused kernel against the XLA path.

For each scene, on camera rays and on bounce rays (`side`² lanes each),
flat and curved: the kernel's and the XLA path's steady-state time per
trace (median of `--reps` calls after a warm-up call, each ending in
`block_until_ready`), the kernel's measured primitive and box tests per
ray, and the agreement check of `rrt_tpu/ops/kernel_check.py`. With
`--render`, also one full `Renderer.render()` per backend at the bench's
primary settings, timed after a compiling render. A GPU is required.

Usage:
  python tools/kbench.py [--side 256] [--scenes a,b] [--lanes 64]
                         [--reps 5] [--render]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rrt_tpu.geometry import trace as T  # noqa: E402
from rrt_tpu.ops import kernel_check as kc  # noqa: E402
from rrt_tpu.ops.trace_kernel import pallas_trace  # noqa: E402
from rrt_tpu.scene.build import load_scene  # noqa: E402
from rrt_tpu.scene.cornell import scene_path  # noqa: E402
from rrt_tpu.types import BlackHoleParams  # noqa: E402
from rrt_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def median_time(f, x, reps):
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--scenes", default="cornell_lambertian,cornell_blob")
    ap.add_argument("--lanes", default="64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kbench needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card()}", flush=True)
    bh = BlackHoleParams(position=jnp.array([0.0, 1.0, 0.0], jnp.float32),
                         radius=jnp.float32(0.1),
                         delta_theta=jnp.float32(0.1))
    n_seg = 63
    rows = []
    for name in args.scenes.split(","):
        scene, cam = load_scene(scene_path(name), args.side, args.side)
        batches = kc.probe_rays(scene, cam, args.side)
        for kind, rays in batches.items():
            n = rays.o.shape[0]
            for curved in (False, True):
                b = bh if curved else None
                xla = jax.jit(lambda r, b=b: T.trace(
                    scene, b, r, n_seg=n_seg, backend="xla").hit)
                t_x = median_time(xla, rays, args.reps)
                for lanes in (int(v) for v in args.lanes.split(",")):
                    kern = jax.jit(lambda r, b=b, lanes=lanes: pallas_trace(
                        scene, b, r, n_seg=n_seg, return_stats=True,
                        lanes=lanes))
                    t_k = median_time(lambda r: kern(r)[0].hit, rays,
                                      args.reps)
                    st = np.asarray(kern(rays)[1]) / n
                    row = {"scene": name, "rays": kind, "lanes_total": n,
                           "mode": "curved" if curved else "flat",
                           "block_lanes": lanes,
                           "kernel_ms": round(t_k * 1e3, 3),
                           "xla_ms": round(t_x * 1e3, 3),
                           "xla_over_kernel": round(t_x / t_k, 2),
                           "prim_tests_per_ray": round(float(st[0]), 1),
                           "box_tests_per_ray": round(float(st[1]), 1)}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                if not args.no_check:
                    res = kc.compare(scene, b, rays, n_seg,
                                     brute_lanes=min(n, 8192))
                    print(json.dumps({"scene": name, "rays": kind,
                                      "mode": row["mode"], "check": res}),
                          flush=True)
    if args.render:
        from rrt_tpu.render.renderer import Renderer
        from rrt_tpu.utils.config import RenderConfig
        scene, cam = load_scene(scene_path("cornell_lambertian"), 256, 256)
        for backend in ("pallas", "xla"):
            cfg = RenderConfig(width=256, height=256, ns_aa=16,
                               ns_area_light=4, max_ray_depth=5, seed=0,
                               trace_backend=backend)
            r = Renderer(scene, cam, cfg)
            t0 = time.perf_counter()
            r.render()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            hdr, _ = r.render()
            dt = time.perf_counter() - t0
            print(json.dumps({"render": "cornell_lambertian 256x256 16spp "
                              "-l 4 -m 5 curved", "backend": backend,
                              "first_s": round(t_first, 3),
                              "steady_s": round(dt, 3),
                              "camera_rays_per_s": round(256 * 256 * 16 / dt),
                              "mean_radiance": float(np.mean(hdr))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
