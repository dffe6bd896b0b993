"""Benchmark: curved-spacetime global-illumination render throughput.

Primary cell: scenes/cornell_lambertian.dae, 256x256, 16 spp, 4 area-light
samples, max depth 5, default black hole (position (0,1,0), r=0.1,
dtheta=0.1 — curvature on, as the reference binary always runs).
Secondary: scenes/cornell_blob.dae (28,584 triangles) 128x128, 1 spp,
depth 2 — the BVH-scale traversal metric.

Prints ONE JSON line on stdout. Keys:
  value                  — camera rays per second, primary cell
  vs_baseline            — value over the reference CPU binary's 13,318
                           camera rays/s at the primary settings (a
                           2-core host, measured once; kept for history)
  marched_rays_per_sec   — all closest-hit/occlusion traces per second
  geodesic_steps_per_sec — micro-ray march steps per second (63/trace)
  bunny_camera_rays_per_sec — BVH-scale cell camera throughput
  trace_backend          — 'pallas' (the fused kernel) or 'xla'
  device                 — platform, device kind, count, and the card's
                           name and power limit from nvidia-smi

A GPU is required: without one the bench exits non-zero and prints no
result.
"""
import json
import subprocess
import sys
import time

import numpy as np

W = H = 256
SPP = 16
REF_CAMERA_RAYS_PER_SEC = 13318.0  # reference CPU binary, primary settings


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from rrt_tpu.geometry.trace import _resolve_backend
    from rrt_tpu.render.renderer import Renderer
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.utils.config import RenderConfig
    from rrt_tpu.utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    gpu = card()
    backend = _resolve_backend("auto")

    cfg = RenderConfig(width=W, height=H, ns_aa=SPP, ns_area_light=4,
                       max_ray_depth=5, seed=0)
    scene, cam = load_scene(scene_path("cornell_lambertian"), W, H)
    r = Renderer(scene, cam, cfg)
    r.render()                       # compile + first render
    t0 = time.time()
    hdr, _ = r.render()
    dt = time.time() - t0

    n_rays = W * H * SPP
    rays_per_sec = n_rays / dt
    st = r.stats(dt)
    marched_per_sec = st.total_rays / dt
    geo_steps_per_sec = st.total_rays * st.geodesic_segments_max / dt

    bcfg = RenderConfig(width=128, height=128, ns_aa=1, ns_area_light=1,
                        max_ray_depth=2, seed=0)
    bscene, bcam = load_scene(scene_path("cornell_blob"), 128, 128)
    br = Renderer(bscene, bcam, bcfg)
    br.render()                      # compile
    t0 = time.time()
    br.render()
    bdt = time.time() - t0

    out = {
        "metric": "camera_rays_per_sec_curved_gi_256x256_16spp_d5",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REF_CAMERA_RAYS_PER_SEC, 3),
        "marched_rays_per_sec": round(marched_per_sec, 1),
        "geodesic_steps_per_sec": round(geo_steps_per_sec, 1),
        "bunny_camera_rays_per_sec": round(128 * 128 / bdt, 1),
        "trace_backend": backend,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": gpu},
    }
    print(json.dumps(out))
    print(f"# card={gpu} wall={dt:.3f}s bunny_wall={bdt:.3f}s "
          f"mean_radiance={float(np.mean(hdr)):.4f} "
          f"phases[{r.timer.report()}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
