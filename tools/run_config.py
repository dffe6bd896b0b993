"""Run one render configuration end-to-end and print a stats JSON line.

Usage:
  python tools/run_config.py SCENE --size 512 512 --spp 64 -l 1 -m 5 \
      [--backend pallas|xla] [--flat] [--out x.png] [--seed 0]

SCENE is a .dae path or the name of a committed scene (scenes/NAME.dae,
e.g. cornell_blob). Timing separates compile (first pass) from steady
state via the renderer's PhaseTimer; the JSON line reports wall, camera
rays/s, marched (trace) rays/s and geodesic steps/s.
"""
import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--size", type=int, nargs=2, default=[512, 512])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("-l", "--light-samples", type=int, default=1)
    ap.add_argument("-m", "--depth", type=int, default=5)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--flat", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pass-lanes", type=int, default=None,
                    help="cap lanes per jitted pass")
    args = ap.parse_args()

    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.render.renderer import Renderer
    from rrt_tpu.render import film
    from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig

    W, H = args.size
    cfg = RenderConfig(
        width=W, height=H, ns_aa=args.spp, ns_area_light=args.light_samples,
        max_ray_depth=args.depth, seed=args.seed,
        trace_backend=args.backend,
        black_hole=BlackHoleConfig(enabled=not args.flat),
        **({"max_pass_lanes": args.max_pass_lanes}
           if args.max_pass_lanes else {}))
    path = args.scene if args.scene.endswith(".dae") \
        else scene_path(args.scene)
    scene, cam = load_scene(path, W, H)
    r = Renderer(scene, cam, cfg)
    t0 = time.time()
    hdr, count = r.render(progress=lambda s, t: print(
        f"# {s}/{t} samples t={time.time()-t0:.0f}s", file=sys.stderr,
        flush=True))
    wall = time.time() - t0
    st = r.stats(wall)
    compile_s = r.timer.phases.get("compile+first-pass", 0.0)
    steady = r.timer.phases.get("passes", 0.0)
    n_cam = st.camera_rays
    out = {
        "scene": args.scene.rsplit("/", 1)[-1],
        "config": f"{W}x{H} {args.spp}spp l{args.light_samples} "
                  f"d{args.depth} {'flat' if args.flat else 'curved'}",
        "backend": cfg.trace_backend,
        "wall_s": round(wall, 1),
        "compile_s": round(compile_s, 1),
        "steady_s": round(steady, 1),
        "camera_rays_per_sec": round(n_cam / max(steady, 1e-9), 1),
        "marched_rays_per_sec": round(st.total_rays / max(steady, 1e-9), 1),
        "geodesic_steps_per_sec": round(
            st.total_rays * st.geodesic_segments_max / max(steady, 1e-9), 1),
        "total_traces": st.total_rays,
        "mean_radiance": round(float(hdr.mean()), 5),
    }
    if args.out:
        film.save_image(args.out, hdr)
    print(json.dumps(out))
    print("# " + st.report().replace("\n", " | "), file=sys.stderr)


if __name__ == "__main__":
    main()
