"""Command-line entry point mirroring the reference binary's flags.

Reference `pathtracer/src/main.cpp:28-150`:

  -s INT        camera rays (samples) per pixel        [1]
  -l INT        samples per area light                 [1]
  -t INT        worker threads (accepted; rendering parallelizes over the
                device's lanes instead)
  -m INT        max ray depth                          [1]
  -e PATH       environment map (.exr)
  -f FILE       headless render to PNG
  -r W H        output resolution                      [800 600]
  -p X Y DX DY  render only a cell
  -c FILE       camera settings dump to load
  -a INT FLOAT  adaptive sampling: batch, tolerance    [32 0.05]
  -H            direct lighting via uniform hemisphere
  -b FLOAT      lens radius (aperture)                 [0.25]
  -d FLOAT      focal distance                         [4.7]
  -B X Y Z R DT black hole position/radius/Δθ          [(0,1,0) 0.1 0.1]

Extensions over the reference:
  --flat        disable spacetime curvature entirely
  --illum N     integrator mode (0 normals / 1 direct / 2 full / 3 indirect)
  --seed N      PRNG seed (the reference used unseeded std::rand())

There is no interactive OpenGL viewer: like `-f`, rendering is headless
(the reference's windowed mode is its course-GUI legacy; see README).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rrt_tpu.scene.build import load_scene
from rrt_tpu.scene.envmap import build_envmap, probability_debug_image
from rrt_tpu.render.renderer import Renderer
from rrt_tpu.utils.config import BlackHoleConfig, Illum, RenderConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rrt_tpu",
        description="Relativistic path tracer in JAX")
    p.add_argument("scene", help="COLLADA .dae scene file")
    p.add_argument("-s", type=int, default=1, dest="ns_aa")
    p.add_argument("-l", type=int, default=1, dest="ns_area_light")
    p.add_argument("-t", type=int, default=1, dest="threads",
                   help="accepted for compatibility; unused")
    p.add_argument("-m", type=int, default=1, dest="max_ray_depth")
    p.add_argument("-e", dest="envmap", default=None)
    p.add_argument("-f", dest="outfile", default="out.png")
    p.add_argument("-r", nargs=2, type=int, default=[800, 600],
                   metavar=("W", "H"))
    p.add_argument("-p", nargs=4, type=int, default=None,
                   metavar=("X", "Y", "DX", "DY"))
    p.add_argument("-c", dest="cam_settings", default=None)
    p.add_argument("-a", nargs=2, default=None, metavar=("BATCH", "TOL"))
    p.add_argument("-H", dest="hemisphere", action="store_true")
    p.add_argument("-b", type=float, default=0.25, dest="lens_radius")
    p.add_argument("-d", type=float, default=4.7, dest="focal_distance")
    p.add_argument("-B", nargs=5, type=float, default=None,
                   metavar=("X", "Y", "Z", "R", "DTHETA"))
    p.add_argument("--flat", action="store_true",
                   help="disable black-hole ray bending")
    p.add_argument("--illum", type=int, default=Illum.FULL)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--thin-lens", action="store_true")
    # lifecycle extensions (reference stop()/update_screen analogs)
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="write a progressive preview PNG during the render")
    p.add_argument("--preview-every", type=int, default=1, metavar="N",
                   help="preview update interval in samples/pixel")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="checkpoint file: saved periodically and on Ctrl-C; "
                        "pass --resume to continue from it")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="N",
                   help="checkpoint interval in samples/pixel")
    p.add_argument("--dump-accel", default=None, metavar="BASE",
                   help="write BASE_accel.json (cluster AABB table) and "
                        "BASE_accel.png (per-pixel touched-cluster "
                        "heatmap) — the BVH-visualizer analog "
                        "(pathtracer.cpp:330-423)")
    p.add_argument("--dump-rays", default=None, metavar="BASE",
                   help="write BASE_raylog.npz + hit/cost/segment PNG "
                        "panels for every camera ray (winning segment, "
                        "segments marched, clusters touched, hit/miss/"
                        "absorbed) — the rayLog + ray-drawing analog "
                        "(pathtracer.cpp:395-418)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--serve", type=int, nargs="?", const=8000, default=None,
                   metavar="PORT",
                   help="serve a live auto-refreshing progressive preview "
                        "over HTTP while rendering (0 = ephemeral port) — "
                        "the interactive-viewer analog "
                        "(CGL/src/viewer.cpp:142-170)")
    p.add_argument("--serve-wait", action="store_true",
                   help="with --serve: keep serving after the render "
                        "finishes until Ctrl-C")
    return p


def config_from_args(args) -> RenderConfig:
    if args.B is not None:
        bh = BlackHoleConfig(
            position=tuple(args.B[:3]), radius=args.B[3],
            delta_theta=args.B[4], enabled=not args.flat)
    else:
        bh = BlackHoleConfig(enabled=not args.flat)
    adaptive = args.a is not None
    spb, tol = (int(args.a[0]), float(args.a[1])) if adaptive else (32, 0.05)
    return RenderConfig(
        ns_aa=args.ns_aa,
        ns_area_light=args.ns_area_light,
        max_ray_depth=args.max_ray_depth,
        width=args.r[0], height=args.r[1],
        samples_per_batch=spb, max_tolerance=tol, adaptive=adaptive,
        direct_hemisphere_sample=args.hemisphere,
        lens_radius=args.lens_radius,
        focal_distance=args.focal_distance,
        thin_lens=args.thin_lens,
        illum=args.illum,
        black_hole=bh,
        seed=args.seed,
    )


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)

    # persistent compilation cache: a warm second run skips the compile
    from rrt_tpu.utils.jax_cache import enable_compile_cache
    enable_compile_cache()

    env = None
    if args.envmap:
        from rrt_tpu.io.exr import read_exr
        from rrt_tpu.io.png import write_png
        print(f"[PathTracer] Loading environment map {args.envmap}")
        env = build_envmap(read_exr(args.envmap))
        # the reference writes probability_debug.png unconditionally on
        # env-light init (environment_light.cpp:44-47)
        write_png("probability_debug.png", probability_debug_image(env))

    print(f"[PathTracer] Input scene file: {args.scene}")
    t0 = time.time()
    scene, camera = load_scene(
        args.scene, cfg.width, cfg.height, env=env)
    print(f"[PathTracer] Scene loaded ({time.time()-t0:.2f} sec), "
          f"{scene.n_tris} tri rows, {scene.n_spheres} sphere rows")

    if args.cam_settings:
        camera.load_settings(args.cam_settings)
        print(f"[Camera] Loaded settings from {args.cam_settings}")
    camera.lens_radius = cfg.lens_radius
    camera.focal_distance = cfg.focal_distance

    if args.dump_accel:
        from rrt_tpu.utils.accel_viz import dump_accel
        counts = dump_accel(scene, camera, cfg.width, cfg.height,
                            args.dump_accel)
        print(f"[PathTracer] Accel dump: {args.dump_accel}_accel.json/"
              f".png (touched clusters per camera ray: "
              f"mean {counts.mean():.1f}, max {int(counts.max())})")

    if args.dump_rays:
        from rrt_tpu.render.renderer import make_black_hole
        from rrt_tpu.utils.ray_debug import dump_ray_log
        from rrt_tpu.physics.schwarzschild import n_segments
        bh = make_black_hole(cfg)
        ns = n_segments(cfg.black_hole.delta_theta) \
            if cfg.black_hole.enabled else 1
        log = dump_ray_log(scene, bh, camera, cfg.width, cfg.height,
                           args.dump_rays, n_seg=ns)
        hits = int((log["outcome"] == 1).sum())
        absd = int((log["outcome"] == 2).sum())
        print(f"[PathTracer] Ray log: {args.dump_rays}_raylog.npz (+3 "
              f"PNGs); {hits} hit / {absd} absorbed / "
              f"{log['outcome'].size - hits - absd} escaped; touched "
              f"clusters mean {log['clusters'].mean():.1f} "
              f"max {int(log['clusters'].max())}")

    renderer = Renderer(scene, camera, cfg)

    # --serve: live progressive display over HTTP (the interactive
    # viewer analog, CGL/src/viewer.cpp:142-170 / pathtracer.cpp:156-178)
    server = None
    preview_path = args.preview
    if args.serve is not None:
        from rrt_tpu.utils.accel_walk import AccelWalk
        from rrt_tpu.utils.serve import PreviewServer
        if preview_path is None:
            preview_path = args.outfile + ".preview.png"
        # arrow-key accel-structure walk on the page (the reference's
        # VISUALIZE-mode navigation, pathtracer.cpp:330-423, :520-534)
        server = PreviewServer(preview_path, args.serve,
                               accel=AccelWalk(scene, camera)).start()
        server.update(0, cfg.ns_aa)
        print(f"[PathTracer] Live preview: http://localhost:{server.port}/")

    def progress(done, total):
        pct = 100.0 * done / total
        sys.stdout.write(f"\r[PathTracer] Rendering... {pct:.0f}%")
        sys.stdout.flush()
        if server is not None:
            server.update(done, total)

    t0 = time.time()
    renderer.render_to_file(
        args.outfile, cell=args.p, progress=progress,
        preview_path=preview_path,
        preview_every=(args.preview_every
                       if preview_path is not None else None),
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every if args.checkpoint else None,
        resume=args.resume,
        control=server.control if server is not None else None)
    dt = time.time() - t0
    if server is not None:
        import shutil
        shutil.copyfile(args.outfile, preview_path)
        server.update(renderer.samples_done, cfg.ns_aa, done=True)
    if getattr(renderer, "cancelled", False):
        print(f"\n[PathTracer] Rendering cancelled after "
              f"{renderer.samples_done} samples/pixel ({dt:.2f} sec)"
              + (f"; state saved to {args.checkpoint}" if args.checkpoint
                 else ""))
    else:
        print(f"\n[PathTracer] Rendering complete, {dt:.2f} sec")
    print(renderer.stats(dt).report())
    print(f"[PathTracer] Phases: {renderer.timer.report()}")
    print(f"[PathTracer] Saved to {args.outfile}")
    if server is not None:
        if args.serve_wait:
            print(f"[PathTracer] Still serving on "
                  f"http://localhost:{server.port}/ (Ctrl-C to exit)")
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
