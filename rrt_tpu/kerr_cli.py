"""CLI for the Kerr black-hole + accretion-disk scene.

    python -m rrt_tpu.kerr_cli -f kerr.png -r 1024 1024 --mass 1 --spin 0.9 \
        --eye 0 3 22 --steps 600 -s 4

New physics beyond the reference (no Kerr, no disk there).
"""
from __future__ import annotations

import argparse
import sys
import time

import jax.numpy as jnp
import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="rrt_tpu.kerr_cli")
    p.add_argument("-f", dest="outfile", default="kerr.png")
    p.add_argument("-r", nargs=2, type=int, default=[512, 512],
                   metavar=("W", "H"))
    p.add_argument("-s", dest="spp", type=int, default=1)
    p.add_argument("-e", dest="envmap", default=None, help=".exr envmap")
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--spin", type=float, default=0.9)
    p.add_argument("--disk", nargs=2, type=float, default=[3.0, 12.0],
                   metavar=("R_IN", "R_OUT"))
    p.add_argument("--no-beaming", action="store_true")
    p.add_argument("--eye", nargs=3, type=float, default=[0.0, 3.0, 22.0])
    p.add_argument("--fov", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="lane-shard batches over all devices "
                        "(parallel/sharding mesh)")
    args = p.parse_args(argv)

    from rrt_tpu.physics import kerr
    from rrt_tpu.render import film
    from rrt_tpu.render import kerr_scene as K
    from rrt_tpu.utils.jax_cache import enable_compile_cache
    enable_compile_cache()

    env = None
    if args.envmap:
        from rrt_tpu.io.exr import read_exr
        from rrt_tpu.scene.envmap import build_envmap
        env = build_envmap(read_exr(args.envmap))

    bh = kerr.KerrParams(
        position=jnp.zeros(3),
        mass=jnp.asarray(args.mass, jnp.float32),
        spin=jnp.asarray(args.spin, jnp.float32))
    disk = K.DiskParams(
        r_in=jnp.asarray(args.disk[0], jnp.float32),
        r_out=jnp.asarray(args.disk[1], jnp.float32),
        emission=jnp.asarray([1.0, 0.85, 0.6], jnp.float32),
        q=jnp.asarray(2.0, jnp.float32),
        beaming=not args.no_beaming)

    w, h = args.r
    print(f"[KerrTracer] {w}x{h}, {args.spp} spp, M={args.mass}, "
          f"a={args.spin}, steps={args.steps}")
    t0 = time.time()
    sharding = None
    if args.sharded:
        from rrt_tpu.parallel import sharding as sh
        mesh = sh.make_mesh()
        sharding = sh.batch_sharding(mesh)
        print(f"[KerrTracer] lane-sharded over {mesh.devices.size} device(s)")
    img = K.render_image(w, h, bh, disk, eye=tuple(args.eye),
                         fov_deg=args.fov, env=env, spp=args.spp,
                         seed=args.seed, n_steps=args.steps,
                         sharding=sharding)
    dt = time.time() - t0
    n_rays = w * h * args.spp
    print(f"[KerrTracer] {dt:.1f}s — {n_rays/dt:.3g} rays/s, "
          f"{n_rays*args.steps/dt:.3g} RK4 steps/s")
    film.save_image(args.outfile, img[::-1])
    print(f"[KerrTracer] Saved {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
