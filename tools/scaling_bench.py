"""Scaling harness: lane-sharded render throughput vs device/process count.

Referenced by tests/mp_worker.py. Two modes:

  default (CPU): for each (processes, local-devices) config, spawn that
    many REAL OS processes federated by jax.distributed over a localhost
    coordinator (the code path a multi-host deployment takes), each
    with `--devices` virtual CPU devices; every process renders its lane
    shard of a fixed WHOLE-frame forward pass (weak-per-device scaling is
    meaningless on a 2-core host, so the table reports aggregate
    lanes/sec and per-config efficiency vs the 1x1 run — on shared cores
    this measures SPMD/federation OVERHEAD, not hardware speedup; the
    >=0.8 scaling target needs real chips).

  --single: one-device overhead check on the default device — the same
    jitted forward with and without the NamedSharding constraint on a
    1-device mesh (sharded and unsharded must cost the same; a gap means
    the sharding layer itself burns time).

Usage:
  python tools/scaling_bench.py [--size 64] [--configs 1x1,1x2,1x4,2x2,1x8]
  PYTHONPATH=. python tools/scaling_bench.py --single [--size 128]
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_config(nproc: int, ndev: int, size: int, tmpdir: str):
    """Spawn nproc federated processes x ndev local devices; return
    (total_lanes, max_worker_seconds)."""
    port = _free_port()
    env = dict(os.environ)
    env.update(
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
    )
    outs = [os.path.join(tmpdir, f"sb_{nproc}x{ndev}_{i}.npz")
            for i in range(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nproc), str(port),
             outs[i], str(size)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {i} of {nproc}x{ndev} failed:\n"
                + out.decode(errors="replace")[-2000:])
    dts = [float(np.load(o)["dt"]) for o in outs]
    return size * size, max(dts)


def main_cpu(args):
    import tempfile
    configs = []
    for c in args.configs.split(","):
        p, d = c.strip().split("x")
        configs.append((int(p), int(d)))
    rows = []
    with tempfile.TemporaryDirectory() as td:
        for nproc, ndev in configs:
            lanes, dt = run_config(nproc, ndev, args.size, td)
            rows.append((nproc, ndev, lanes, dt, lanes / dt))
            print(f"{nproc} proc x {ndev} dev: {lanes} lanes in {dt:.3f}s "
                  f"-> {lanes/dt:,.0f} lanes/s")
    base = rows[0][4]
    print("\n| procs | devices | lanes/s | vs 1x1 |")
    print("|---|---|---|---|")
    for nproc, ndev, lanes, dt, thr in rows:
        print(f"| {nproc} | {nproc*ndev} | {thr:,.0f} | {thr/base:.2f}x |")
    print("\n(virtual CPU devices share the host's cores: this measures "
          "SPMD+federation overhead, not hardware scaling)")


def main_single(args):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.render.integrator import est_radiance
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.utils.config import RenderConfig

    W = H = args.size
    cfg = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0)
    scene, cam = load_scene(scene_path("cornell_lambertian"), W, H)
    bh = make_black_hole(cfg)
    ys, xs = np.meshgrid((np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    rays = cam.generate_rays(jnp.asarray(xy))
    key = jax.random.key(0)
    mesh = Mesh(np.array(jax.devices()), ("lanes",))
    sh = NamedSharding(mesh, P("lanes"))

    def fwd_plain(s, b, r):
        return est_radiance(s, b, r, cfg, key)

    def fwd_sharded(s, b, r):
        r = jax.lax.with_sharding_constraint(r, sh)
        return est_radiance(s, b, r, cfg, key)

    for name, f in (("unsharded", fwd_plain), ("sharded", fwd_sharded)):
        g = jax.jit(f)
        out = g(scene, bh, rays)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(3):
            out = g(scene, bh, rays)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / 3
        print(f"{name}: {W*H} lanes in {dt*1e3:.1f} ms "
              f"({W*H/dt:,.0f} lanes/s) on {len(jax.devices())} device(s)")


def main_breakdown_worker(args):
    """One device-count measurement, in-process (spawned by --breakdown):
    attributes the sharded program's cost.

    Prints one JSON line:
      sharded_ms     — lane-sharded forward over all local devices
      device0_ms     — identical program pinned to ONE device (control:
                       on shared host cores, parallel speedup is bounded;
                       the sharded/device0 gap is SPMD overhead + any
                       actual parallelism)
      transfer_ms    — first-call-minus-steady cost of handing the jitted
                       fn NUMPY scene arrays each call vs pre-device_put
                       ones (nonzero means tables re-ship per pass)
      collectives    — census of collective ops in the compiled sharded
                       HLO (all-reduce/all-gather/all-to-all/permute)
      curved_ms      — the curved forward, lane-sharded
    """
    import json

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.render.integrator import est_radiance
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig

    W = H = args.size
    scene, cam = load_scene(scene_path("cornell_lambertian"), W, H)
    ys, xs = np.meshgrid((np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    key = jax.random.key(0)
    ndev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("lanes",))
    sh = NamedSharding(mesh, P("lanes"))
    repl = NamedSharding(mesh, P())

    def timeit(f, *a, reps=5):
        out = f(*a)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(reps):
            out = f(*a)
        jax.block_until_ready(out)
        return (time.time() - t0) / reps * 1e3

    def measure(cfg):
        jax.clear_caches()
        bh = make_black_hole(cfg)
        rays = cam.generate_rays(jnp.asarray(xy))
        rays_sh = jax.device_put(rays, sh)
        scene_d = jax.device_put(scene, repl)
        bh_d = jax.device_put(bh, repl) if bh is not None else None

        fwd = jax.jit(lambda s, b, r: est_radiance(s, b, r, cfg, key,
                                                   mesh=mesh))
        sharded_ms = timeit(fwd, scene_d, bh_d, rays_sh)
        txt = fwd.lower(scene_d, bh_d, rays_sh).compile().as_text()
        colls = {k: txt.count(k) for k in
                 ("all-reduce", "all-gather", "all-to-all",
                  "collective-permute")}
        # single-device control: same lanes pinned to device 0
        with jax.default_device(jax.devices()[0]):
            rays_0 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a)), rays)
            fwd0 = jax.jit(lambda s, b, r: est_radiance(s, b, r, cfg, key))
            device0_ms = timeit(fwd0, scene, bh, rays_0)
        # transfer check: numpy scene arrays per call vs committed ones
        scene_np = jax.tree_util.tree_map(
            lambda a: np.asarray(a) if hasattr(a, "dtype") else a, scene)
        npy_ms = timeit(fwd, scene_np, bh_d, rays_sh)
        return sharded_ms, device0_ms, npy_ms - sharded_ms, colls

    flat = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                        max_ray_depth=2, seed=0,
                        black_hole=BlackHoleConfig(enabled=False))
    curved = flat.replace(black_hole=BlackHoleConfig(enabled=True))
    f_sh, f_d0, f_tx, f_coll = measure(flat)
    c_sh, _, _, c_coll = measure(curved)
    print(json.dumps({
        "ndev": ndev,
        "flat_sharded_ms": round(f_sh, 2),
        "flat_device0_ms": round(f_d0, 2),
        "transfer_extra_ms": round(f_tx, 2),
        "flat_collectives": f_coll,
        "curved_ms": round(c_sh, 2),
        "curved_collectives": c_coll,
    }))


def main_breakdown(args):
    """Spawn --breakdown-worker at 1/2/4/8 virtual devices; print table."""
    import json
    rows = []
    for ndev in (1, 2, 4, 8):
        env = dict(os.environ)
        env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}")
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--breakdown-worker", "--size", str(args.size)],
            env=env, capture_output=True, timeout=1800)
        line = r.stdout.decode().strip().splitlines()[-1]
        rows.append(json.loads(line))
        print(line)
    print("\n| devs | flat sharded | flat dev0 | transfer Δ | "
          "curved | collectives (flat/curved) |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['ndev']} | {r['flat_sharded_ms']} ms "
              f"| {r['flat_device0_ms']} ms | {r['transfer_extra_ms']} ms "
              f"| {r['curved_ms']} ms "
              f"| {sum(r['flat_collectives'].values())}"
              f"/{sum(r['curved_collectives'].values())} |")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--configs", default="1x1,1x2,1x4,2x2,1x8")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--breakdown-worker", action="store_true")
    args = ap.parse_args()
    if args.breakdown_worker:
        main_breakdown_worker(args)
    elif args.breakdown:
        main_breakdown(args)
    elif args.single:
        main_single(args)
    else:
        main_cpu(args)
