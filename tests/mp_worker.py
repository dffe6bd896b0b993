"""Subprocess worker for tests/test_distributed.py and tools/scaling_bench.py.

Run as:  python tests/mp_worker.py <process_id> <num_processes> <port> <out.npz>

Each process initializes jax.distributed against a localhost coordinator
(CPU backend, gloo collectives — the same code path a multi-host run
takes), builds the global lane mesh, feeds its LOCAL slice of the camera
rays through make_global_batch, and jits the forward radiance estimate over
the global mesh. It then recomputes the same lanes single-device and asserts
the sharded result matches — proving the distributed path changes placement,
not radiance. The local shard + timing land in <out.npz>.

Env must be set BY THE PARENT (shell level): JAX_PLATFORMS=cpu,
XLA_FLAGS=--xla_force_host_platform_device_count=K, PYTHONPATH=<repo root>
(the backend is chosen before this script body runs).
"""
import sys
import time

import numpy as np
from rrt_tpu.scene.cornell import scene_path


def main():
    pid, nproc, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    # optional frame size (tools/scaling_bench.py passes larger frames;
    # the 2-process test keeps the cheap 16x16 default)
    size = int(sys.argv[5]) if len(sys.argv) > 5 else 16
    import jax
    import jax.numpy as jnp

    from rrt_tpu.parallel import distributed as dist
    from rrt_tpu.parallel import sharding as sh

    dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                    num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()

    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.render.integrator import est_radiance
    from rrt_tpu.utils.config import RenderConfig

    from rrt_tpu.utils.config import BlackHoleConfig

    W = H = size
    # flat spacetime: the reference's 800x600-configure-then-resize FoV
    # quirk makes a 16x16 frame a ~1° telephoto of the back wall, and with
    # the default black hole the lensed NEE paths can all miss — radiance
    # would be legitimately zero. Straight shadow rays guarantee a lit
    # wall, keeping the nonzero sanity assert meaningful. The sharding
    # path under test is identical either way.
    cfg = RenderConfig(width=W, height=H, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(
        scene_path("cornell_lambertian"), W, H)
    bh = make_black_hole(cfg)

    ys, xs = np.meshgrid((np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    rays_full = cam.generate_rays(jnp.asarray(xy))

    n = xy.shape[0]
    lo, hi = pid * n // nproc, (pid + 1) * n // nproc
    rays_local = jax.tree_util.tree_map(
        lambda a: np.asarray(a)[lo:hi], rays_full)

    mesh = dist.global_mesh()
    rays_g = dist.make_global_batch(rays_local, mesh)
    scene_g = dist.replicate_global(scene, mesh)
    bh_g = dist.replicate_global(bh, mesh)
    key = jax.random.key(0)

    fwd = jax.jit(lambda s, b, r: est_radiance(s, b, r, cfg, key))
    out_g = fwd(scene_g, bh_g, rays_g)
    jax.block_until_ready(out_g)
    t0 = time.time()
    out_g = fwd(scene_g, bh_g, rays_g)
    jax.block_until_ready(out_g)
    dt = time.time() - t0

    # this process's lanes of the global result (sorted by global offset)
    shards = sorted(out_g.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    local_rows = np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    # single-device full-shape recomputation (placement-invariance): the
    # per-lane randoms depend on the GLOBAL batch shape, so compute at full
    # shape and slice this process's rows
    with jax.default_device(jax.local_devices()[0]):
        rays_1 = jax.tree_util.tree_map(jnp.asarray, rays_full)
        out_1 = np.asarray(jax.jit(
            lambda s, b, r: est_radiance(s, b, r, cfg, key))(scene, bh, rays_1))
    np.testing.assert_allclose(local_rows, out_1[lo:hi], rtol=2e-5, atol=2e-6)

    np.savez(out_path, local=local_rows, lo=lo, hi=hi, dt=dt,
             nproc=jax.process_count(),
             ndev=len(jax.devices()))
    dist.all_processes_done()
    print(f"p{pid}: OK lanes=[{lo},{hi}) dt={dt:.3f}s "
          f"global_devices={len(jax.devices())}", flush=True)


if __name__ == "__main__":
    main()
