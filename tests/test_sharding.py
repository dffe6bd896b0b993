"""Multi-device sharding: the sharded render must equal the single-device
render, and sharded gradients must all-reduce correctly."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rrt_tpu.parallel import sharding as sh
from rrt_tpu.render import diff
from rrt_tpu.render.integrator import est_radiance
from rrt_tpu.render.renderer import make_black_hole
from rrt_tpu.scene.build import load_scene
from rrt_tpu.types import Rays
from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu.scene.cornell import scene_path



def _setup(n_lanes=512):
    cfg = RenderConfig(width=64, height=64, ns_aa=1, ns_area_light=2,
                       max_ray_depth=2, seed=0,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(scene_path("cornell_lambertian"),
                            64, 64, fov_mode="native")
    rng = np.random.default_rng(0)
    xy = rng.uniform(0.1, 0.9, (n_lanes, 2)).astype(np.float32)
    rays = cam.generate_rays(jnp.asarray(xy))
    return scene, cfg, rays


def test_sharded_render_matches_single_device():
    scene, cfg, rays = _setup()
    bh = make_black_hole(cfg)
    key = jax.random.key(7)

    f = jax.jit(lambda r: est_radiance(scene, bh, r, cfg, key))
    ref = np.asarray(f(rays))

    mesh = sh.make_mesh()
    assert len(mesh.devices.flat) == 8
    rays_sharded = sh.shard_batch(rays, mesh)
    out = np.asarray(f(rays_sharded))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sharded_grads_allreduce():
    scene, cfg, rays = _setup(256)
    cfg = cfg.replace(differentiable=True, max_ray_depth=1)
    bh = make_black_hole(cfg)
    params = diff.params_from_scene(scene, bh)
    target = jnp.full((256, 3), 0.2, jnp.float32)
    key = jax.random.key(3)

    loss_fn = jax.jit(jax.grad(diff.image_loss),
                      static_argnames=())
    g_single = jax.grad(diff.image_loss)(
        params, scene, bh, rays, target, cfg, key)

    mesh = sh.make_mesh()
    rays_s = sh.shard_batch(rays, mesh)
    target_s = jax.device_put(target, sh.batch_sharding(mesh))
    params_r = sh.replicate(params, mesh)
    g_sharded = jax.grad(diff.image_loss)(
        params_r, scene, bh, rays_s, target_s, cfg, key)

    np.testing.assert_allclose(
        np.asarray(g_sharded.reflectance),
        np.asarray(g_single.reflectance), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(g_sharded.emission),
        np.asarray(g_single.emission), rtol=1e-4, atol=1e-7)


def test_shard_map_trace_matches_unsharded():
    """The shard_map trace path (mesh=) must be bit-equal to the
    unsharded render — per-lane results are independent of the batch,
    including with lane counts NOT divisible by the mesh (dead-lane
    padding)."""
    for n_lanes in (512, 509):          # divisible and ragged
        scene, cfg, rays = _setup(n_lanes)
        for curved in (False, True):
            c = cfg.replace(black_hole=BlackHoleConfig(enabled=curved))
            bh = make_black_hole(c)
            key = jax.random.key(11)
            ref = np.asarray(jax.jit(
                lambda r: est_radiance(scene, bh, r, c, key))(rays))
            mesh = sh.make_mesh()
            out = np.asarray(jax.jit(
                lambda r: est_radiance(scene, bh, r, c, key,
                                       mesh=mesh))(rays))
            np.testing.assert_allclose(out, ref, atol=1e-6,
                                       err_msg=f"curved={curved} "
                                               f"n={n_lanes}")


def test_traversal_collective_census():
    """On an 8-device mesh the compiled
    render contains ~0 all-gather/collective-permute — the traversal is
    shard-local under shard_map (the only collective is the work-counter
    psum and the final unpad reshard)."""
    scene, cfg, rays = _setup(512)
    mesh = sh.make_mesh()
    rays_s = sh.shard_batch(rays, mesh)
    for curved in (False, True):
        c = cfg.replace(black_hole=BlackHoleConfig(enabled=curved))
        bh = make_black_hole(c)
        key = jax.random.key(11)
        f = jax.jit(lambda r: est_radiance(scene, bh, r, c, key,
                                           mesh=mesh))
        txt = f.lower(rays_s).compile().as_text()
        census = {k: txt.count(k) for k in
                  ("all-gather", "collective-permute", "all-to-all")}
        assert sum(census.values()) == 0, (curved, census)


def test_renderer_stats_counts():
    from rrt_tpu.render.renderer import Renderer
    scene, cfg, _ = _setup()
    cfg = cfg.replace(width=16, height=16, ns_aa=2, max_ray_depth=2)
    r = Renderer(scene, cfg=cfg, camera=_cam())
    st = r.stats(1.0)
    n_lanes = 16 * 16 * 2
    assert st.camera_rays == n_lanes
    # 1 area light × 2 samples per vertex × 2 vertices
    assert st.shadow_rays == n_lanes * 2 * 2
    assert st.bounce_rays == n_lanes * 1
    assert "rays" in st.report()


def _cam():
    _, cam = load_scene(scene_path("cornell_lambertian"), 16, 16,
                        fov_mode="native")
    return cam
