"""Renderer/integrator tests: physical sanity, plus golden-image parity
against the reference binary. The parity tests need that binary and the
reference's own scene tree, which this repository does not hold, so they
are kept marked to skip (`PARITY`)."""
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rrt_tpu.io.png import read_png, write_png
from rrt_tpu.render.renderer import Renderer
from rrt_tpu.scene.build import load_scene
from rrt_tpu.utils.config import Illum, RenderConfig, BlackHoleConfig
from rrt_tpu.scene.cornell import scene_path

PARITY = pytest.mark.skip(
    reason="golden-image parity needs the reference binary and its scene "
           "tree; neither is part of this repository")


def _ensure_ref_binary(name="pathtracer"):
    """The reference binary (THIN_LENS builds as `pathtracer_thinlens`)."""
    path = shutil.which(name)
    if path is None:
        pytest.skip(f"reference binary {name!r} not installed")
    return path


def _render_mine(scene_path, cfg, fov_mode="native"):
    scene, cam = load_scene(scene_path, cfg.width, cfg.height,
                            fov_mode=fov_mode)
    r = Renderer(scene, cam, cfg)
    hdr, count = r.render()
    return hdr, count


def test_normal_shading_deterministic():
    """ILLUM=0 is the reference's sampler-free regression mode."""
    cfg = RenderConfig(width=64, height=48, ns_aa=1, illum=Illum.NORMAL,
                       black_hole=BlackHoleConfig(enabled=False))
    h1, _ = _render_mine(scene_path("cornell_lambertian"), cfg)
    h2, _ = _render_mine(scene_path("cornell_lambertian"), cfg)
    np.testing.assert_array_equal(h1, h2)
    assert h1.max() > 0.5  # normals visible
    assert (h1 >= -1e-6).all() and (h1 <= 1 + 1e-6).all()


def test_direct_lighting_flat_sane():
    """Flat-spacetime direct lighting: the box lit by its radiance-10 area
    light must be energetic (the floor under the light reaches ~0.5)."""
    cfg = RenderConfig(width=64, height=64, ns_aa=4, ns_area_light=4,
                       max_ray_depth=1, illum=Illum.FULL, seed=3,
                       black_hole=BlackHoleConfig(enabled=False))
    hdr, count = _render_mine(scene_path("cornell_lambertian"), cfg)
    assert np.isfinite(hdr).all()
    assert hdr.max() > 0.5 and hdr.mean() > 0.01
    assert (count == 4).all()


def test_rr_energy_increases_with_depth():
    """More bounces → more light (GI adds energy over direct-only)."""
    base = dict(width=32, height=32, ns_aa=8, ns_area_light=2, seed=5,
                black_hole=BlackHoleConfig(enabled=False))
    cfg1 = RenderConfig(max_ray_depth=1, **base)
    cfg5 = RenderConfig(max_ray_depth=5, **base)
    h1, _ = _render_mine(scene_path("cornell_lambertian"), cfg1)
    h5, _ = _render_mine(scene_path("cornell_lambertian"), cfg5)
    assert h5.mean() > h1.mean()


def test_adaptive_sampling_stops_early():
    cfg = RenderConfig(width=32, height=32, ns_aa=64, ns_area_light=1,
                       max_ray_depth=1, adaptive=True, samples_per_batch=8,
                       max_tolerance=0.5, seed=7,
                       black_hole=BlackHoleConfig(enabled=False))
    hdr, count = _render_mine(scene_path("cornell_lambertian"), cfg)
    # loose tolerance: most pixels (e.g. black background, converged fast)
    # must stop before the cap
    assert count.min() >= 8
    assert (count < 64).mean() > 0.5


@PARITY
@pytest.mark.slow
def test_parity_reference_lambertian_curved():
    """Golden-image comparison vs the reference binary at matched settings
    (4 spp, 4 light samples, depth 1, default black hole bending).

    MC noise differs (different RNG) so the comparison is on 16×16 block
    means, tolerance calibrated to the 4-spp noise floor.
    """
    ref_bin = _ensure_ref_binary()
    ref_png = "/tmp/parity_ref.png"
    subprocess.run(
        [ref_bin, "-f", ref_png, "-r", "128", "128", "-s", "4", "-l", "4",
         "-m", "1", "-t", "4", scene_path("cornell_lambertian")],
        check=True, capture_output=True, timeout=600)
    cfg = RenderConfig(width=128, height=128, ns_aa=4, ns_area_light=4,
                       max_ray_depth=1, seed=11)
    hdr, _ = _render_mine(scene_path("cornell_lambertian"), cfg,
                          fov_mode="reference")
    from rrt_tpu.render import film
    mine = film.to_color(hdr)[::-1][..., :3].astype(np.float64)
    ref = read_png(ref_png)[..., :3].astype(np.float64)
    B = 16
    mb = mine.reshape(128 // B, B, 128 // B, B, 3).mean((1, 3, 4))
    rb = ref.reshape(128 // B, B, 128 // B, B, 3).mean((1, 3, 4))
    diff = np.abs(mb - rb)
    assert diff.mean() < 4.0, (diff.mean(), diff.max())
    assert diff.max() < 40.0, (diff.mean(), diff.max())


# --------------------------------------------------------------------------
# Expanded parity suite: golden block-mean comparisons
# vs the reference binary across scenes/material families/flags. All MC
# comparisons are on block means with tolerances calibrated to the spp.


def _block_diff(hdr, ref_png, w, h, block=16):
    from rrt_tpu.render import film
    mine = film.to_color(hdr)[::-1][..., :3].astype(np.float64)
    ref = read_png(ref_png)[..., :3].astype(np.float64)
    mb = mine.reshape(h // block, block, w // block, block, 3).mean((1, 3, 4))
    rb = ref.reshape(h // block, block, w // block, block, 3).mean((1, 3, 4))
    return np.abs(mb - rb)


def _run_ref(args, out_png, env=None, thin_lens=False):
    bin_path = _ensure_ref_binary(
        "pathtracer_thinlens" if thin_lens else "pathtracer")
    subprocess.run([bin_path, "-f", out_png] + args,
                   check=True, capture_output=True, timeout=1200)


@PARITY
@pytest.mark.slow
def test_parity_mirror_glass_curved():
    """Config 3: CBspheres.dae mirror+glass (Fresnel coin flips, Russian
    roulette, delta-BSDF emission pickup), default black hole."""
    ref_png = "/tmp/parity_mg.png"
    _run_ref(["-r", "128", "128", "-s", "8", "-l", "4", "-m", "5",
              "-t", "4", scene_path("cornell_specular")], ref_png)
    cfg = RenderConfig(width=128, height=128, ns_aa=8, ns_area_light=4,
                       max_ray_depth=5, seed=13)
    hdr, _ = _render_mine(scene_path("cornell_specular"), cfg,
                          fov_mode="reference")
    diff = _block_diff(hdr, ref_png, 128, 128)
    assert diff.mean() < 5.0, (diff.mean(), diff.max())
    assert diff.max() < 48.0, (diff.mean(), diff.max())


@PARITY
@pytest.mark.slow
def test_parity_microfacet_bunny():
    """CBbunny_microfacet_cu.dae: Beckmann NDF + conductor Fresnel on the
    28k-triangle bunny (also exercises the partitioned trace path)."""
    ref_png = "/tmp/parity_mf.png"
    _run_ref(["-r", "96", "96", "-s", "4", "-l", "2", "-m", "1",
              "-t", "4", scene_path("cornell_microfacet")], ref_png)
    cfg = RenderConfig(width=96, height=96, ns_aa=4, ns_area_light=2,
                       max_ray_depth=1, seed=17)
    hdr, _ = _render_mine(scene_path("cornell_microfacet"), cfg,
                          fov_mode="reference")
    diff = _block_diff(hdr, ref_png, 96, 96)
    assert diff.mean() < 5.0, (diff.mean(), diff.max())
    assert diff.max() < 48.0, (diff.mean(), diff.max())


@PARITY
@pytest.mark.slow
def test_parity_envmap_radiance():
    """-e envmap: escaped rays must sample the lat-long map with the
    ORIGINAL ray direction (part1_code.cpp:106-107). Uses a synthesized
    smooth gradient EXR so block means carry radiance-value information,
    and additionally asserts absolute radiance in escape regions."""
    from rrt_tpu.io.exr import write_exr
    from rrt_tpu.scene.build import build_scene
    from rrt_tpu.io import collada
    from rrt_tpu.scene.envmap import build_envmap
    h_env, w_env = 32, 64
    yy = np.linspace(0, 1, h_env)[:, None]
    xx = np.linspace(0, 1, w_env)[None, :]
    img = np.stack([0.2 + 0.6 * xx + 0 * yy,
                    0.1 + 0.8 * yy + 0 * xx,
                    0.5 + 0 * xx + 0 * yy], axis=-1).astype(np.float32)
    exr = "/tmp/parity_env.exr"
    write_exr(exr, img)
    ref_png = "/tmp/parity_env_ref.png"
    _run_ref(["-r", "128", "128", "-s", "2", "-l", "1", "-m", "1",
              "-t", "4", "-e", exr, scene_path("cornell_empty")], ref_png)
    env = build_envmap(img)
    scene, cam = load_scene(scene_path("cornell_empty"), 128, 128, env=env,
                            fov_mode="reference")
    cfg = RenderConfig(width=128, height=128, ns_aa=2, ns_area_light=1,
                       max_ray_depth=1, seed=19)
    r = Renderer(scene, cam, cfg)
    hdr, _ = r.render()
    diff = _block_diff(hdr, ref_png, 128, 128)
    assert diff.mean() < 5.0, (diff.mean(), diff.max())
    assert diff.max() < 48.0, (diff.mean(), diff.max())


@PARITY
@pytest.mark.slow
def test_parity_custom_blackhole():
    """Non-default -B: bigger hole closer to the spheres, finer Δθ —
    checks the geodesic marcher parity away from the default params."""
    ref_png = "/tmp/parity_bh.png"
    B = ["0", "0.75", "0", "0.25", "0.1"]
    _run_ref(["-r", "128", "128", "-s", "4", "-l", "4", "-m", "1",
              "-t", "4", "-B"] + B + [scene_path("cornell_lambertian")],
             ref_png)
    cfg = RenderConfig(
        width=128, height=128, ns_aa=4, ns_area_light=4, max_ray_depth=1,
        seed=23,
        black_hole=BlackHoleConfig(position=(0.0, 0.75, 0.0), radius=0.25,
                                   delta_theta=0.1))
    hdr, _ = _render_mine(scene_path("cornell_lambertian"), cfg,
                          fov_mode="reference")
    diff = _block_diff(hdr, ref_png, 128, 128)
    # blocks straddling the photon ring are chaotic: double (reference) vs
    # f32 geodesics legitimately diverge there, so only the mean is tight
    assert diff.mean() < 4.0, (diff.mean(), diff.max())
    assert diff.max() < 96.0, (diff.mean(), diff.max())


@PARITY
@pytest.mark.slow
def test_parity_thin_lens():
    """THIN_LENS=1 build variant vs our thin-lens camera (lens-disk
    sampling + focal plane, camera.cpp:176-184) at default -b/-d."""
    ref_png = "/tmp/parity_tl.png"
    _run_ref(["-r", "128", "128", "-s", "8", "-l", "4", "-m", "1",
              "-t", "4", scene_path("cornell_lambertian")], ref_png,
             thin_lens=True)
    cfg = RenderConfig(width=128, height=128, ns_aa=8, ns_area_light=4,
                       max_ray_depth=1, seed=29, thin_lens=True)
    hdr, _ = _render_mine(scene_path("cornell_lambertian"), cfg,
                          fov_mode="reference")
    diff = _block_diff(hdr, ref_png, 128, 128)
    assert diff.mean() < 4.5, (diff.mean(), diff.max())
    assert diff.max() < 45.0, (diff.mean(), diff.max())


def test_nee_chunking_matches_unchunked():
    """direct_lighting_importance at -l large must equal the single-trace
    path: chunking the stacked (light,sample) axis (cfg.nee_chunk) changes
    memory footprint, not radiance."""
    import jax
    import jax.numpy as jnp
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.render import integrator as I
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.utils.config import RenderConfig

    scene, cam = load_scene(
        scene_path("cornell_lambertian"), 16, 12)
    cfg = RenderConfig(width=16, height=12, ns_aa=1, ns_area_light=24,
                       max_ray_depth=1, seed=3)
    bh = make_black_hole(cfg)
    import numpy as np
    ys, xs = np.meshgrid((np.arange(12) + .5) / 12, (np.arange(16) + .5) / 16,
                         indexing="ij")
    rays = cam.generate_rays(jnp.asarray(
        np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)))
    hit, _ = I._trace_discrete(scene, bh, rays, cfg)
    key = jax.random.key(7)
    L_chunked, _ = I.direct_lighting_importance(
        scene, bh, hit, cfg.replace(nee_chunk=8), key)
    L_single, _ = I.direct_lighting_importance(
        scene, bh, hit, cfg.replace(nee_chunk=1024), key)
    assert bool(jnp.all(jnp.isfinite(L_chunked)))
    np.testing.assert_allclose(np.array(L_chunked), np.array(L_single),
                               rtol=1e-4, atol=1e-5)


@PARITY
@pytest.mark.slow
def test_parity_sane_fov_direct_cell():
    """Parity at the reference's NATIVE FoV (800x600, where configure →
    resize is the identity and hFov is the authored ~50°) — the only
    resolution where the whole box is in frame, so this exercises NEE,
    the boundary-quirk normals, and curved shadow rays across every wall.

    A 200x200 cell keeps it affordable; depth 1 (direct + emission),
    default black hole. Block means at the 1-spp noise floor.
    """
    ref_bin = _ensure_ref_binary()
    ref_png = "/tmp/parity_ref_800_cell.png"
    x, y, dx, dy = 150, 200, 200, 200
    subprocess.run(
        [ref_bin, "-f", ref_png, "-r", "800", "600", "-s", "1", "-l", "1",
         "-m", "1", "-t", "2", "-p", str(x), str(y), str(dx), str(dy),
         scene_path("cornell_lambertian")],
        check=True, capture_output=True, timeout=600)
    cfg = RenderConfig(width=800, height=600, ns_aa=1, ns_area_light=1,
                       max_ray_depth=1, seed=3)
    scene, cam = load_scene(scene_path("cornell_lambertian"), 800, 600)
    r = Renderer(scene, cam, cfg)
    hdr_cell = r.render_cell(x, y, dx, dy)
    from rrt_tpu.render import film
    mine = film.to_color(hdr_cell)[..., :3].astype(np.float64)
    # the reference crops the PNG to the cell and writes it row-flipped
    ref = read_png(ref_png)[..., :3].astype(np.float64)[::-1]
    B = 25
    mb = mine.reshape(dy // B, B, dx // B, B, 3).mean((1, 3, 4))
    rb = ref.reshape(dy // B, B, dx // B, B, 3).mean((1, 3, 4))
    d = np.abs(mb - rb)
    assert d.mean() < 2.0, (d.mean(), d.max())
    assert d.max() < 12.0, (d.mean(), d.max())


@pytest.mark.parametrize("scene_name", [
    "cornell_specular",          # mirror + glass spheres
    "cornell_microfacet",        # microfacet sphere
    "cornell_empty",             # point light, no panel, no spheres
    "cornell_blob",              # 28.6k-triangle mesh
    "torus",                     # non-box geometry, directional light
])
def test_corpus_normal_shading_smoke(scene_name):
    """Every committed scene renders deterministically in the reference's
    sampler-free ILLUM=0 mode: loads, traces, produces finite nonzero
    pixels (geometry + interpolated normals + camera placement all sane).
    """
    cfg = RenderConfig(width=48, height=36, ns_aa=1, illum=Illum.NORMAL,
                       black_hole=BlackHoleConfig(enabled=False))
    hdr, _ = _render_mine(scene_path(scene_name), cfg)
    assert np.isfinite(hdr).all()
    assert (hdr.max(-1) > 0.05).mean() > 0.1, "scene mostly empty"


def test_microfacet_hemi_mode():
    """MICROFACET_HEMI==1 fallback (bsdf.h:4): cosine-hemisphere proposals
    for the microfacet lobe. Both modes must integrate to statistically
    similar images (same estimator target, different variance)."""
    base = dict(width=32, height=32, ns_aa=16, ns_area_light=2,
                max_ray_depth=1, seed=21,
                black_hole=BlackHoleConfig(enabled=False))
    h_imp, _ = _render_mine(scene_path("cornell_microfacet"),
                            RenderConfig(**base))
    h_hemi, _ = _render_mine(scene_path("cornell_microfacet"),
                             RenderConfig(microfacet_hemi=True, **base))
    assert np.isfinite(h_hemi).all()
    assert abs(h_imp.mean() - h_hemi.mean()) < 0.25 * max(h_imp.mean(), 1e-3)


@pytest.mark.slow
def test_env_hemi_uniform_mode():
    """ENV_HEMI==1 fallback (environment_light.cpp:139-142): uniform-sphere
    env sampling with pdf 1/4π must agree in expectation with CDF
    importance sampling (noisier, same estimator target)."""
    from rrt_tpu.scene.envmap import build_envmap
    h_env, w_env = 32, 64
    yy = np.linspace(0, 1, h_env)[:, None]
    xx = np.linspace(0, 1, w_env)[None, :]
    img = np.stack([0.2 + 0.6 * xx + 0 * yy,
                    0.1 + 0.8 * yy + 0 * xx,
                    0.5 + 0 * xx + 0 * yy], axis=-1).astype(np.float32)
    env = build_envmap(img)
    base = dict(width=32, height=32, ns_aa=32, ns_area_light=4,
                max_ray_depth=1, seed=23,
                black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(scene_path("cornell_empty"), 32, 32, env=env,
                            fov_mode="native")
    h_imp, _ = (lambda c: (Renderer(scene, cam, c).render()))(
        RenderConfig(**base))
    h_uni, _ = (lambda c: (Renderer(scene, cam, c).render()))(
        RenderConfig(env_importance_sampling=False, **base))
    assert np.isfinite(h_uni).all()
    assert abs(h_imp.mean() - h_uni.mean()) < 0.5 * max(h_imp.mean(), 1e-3)
