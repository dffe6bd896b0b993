"""Render lifecycle: true cell render, checkpoint/resume, cancellation,
progressive preview (reference stop()/raytrace_cell/update_screen analogs,
pathtracer.cpp:180-202, 583-609, 156-178)."""
import os
import time

import numpy as np
import pytest

from rrt_tpu.render.renderer import Renderer
from rrt_tpu.scene.build import load_scene
from rrt_tpu.utils.config import BlackHoleConfig, Illum, RenderConfig
from rrt_tpu.scene.cornell import scene_path

SCENE = scene_path("cornell_lambertian")


def _renderer(w=48, h=36, spp=4, **kw):
    # one sample per pass (max_pass_lanes = frame size) so checkpoints,
    # stop() and stop_after can land between samples; the pass partition
    # must match between interrupted and uninterrupted renders for the
    # bit-exact resume guarantee
    kw.setdefault("max_pass_lanes", w * h)
    cfg = RenderConfig(width=w, height=h, ns_aa=spp, max_ray_depth=1,
                       illum=kw.pop("illum", Illum.FULL), seed=7,
                       black_hole=BlackHoleConfig(enabled=False), **kw)
    # native fov: the reference-faithful 800x600-then-resize FoV quirk
    # makes tiny test frames view (and light) almost nothing
    scene, cam = load_scene(SCENE, w, h, fov_mode="native")
    return Renderer(scene, cam, cfg)


def test_cell_render_matches_full_frame():
    """The -p cell render must generate rays only for the cell and agree
    pixel-for-pixel with the same region of a full-frame ILLUM=0 render
    (deterministic, jitter-free)."""
    r = _renderer(spp=1, illum=Illum.NORMAL)
    full, _ = r.render()
    cell = r.render_cell(10, 6, 16, 12)
    assert cell.shape == (12, 16, 3)
    np.testing.assert_allclose(cell, full[6:18, 10:26], rtol=1e-6)


def test_cell_render_scales_with_area():
    """Ray count (and pass lanes) is proportional to cell area: check the
    accumulator shape the renderer actually allocates."""
    r = _renderer(spp=1, illum=Illum.NORMAL)
    hdr, count = r.render(region=(0, 0, 8, 4))
    assert hdr.shape == (4, 8, 3)
    assert count.shape == (4, 8)


def test_checkpoint_resume_bit_exact(tmp_path):
    """A render cancelled mid-way and resumed from its checkpoint must
    bit-match the uninterrupted render (per-pass keys derive only from
    (seed, pass index))."""
    ckpt = str(tmp_path / "state.npz")
    r1 = _renderer(spp=4)
    full, full_count = r1.render()

    r2 = _renderer(spp=4)
    partial, _ = r2.render(checkpoint_path=ckpt, stop_after=2)
    assert r2.cancelled
    assert r2.samples_done < 4
    assert os.path.exists(ckpt)

    r3 = _renderer(spp=4)
    resumed, resumed_count = r3.render(checkpoint_path=ckpt, resume=True)
    assert not r3.cancelled
    np.testing.assert_array_equal(resumed, full)
    np.testing.assert_array_equal(resumed_count, full_count)


def test_checkpoint_fingerprint_mismatch(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    r = _renderer(spp=4)
    r.render(checkpoint_path=ckpt, stop_after=2)
    other = _renderer(spp=4, w=32, h=32)
    with pytest.raises(ValueError):
        other.load_checkpoint(ckpt, (0, 0, 32, 32))


def test_stop_requests_cancellation():
    # max_pass_lanes = one frame -> one sample per pass, so stop() can land
    r = _renderer(spp=4, max_pass_lanes=48 * 36)
    calls = []

    def progress(s, total):
        calls.append(s)
        r.stop()

    hdr, count = r.render(progress=progress)
    assert r.cancelled
    assert count.max() < 4


def test_progressive_preview(tmp_path):
    from rrt_tpu.io.png import read_png
    prev = str(tmp_path / "prev.png")
    r = _renderer(spp=4)
    r.render(preview_path=prev, preview_every=1)
    img = read_png(prev)
    assert img.shape == (36, 48, 4)
    assert img[..., :3].max() > 0


def test_single_program_per_render():
    """Tail-pass padding + dynamic origins: one compiled pass program
    serves steady passes, the smaller tail, AND a same-size cell render
    (no avoidable recompiles)."""
    r = _renderer(spp=5, max_pass_lanes=2 * 48 * 36)  # k=2 -> 2+2+1 tail
    r.render()
    assert r.samples_done == 5
    assert len(r._pass_fns) == 1, list(r._pass_fns)
