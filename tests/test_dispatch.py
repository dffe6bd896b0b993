"""Dispatch-planner calibration: the per-dispatch
cost-model constants are FIT from a measured probe (here a fake-clock
runner), persisted per device, and the resulting plan keeps every
dispatch under the budget."""
import json
import os

import numpy as np

from rrt_tpu.render.renderer import Renderer
from rrt_tpu.scene.build import load_scene
from rrt_tpu.utils import dispatch_cal as dc
from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
from rrt_tpu.scene.cornell import scene_path

SCENE = scene_path("cornell_lambertian")


def test_fit_constants_recovers_fake_device():
    """A fake device with known alpha/beta must be recovered exactly."""
    alpha0, beta0 = 0.8, 3e-7
    unit = 63

    def runner(n):
        return alpha0 + n * unit * beta0

    a, b = dc.fit_constants(runner, lane_cost_unit=unit)
    assert abs(a - alpha0) < 1e-9
    assert abs(b - beta0) / beta0 < 1e-9


def test_calibration_persisted_and_reused(tmp_path, monkeypatch):
    calls = {"n": 0}

    def runner(n):
        calls["n"] += 1
        return 0.3 + n * 1e-6

    a1, b1 = dc.load_or_calibrate(str(tmp_path), "FakeGPU v9", "pallas",
                                  runner, lane_cost_unit=1)
    assert calls["n"] == 2                       # two probe timings
    # second load: cache hit, no probe
    a2, b2 = dc.load_or_calibrate(str(tmp_path), "FakeGPU v9", "pallas",
                                  runner, lane_cost_unit=1)
    assert calls["n"] == 2
    assert (a1, b1) == (a2, b2)
    with open(dc.cache_path(str(tmp_path), "FakeGPU v9", "pallas")) as f:
        d = json.load(f)
    assert abs(d["alpha"] - a1) < 1e-12


def test_env_override_wins(monkeypatch):
    monkeypatch.setenv("RRT_DISPATCH_ALPHA", "1.25")
    monkeypatch.setenv("RRT_DISPATCH_BETA", "7e-9")
    a, b = dc.load_or_calibrate("/nonexistent", "x", "pallas", None)
    assert (a, b) == (1.25, 7e-9)


def test_planner_caps_dispatch_with_measured_constants(tmp_path,
                                                      monkeypatch):
    """A heavy config on a slow fake device must be split so the modeled
    per-dispatch time stays under max_dispatch_seconds, using constants
    DERIVED from the (fake) probe rather than guessed."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    cfg = RenderConfig(width=64, height=64, ns_aa=4, ns_area_light=64,
                       max_ray_depth=40, seed=0,
                       black_hole=BlackHoleConfig(enabled=True),
                       max_dispatch_seconds=120.0)
    scene, cam = load_scene(SCENE, 64, 64, fov_mode="native")
    r = Renderer(scene, cam, cfg)
    alpha0, beta0 = 0.4, 4e-8
    n_seg = 63
    r._cal_runner = lambda n: alpha0 + n * n_seg * beta0   # fake probe
    n = 64 * 64
    k, band_rows, n_bands = r._dispatch_plan(n, 64, 64)
    # reproduce the planner's cost model with the FITTED constants and
    # assert the chosen partition fits the budget
    from rrt_tpu.render.lights import is_delta_light
    S = sum(1 if is_delta_light(scene.lights, i) else cfg.ns_area_light
            for i in range(len(scene.lights.kind_host)))
    depth_eff = max(1, cfg.max_ray_depth)
    nee_traces = -(-S // max(1, cfg.nee_chunk))
    calls = 1 + depth_eff * (nee_traces + 1)
    lane_cost = n_seg * (1 + depth_eff * (S + 1))
    a, b = dc.load_or_calibrate(str(tmp_path), "cal-test", "x", None)
    # constants were persisted by the planner run under the real device
    # kind; re-fit directly for the assertion instead
    a, b = dc.fit_constants(r._cal_runner, lane_cost_unit=n_seg)
    lanes = band_rows * 64
    est = calls * a + k * lanes * lane_cost * b
    assert est <= cfg.max_dispatch_seconds * 1.05, (k, band_rows, n_bands,
                                                    est)
    assert k * band_rows < 64 * cfg.ns_aa        # it actually split


def test_small_render_skips_probe(monkeypatch):
    """Configs whose conservative-prior estimate fits the budget must not
    pay for a probe (no runner is ever built)."""
    cfg = RenderConfig(width=16, height=16, ns_aa=1, max_ray_depth=1,
                       black_hole=BlackHoleConfig(enabled=False))
    scene, cam = load_scene(SCENE, 16, 16, fov_mode="native")
    r = Renderer(scene, cam, cfg)
    import rrt_tpu.utils.dispatch_cal as dcal

    def boom(*a, **kw):
        raise AssertionError("probe should not run for small renders")

    monkeypatch.setattr(dcal, "make_trace_runner", boom)
    k, band_rows, n_bands = r._dispatch_plan(16 * 16, 16, 16)
    assert n_bands == 1
