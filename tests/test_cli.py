"""CLI end-to-end smoke tests (subprocess, CPU, tiny frames)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from rrt_tpu.io.png import read_png
from rrt_tpu.scene.cornell import scene_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=400):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m"] + args, capture_output=True, text=True,
        timeout=timeout, env=env, cwd=ROOT)


def test_cli_headless_render(tmp_path):
    out = str(tmp_path / "out.png")
    r = _run(["rrt_tpu.cli", "-f", out, "-r", "48", "36", "-s", "1",
              "-m", "1", "--flat", "--illum", "0",
              scene_path("cornell_lambertian")])
    assert r.returncode == 0, r.stderr[-2000:]
    img = read_png(out)
    assert img.shape == (36, 48, 4)
    assert img[..., :3].max() > 0
    # the unconditional companion heatmap (reference save_image behavior)
    assert os.path.exists(str(tmp_path / "out_rate.png"))
    assert "Traced" in r.stdout


def test_cli_black_hole_flag(tmp_path):
    out = str(tmp_path / "bh.png")
    r = _run(["rrt_tpu.cli", "-f", out, "-r", "32", "24", "-s", "1",
              "-m", "1", "-B", "0", "0.75", "0", "0.2", "0.3",
              scene_path("cornell_lambertian")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)


def test_cli_envmap(tmp_path):
    """-e flag: synthesize an EXR, render an unlit scene lit by it."""
    import numpy as np
    from rrt_tpu.io.exr import write_exr
    exr = str(tmp_path / "env.exr")
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = [2.0, 1.0, 0.5]  # bright upper hemisphere
    write_exr(exr, img)
    out = str(tmp_path / "env_render.png")
    r = _run(["rrt_tpu.cli", "-f", out, "-r", "32", "24", "-s", "2",
              "-m", "1", "--flat", "-e", exr, "--seed", "1",
              scene_path("torus")], timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    img_out = read_png(out)[..., :3]
    assert img_out.max() > 0  # envmap light reaches the film
    # probability_debug.png is written on env init (reference behavior)
    assert os.path.exists(os.path.join(ROOT, "probability_debug.png"))
    os.remove(os.path.join(ROOT, "probability_debug.png"))


def test_kerr_cli(tmp_path):
    out = str(tmp_path / "kerr.png")
    r = _run(["rrt_tpu.kerr_cli", "-f", out, "-r", "48", "32",
              "--steps", "120", "--mass", "1", "--spin", "0.8"])
    assert r.returncode == 0, r.stderr[-2000:]
    img = read_png(out)[..., :3]
    assert img.max() > 10  # disk visible


def test_dump_accel(tmp_path):
    """--dump-accel writes the cluster-table JSON + touched-count heatmap
    (the BVH-visualizer analog, pathtracer.cpp:330-423)."""
    import json
    from rrt_tpu import cli
    base = str(tmp_path / "viz")
    out = str(tmp_path / "out.png")
    cli.main(["-f", out, "-r", "32", "24", "-s", "1", "--illum", "0",
              "--dump-accel", base,
              scene_path("cornell_lambertian")])
    doc = json.loads(open(base + "_accel.json").read())
    assert doc["cluster_size"] == 64
    assert len(doc["clusters"]) >= 1
    assert doc["clusters"][0]["tri_rows"][1] == 64
    assert (tmp_path / "viz_accel.png").exists()


def test_dump_rays(tmp_path):
    """--dump-rays writes the per-pixel ray log NPZ + hit/cost/segment
    panels (the rayLog + ray-drawing analog, pathtracer.cpp:395-418)."""
    import numpy as np
    from rrt_tpu import cli
    base = str(tmp_path / "rl")
    out = str(tmp_path / "out.png")
    cli.main(["-f", out, "-r", "24", "18", "-s", "1", "--illum", "0",
              "--dump-rays", base,
              scene_path("cornell_lambertian")])
    z = np.load(base + "_raylog.npz")
    assert z["outcome"].shape == (18, 24)
    # the Cornell box fills the view: everything hits geometry
    assert (z["outcome"] == 1).all()
    assert z["clusters"].max() > 0
    assert (z["marched"] >= 1).all() and (z["marched"] <= 63).all()
    # winning segment bounded by the march length
    assert (z["win_seg"][z["outcome"] == 1]
            <= z["marched"][z["outcome"] == 1]).all()
    for suffix in ("_raylog_hit.png", "_raylog_cost.png",
                   "_raylog_seg.png"):
        assert (tmp_path / ("rl" + suffix)).exists()


def test_serve_preview(tmp_path):
    """--serve 0 starts the live-preview HTTP server (the interactive
    viewer analog): the page, the preview PNG, and status are served
    while the render runs."""
    import threading
    import urllib.request
    from rrt_tpu import cli
    from rrt_tpu.utils.serve import PreviewServer

    # unit-level: serve a file we control on an ephemeral port
    png = tmp_path / "p.png"
    png.write_bytes(b"\x89PNG-fake")
    srv = PreviewServer(str(png), 0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "preview.png" in page
        got = urllib.request.urlopen(base + "/preview.png").read()
        assert got == b"\x89PNG-fake"
        srv.update(3, 16)
        import json as _json
        st = _json.loads(
            urllib.request.urlopen(base + "/status.json").read())
        assert st == {"samples": 3, "total": 16, "done": False}
    finally:
        srv.stop()

    # end-to-end: the CLI flag wires the server + preview path
    out = str(tmp_path / "out.png")
    rc = cli.main(["-f", out, "-r", "16", "12", "-s", "2", "--illum", "0",
                   "--serve", "0",
                   scene_path("cornell_lambertian")])
    assert rc == 0
    assert (tmp_path / "out.png.preview.png").exists()


def test_serve_control_channel(tmp_path):
    """POST /control drives a LIVE render (the runtime key_press analog,
    pathtracer.cpp:463-547):
    an spp cap set over HTTP finishes the render early, and the stop
    action cancels it."""
    import json as _json
    import threading
    import urllib.request
    from rrt_tpu.render.renderer import Renderer
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
    from rrt_tpu.utils.serve import PreviewServer

    png = tmp_path / "p.png"
    srv = PreviewServer(str(png), 0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        # POST handling: cap + cadence land in srv.control
        req = urllib.request.Request(
            base + "/control",
            data=_json.dumps({"spp_cap": 4, "preview_every": 2}).encode(),
            method="POST")
        resp = _json.loads(urllib.request.urlopen(req).read())
        assert resp["ok"] and srv.control == {"spp_cap": 4,
                                              "preview_every": 2}

        # live render honoring the cap: 16 spp requested, capped at 4
        w, h = 24, 16
        cfg = RenderConfig(width=w, height=h, ns_aa=16, max_ray_depth=1,
                           seed=1, max_pass_lanes=w * h,
                           black_hole=BlackHoleConfig(enabled=False))
        scene, cam = load_scene(
            scene_path("cornell_lambertian"),
            w, h, fov_mode="native")
        r = Renderer(scene, cam, cfg)
        r.render(control=srv.control)
        assert r.samples_done == 4
        assert r.cancelled

        # stop action: a fresh render is cancelled on its first check
        req = urllib.request.Request(
            base + "/control", data=_json.dumps({"action": "stop"}).encode(),
            method="POST")
        urllib.request.urlopen(req)
        assert srv.control.get("stop") is True
        srv.control.pop("spp_cap")
        r2 = Renderer(scene, cam, cfg)
        r2.render(control=srv.control)
        assert r2.cancelled and r2.samples_done < cfg.ns_aa
    finally:
        srv.stop()


def test_serve_accel_walk(tmp_path):
    """Arrow-key accel-structure navigation over HTTP (the reference's
    VISUALIZE-mode BVH walk, pathtracer.cpp:330-423 + :520-534): the
    selection stack moves with up/left/right, /accel.png rasterizes the
    selection, and the walk state is reported in /status.json."""
    import json as _json
    import urllib.request
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.utils.accel_walk import AccelWalk
    from rrt_tpu.utils.serve import PreviewServer

    scene, cam = load_scene(
        scene_path("cornell_blob"), 64, 48)
    walk = AccelWalk(scene, cam)
    assert walk.status()["level"] == "root"
    # walk semantics mirror the reference's selection stack
    assert not walk.key("up")                 # root stays put
    assert walk.key("left")                   # push first child
    assert walk.status()["level"] == "group"
    i0 = walk.status()["index"]
    assert walk.key("right")                  # sibling advance
    assert walk.status()["index"] != i0
    assert walk.key("left")
    assert walk.status()["level"] == "cluster"
    assert walk.key("up")
    assert walk.status()["level"] == "group"
    # a leaf cluster covers exactly the kernel's cluster rows
    while walk.key("left"):
        pass
    st = walk.status()
    assert st["level"] == "cluster"
    t0, t1 = st["tri_rows"]
    assert 0 < t1 - t0 <= walk.h.cs

    png = tmp_path / "p.png"
    srv = PreviewServer(str(png), 0, accel=walk).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        st = _json.loads(
            urllib.request.urlopen(base + "/status.json").read())
        assert st["accel"]["level"] == "cluster"
        body = _json.dumps({"accel": "up"}).encode()
        r = _json.loads(urllib.request.urlopen(
            urllib.request.Request(base + "/control", data=body),
            ).read())
        assert r["moved"]
        img = urllib.request.urlopen(base + "/accel.png").read()
        assert img[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.stop()
