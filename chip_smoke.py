"""Smoke run of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card, phases (a)-(f)
    python chip_smoke.py --four-cards    # the lane-sharded path on 4 cards

One card, one process. Each phase prints one line with its wall time
(compilation included; run it twice to see the persistent compile cache
at work) and its result:

  (a) devices   the platform is gpu and the card count is 1
  (b) primary   `rrt_tpu.cli.main` renders scenes/cornell_lambertian.dae
                curved at 256x256, 16 spp, -l 4 -m 5 to a PNG; the
                radiance (read back from the CLI's checkpoint) is finite
                with its mean inside PRIMARY_MEAN_BAND
  (c) bvh       the 28,584-triangle scenes/cornell_blob.dae at 512x512,
                4 spp, depth 5, curved; tests per ray printed
  (d) kernel    the fused trace kernel against the XLA path and brute
                force at 65,536 lanes of camera and bounce rays, flat and
                curved, on both scenes (rule: rrt_tpu/ops/kernel_check.py)
  (e) inverse   inverse-rendering gradient steps at 64x64 on the card
                (kernel trace): the curved step's loss and gradient are
                finite, and the flat step's agree with the host CPU's
                (XLA trace) within DIFF_RTOL
  (f) kerr      `rrt_tpu.kerr_cli.main` renders a 1024x1024, 1 spp frame

With --four-cards only the lane-sharded path runs, each part against the
same work on one card: the primary render on a 1-D mesh (values within
SHARD_ATOL), the sharded inverse-rendering step, and `kerr_cli --sharded`
(8-bit frames within one level on at most 0.1 % of values: the same
last-bit rounding, seen through the tone map).

The card's name and power limit (nvidia-smi) print before any number;
the last line of standard output is the JSON result. Any failed phase
exits non-zero without it; so does a run where JAX finds no GPU.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
# mean radiance of the primary render (256x256, 16 spp, -l 4 -m 5, curved,
# seed 0): 0.0886 from a 2-spp CPU render of the same frame; the band
# allows +-20 % for Monte Carlo noise of the mean
PRIMARY_MEAN_BAND = (0.07, 0.11)
# flat inverse step, card vs CPU: the traces agree exactly, but sampled
# directions pass through sin/cos/sqrt, whose GPU and CPU versions differ
# in the last bit, so a few secondary rays land on the other side of an
# edge; on 4,096 lanes that moved a gradient leaf by 0.23 % and the loss
# by 0.026 % (an H100, against the host CPU)
DIFF_RTOL = 1e-2
# Sharded vs one-card renders: every lane takes the same path (the trace
# is per lane), but XLA compiles the per-card program at a quarter of the
# lanes and the shading arithmetic around the trace rounds differently in
# the last bit (measured max |diff| 1.2e-7 on the primary render)
SHARD_ATOL = 1e-6


class PhaseFailed(Exception):
    pass


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        msg = fn(*args)
    except Exception as e:
        if not isinstance(e, PhaseFailed):
            traceback.print_exc()
        print(f"[phase {name}] FAILED after {time.perf_counter() - t0:.2f} s:"
              f" {type(e).__name__}: {e}", flush=True)
        raise PhaseFailed(name) from e
    print(f"[phase {name}] ok in {time.perf_counter() - t0:.2f} s: {msg}",
          flush=True)


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def quiet(fn, *args):
    """Run fn with its stdout captured; returns (result, captured text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# ------------------------------------------------------------------ phases

def devices(n):
    import jax
    ds = jax.devices()
    require(ds[0].platform == "gpu", f"platform is {ds[0].platform!r}")
    require(len(ds) == n, f"{len(ds)} devices, expected {n}")
    return f"{len(ds)} x {ds[0].device_kind}"


def primary():
    import numpy as np
    from rrt_tpu import cli
    from rrt_tpu.scene.cornell import scene_path
    png = os.path.join(OUT, "smoke_primary.png")
    ckpt = os.path.join(OUT, "smoke_primary.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    rc, log = quiet(cli.main, [
        "-f", png, "-r", "256", "256", "-s", "16", "-l", "4", "-m", "5",
        "--checkpoint", ckpt, "--checkpoint-every", "16",
        scene_path("cornell_lambertian")])
    require(rc == 0 and os.path.exists(png), f"cli returned {rc}")
    z = np.load(ckpt)
    require(int(z["s"]) == 16 and (z["count"] == 16).all(),
            "not every pixel took 16 samples")
    hdr = z["rad_sum"] / z["count"][:, None]
    require(hdr.shape == (256 * 256, 3), f"radiance shape {hdr.shape}")
    require(np.isfinite(hdr).all(), "non-finite radiance")
    mean = float(hdr.mean())
    lo, hi = PRIMARY_MEAN_BAND
    require(lo <= mean <= hi, f"mean radiance {mean:.4f} outside [{lo}, {hi}]")
    passes = [ln for ln in log.splitlines() if "Phases:" in ln]
    return (f"mean radiance {mean:.4f} in [{lo}, {hi}]; "
            + (passes[-1].replace("[PathTracer] ", "") if passes else ""))


def bvh():
    import numpy as np
    from rrt_tpu.render.renderer import Renderer
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.utils.config import RenderConfig
    cfg = RenderConfig(width=512, height=512, ns_aa=4, ns_area_light=1,
                       max_ray_depth=5, seed=0)
    scene, cam = load_scene(scene_path("cornell_blob"), 512, 512)
    r = Renderer(scene, cam, cfg)
    t0 = time.perf_counter()
    hdr, count = r.render()
    st = r.stats(time.perf_counter() - t0)
    require(np.isfinite(hdr).all() and hdr.shape == (512, 512, 3),
            "non-finite or misshapen image")
    require(hdr.mean() > 0, "black image")
    return (f"{scene.n_tris} triangle rows; mean radiance "
            f"{float(hdr.mean()):.4f}; {st.total_rays} traces, "
            f"{st.isect_tests_per_ray:.1f} primitive and "
            f"{st.measured_bbox_tests / max(st.total_rays, 1):.1f} box "
            f"tests per trace; phases {r.timer.report()}")


def kernel():
    import jax.numpy as jnp
    from rrt_tpu.ops import kernel_check as kc
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.types import BlackHoleParams
    bh = BlackHoleParams(position=jnp.array([0.0, 1.0, 0.0], jnp.float32),
                         radius=jnp.float32(0.1),
                         delta_theta=jnp.float32(0.1))
    lines, bad, flat, curved = [], [], [], []
    for name in ("cornell_lambertian", "cornell_blob"):
        scene, cam = load_scene(scene_path(name), 256, 256)
        for kind, rays in kc.probe_rays(scene, cam, 256).items():
            for b in (None, bh):
                res = kc.compare(scene, b, rays, 63, brute_lanes=8192)
                mode = "curved" if b is not None else "flat"
                for ref, r in res.items():
                    tag = f"{name}/{kind}/{mode} vs {ref}"
                    lines.append(f"{tag}: {json.dumps(r)}")
                    (curved if b is not None else flat).append(r)
                    if not r["ok"]:
                        bad.append(tag)
    with open(os.path.join(OUT, "smoke_kernel_check.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    require(not bad, f"rule broken in {bad} (details in "
            f"chiprun_out/smoke_kernel_check.txt)")
    return (f"{len(lines)} comparisons within the rule; flat: hit and prim "
            f"exact, p max diff {max(r['p_maxdiff'] for r in flat):.3g}; "
            f"curved: hit agreement >= "
            f"{min(r['hit_agree'] for r in curved):.5f}, prim >= "
            f"{min(r['prim_agree'] for r in curved):.5f}, calm lanes "
            f"{min(r['calm_share'] for r in curved):.3f}-"
            f"{max(r['calm_share'] for r in curved):.3f} of all, "
            f"{sum(r['calm_edge_ties'] for r in curved)} calm shared-edge "
            f"ties and {sum(r['calm_silhouette_flips'] for r in curved)} "
            f"silhouette flips")


def _diff_problem(w, h, curved=True):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rrt_tpu.render import diff
    from rrt_tpu.render.renderer import make_black_hole
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.utils.config import BlackHoleConfig, RenderConfig
    cfg = RenderConfig(width=w, height=h, ns_aa=1, ns_area_light=1,
                       max_ray_depth=2, seed=0,
                       black_hole=BlackHoleConfig(enabled=curved))
    scene, cam = load_scene(scene_path("cornell_lambertian"), w, h,
                            fov_mode="native")
    bh = make_black_hole(cfg)
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    rays = cam.generate_rays(jnp.asarray(xy))
    p_true = diff.params_from_scene(scene, bh)
    # start 20 % off in every material reflectance (and 40 % in the radius)
    p0 = p_true.replace(reflectance=p_true.reflectance * 0.8,
                        bh_radius=p_true.bh_radius * 1.4)
    return cfg, scene, bh, rays, p_true, p0, jax.random.key(3)


def _diff_step(cfg, scene, bh, rays, p_true, p0, key, backend, device,
               sharding=None):
    import jax
    from rrt_tpu.render import diff
    cfg = cfg.replace(trace_backend=backend)
    put = lambda t, s=None: jax.tree_util.tree_map(
        lambda a: jax.device_put(a, s if s is not None else device), t)
    scene, bh, p_true, p0 = put(scene), put(bh), put(p_true), put(p0)
    rays = put(rays, sharding)

    @jax.jit
    def step(p0, p_true, rays):
        target = diff.render_radiance(p_true, scene, bh, rays, cfg, key)
        loss, grads = jax.value_and_grad(diff.image_loss)(
            p0, scene, bh, rays, target, cfg, key)
        return loss, grads

    loss, grads = step(p0, p_true, rays)
    return jax.device_get(loss), jax.device_get(grads)


def _close(a, b, rtol):
    import numpy as np
    import jax
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    worst = 0.0
    for x, y in zip(la, lb):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        err = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-6))
        worst = max(worst, err) if np.isfinite(err) else float("inf")
    return worst <= rtol, worst


def cpu_reference_step(out_path):
    """The flat inverse step of phase (e) with the XLA trace on the CPU;
    run in a CPU-only child process (JAX_PLATFORMS=cpu), which never opens
    the card. Saves loss and gradient leaves to `out_path` (.npz)."""
    import jax
    import numpy as np
    loss, grads = _diff_step(*_diff_problem(64, 64, curved=False), "xla",
                             jax.devices()[0])
    np.savez(out_path, loss=loss,
             *[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _finite(loss, grads):
    import jax
    import numpy as np
    bad = [i for i, g in enumerate(jax.tree_util.tree_leaves(grads))
           if not np.isfinite(np.asarray(g)).all()]
    require(np.isfinite(float(loss)) and not bad,
            f"non-finite loss {float(loss)} or gradient leaves {bad}")


def inverse():
    """The curved step on the card must give a finite loss and gradient.
    Card and CPU are compared on the flat step: curved, a handful of
    wrapped lanes take other paths on each (as in phase d) and move the
    few-pixel loss by percent, while flat traces agree exactly and only
    summation order differs."""
    import jax
    import numpy as np
    loss_k, g_k = _diff_step(*_diff_problem(64, 64), "auto",
                             jax.devices()[0])
    _finite(loss_k, g_k)
    loss_g, g_gpu = _diff_step(*_diff_problem(64, 64, curved=False), "auto",
                               jax.devices()[0])
    _finite(loss_g, g_gpu)
    ref = os.path.join(OUT, "smoke_inverse_cpu.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c",
                        "import chip_smoke as c; c.cpu_reference_step("
                        f"{ref!r})"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    require(r.returncode == 0, f"CPU reference failed: {r.stderr[-1500:]}")
    z = np.load(ref)
    loss_c = float(z["loss"])
    leaves = jax.tree_util.tree_leaves(g_gpu)
    g_cpu = [z[f"arr_{i}"] for i in range(len(leaves))]
    ok_l = abs(float(loss_g) - loss_c) <= DIFF_RTOL * abs(loss_c)
    ok_g, worst = _close(leaves, g_cpu, DIFF_RTOL)
    require(ok_l and ok_g,
            f"flat, card vs CPU: loss {float(loss_g):.8g} vs {loss_c:.8g},"
            f" worst gradient leaf relative error {worst:.3g}")
    return (f"curved: loss {float(loss_k):.6g}, gradient finite; flat: loss "
            f"{float(loss_g):.8g} (CPU {loss_c:.8g}), worst gradient leaf "
            f"relative error vs CPU {worst:.3g} <= {DIFF_RTOL}")


def _kerr(path, extra=()):
    import numpy as np
    from rrt_tpu import kerr_cli
    from rrt_tpu.io.png import read_png
    rc, _ = quiet(kerr_cli.main, ["-f", path, "-r", "1024", "1024", "-s",
                                  "1", *extra])
    require(rc == 0 and os.path.exists(path), f"kerr_cli returned {rc}")
    img = read_png(path)[..., :3]
    require(img.shape == (1024, 1024, 3), f"image shape {img.shape}")
    require(img.max() > 10, "disk not visible")
    return img


def kerr():
    img = _kerr(os.path.join(OUT, "smoke_kerr.png"))
    return f"1024x1024 frame, mean 8-bit value {float(img.mean()):.2f}"


# ------------------------------------------------------- four-card phases

def sharded_primary():
    import numpy as np
    from rrt_tpu.parallel import sharding as sh
    from rrt_tpu.render.renderer import Renderer
    from rrt_tpu.scene.build import load_scene
    from rrt_tpu.scene.cornell import scene_path
    from rrt_tpu.utils.config import RenderConfig
    cfg = RenderConfig(width=256, height=256, ns_aa=16, ns_area_light=4,
                       max_ray_depth=5, seed=0)
    scene, cam = load_scene(scene_path("cornell_lambertian"), 256, 256)
    mesh = sh.make_mesh()
    t0 = time.perf_counter()
    hdr4, _ = Renderer(scene, cam, cfg,
                       sharding=sh.batch_sharding(mesh)).render()
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdr1, _ = Renderer(scene, cam, cfg).render()
    t1 = time.perf_counter() - t0
    require(np.isfinite(hdr4).all(), "non-finite sharded image")
    diff = np.abs(hdr4 - hdr1)
    same = float((diff == 0).mean())
    require(float(diff.max()) <= SHARD_ATOL,
            f"sharded image differs: {100 * (1 - same):.4f} % of values, "
            f"max |diff| {float(diff.max()):.3g} > {SHARD_ATOL}")
    return (f"{mesh.devices.size}-card image vs one card: "
            f"{100 * same:.2f} % of values identical, max |diff| "
            f"{float(diff.max()):.3g} <= {SHARD_ATOL} (first renders: "
            f"{t4:.2f} s sharded, {t1:.2f} s one card)")


def sharded_inverse():
    import jax
    from rrt_tpu.parallel import sharding as sh
    prob = _diff_problem(64, 64)
    mesh = sh.make_mesh()
    repl = sh.replicated(mesh)
    loss4, g4 = _diff_step(*prob, "auto", repl,
                           sharding=sh.batch_sharding(mesh))
    loss1, g1 = _diff_step(*prob, "auto", jax.devices()[0])
    # the gradient is a float32 sum over 4,096 lanes, reduced per card and
    # then across cards: another order, and its terms cancel, so the
    # bound is relative to the leaf's norm rather than last-bit
    ok_g, worst = _close(g4, g1, 1e-3)
    require(abs(float(loss4) - float(loss1)) <= 1e-6 * abs(float(loss1))
            and ok_g, f"loss {float(loss4):.8g} vs {float(loss1):.8g}, "
            f"worst gradient leaf relative error {worst:.3g}")
    return (f"loss {float(loss4):.8g} (one card {float(loss1):.8g}); worst "
            f"gradient leaf relative error {worst:.3g} <= 1e-3")


def sharded_kerr():
    import numpy as np
    img4 = _kerr(os.path.join(OUT, "smoke_kerr_sharded.png"),
                 ("--sharded",))
    img1 = _kerr(os.path.join(OUT, "smoke_kerr_one.png"))
    d = np.abs(img4.astype(np.int32) - img1.astype(np.int32))
    share = float((d > 0).mean())
    require(d.max() <= 1 and share <= 1e-3,
            f"{100 * share:.4f} % of 8-bit values differ, max {d.max()}")
    return (f"kerr_cli --sharded frame vs one card: {100 * share:.4f} % of "
            f"8-bit values differ, by at most {d.max()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the lane-sharded path on 4 cards")
    args = ap.parse_args(argv)
    n = 4 if args.four_cards else 1
    os.makedirs(OUT, exist_ok=True)
    try:
        import jax
        sys.path.insert(0, ROOT)
        from rrt_tpu.utils.jax_cache import enable_compile_cache
        print(f"card: {card()}", flush=True)
        print(f"compile cache: {enable_compile_cache()}", flush=True)
        phase("a devices", devices, n)
        if args.four_cards:
            phase("b sharded primary render", sharded_primary)
            phase("e sharded inverse step", sharded_inverse)
            phase("f kerr_cli --sharded", sharded_kerr)
        else:
            phase("b primary render", primary)
            phase("c bvh render", bvh)
            phase("d kernel vs references", kernel)
            phase("e inverse step", inverse)
            phase("f kerr", kerr)
    except PhaseFailed:
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
