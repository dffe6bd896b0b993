"""The fused Triton trace kernel against the XLA path and brute force.

On the CPU the kernel runs through the Pallas interpreter
(`interpret=True`); the compiled kernel runs on the GPU in the `gpu`-marked
test below and in chip_smoke.py phase (d), at real widths."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rrt_tpu.geometry import trace as T
from rrt_tpu.ops import kernel_check as kc
from rrt_tpu.ops import trace_kernel as tk
from rrt_tpu.ops.trace_kernel import pallas_trace
from rrt_tpu.scene.build import load_scene
from rrt_tpu.scene.cornell import scene_path
from rrt_tpu.types import BlackHoleParams, Rays

BH = dict(position=jnp.array([0.0, 1.0, 0.0]), radius=jnp.array(0.1),
          delta_theta=jnp.array(0.1))


def _rays(n, seed=2):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.8, 0.8, (n, 3)) * np.array([1, 0.5, 1])
         + [0, 0.75, 0]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(o=jnp.asarray(o), d=jnp.asarray(d, jnp.float32),
                min_t=jnp.zeros(n), max_t=jnp.full(n, 1e9))


@pytest.fixture(scope="module")
def scene():
    s, _ = load_scene(scene_path("cornell_lambertian"))
    return s


def _check(scene, bh, rays):
    hp, sp = pallas_trace(scene, bh, rays, n_seg=63, interpret=True,
                          return_seg=True)
    hx, sx = T.trace_with_seg(scene, bh, rays, n_seg=63, backend="xla")
    calm = None if bh is None else kc.calm_lanes(bh, rays, 63,
                                                 jnp.maximum(sp, sx))
    return kc.check(hp, hx, bh is not None, calm), hp, hx


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_kernel_matches_xla(scene, curved):
    rays = _rays(1500)  # not a multiple of the block's lanes
    bh = BlackHoleParams(**BH) if curved else None
    res, hp, hx = _check(scene, bh, rays)
    assert res["ok"], res
    if curved:
        assert res["calm_share"] > 0.3, "classifier marks too many chaotic"
    else:
        m = np.asarray(hp.hit)
        assert (np.asarray(hp.bsdf_id)[m] == np.asarray(hx.bsdf_id)[m]).all()


@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_kernel_multipart_matches_xla(curved):
    """A scene spanning many cluster groups (the 2,496-triangle torus: 156
    clusters in 10 groups) traced from random points around it."""
    s, _ = load_scene(scene_path("torus"))
    lo = np.asarray(s.cluster_lo).min(0)
    hi = np.asarray(s.cluster_hi).max(0)
    rng = np.random.default_rng(7)
    n = 300
    o = (lo - 0.2 * (hi - lo)
         + rng.uniform(0, 1, (n, 3)) * 1.4 * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(o=jnp.asarray(o), d=jnp.asarray(d, jnp.float32),
                min_t=jnp.zeros(n), max_t=jnp.full(n, 1e9))
    c = 0.5 * (lo + hi)
    bh = BlackHoleParams(position=jnp.asarray(c, jnp.float32),
                         radius=jnp.array(0.05 * float((hi - lo).max())),
                         delta_theta=jnp.array(0.1)) if curved else None
    assert tk.Hierarchy.of(s.n_tris).n_groups > 1
    res, _, _ = _check(s, bh, rays)
    assert res["ok"], res


def test_kernel_flat_respects_max_t(scene):
    o = jnp.array([[0.0, 0.2, 0.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)     # back wall at t=1
    mk = lambda mt: Rays(o=o, d=d, min_t=jnp.zeros(1),
                         max_t=jnp.full(1, mt, jnp.float32))
    assert bool(pallas_trace(scene, None, mk(10.0), 1,
                             interpret=True).hit[0])
    assert not bool(pallas_trace(scene, None, mk(0.5), 1,
                                 interpret=True).hit[0])


def test_kernel_absorption(scene):
    bh = BlackHoleParams(position=jnp.array([0.0, 0.75, 0.0]),
                         radius=jnp.array(0.3), delta_theta=jnp.array(0.1))
    d = np.array([[-1.0, 0.02, 0.0]])
    d /= np.linalg.norm(d)
    rays = Rays(o=jnp.array([[0.9, 0.75, 0.0]], jnp.float32),
                d=jnp.asarray(d, jnp.float32),
                min_t=jnp.zeros(1), max_t=jnp.full(1, 1e9))
    h, seg = pallas_trace(scene, bh, rays, n_seg=63, interpret=True,
                          return_seg=True)
    assert not bool(h.hit[0])
    assert int(seg[0]) == 63          # absorbed lanes report no segment


def test_kernel_work_counters(scene):
    """Both backends measure nonzero primitive and box tests for a shared
    hitting workload. The kernel tests a chord only until its lane's
    first event, so it pays fewer primitive tests than the XLA path,
    which runs dense rounds over whole lane chunks."""
    rays = _rays(1024)
    bh = BlackHoleParams(**BH)
    h, st = pallas_trace(scene, bh, rays, n_seg=63, interpret=True,
                         return_stats=True)
    st = np.asarray(st)
    assert st.shape == (2,)
    assert st[0] > 0 and st[1] > 0          # work was measured
    assert int(np.asarray(h.hit).sum()) > 0
    hx, stx = T.trace(scene, bh, rays, backend="xla", return_stats=True)
    stx = np.asarray(stx)
    assert stx.shape == (2,)
    assert stx[0] > 0 and stx[1] > 0
    assert stx[0] >= st[0], (st, stx)


def test_flat_trace_counters(scene):
    """Flat (curvature-off) XLA closest hit also measures its work."""
    rays = _rays(512)
    h, st = T.trace(scene, None, rays, backend="xla", return_stats=True)
    st = np.asarray(st)
    assert st[0] > 0 and st[1] > 0
    assert int(np.asarray(h.hit).sum()) > 0


def test_occlusion_mode_matches_closest_hit(scene):
    """Any-hit mode (shadow queries): the hit BOOL must be identical to
    the closest-hit kernel's — including absorption-beats-geometry lanes
    — while skipping the closest-t refinement."""
    rays = _rays(1500, seed=11)
    bh = BlackHoleParams(**BH)
    h_any = pallas_trace(scene, bh, rays, n_seg=63, interpret=True,
                         occlusion=True)
    h_full = pallas_trace(scene, bh, rays, n_seg=63, interpret=True)
    np.testing.assert_array_equal(np.asarray(h_any.hit),
                                  np.asarray(h_full.hit))


@pytest.mark.parametrize("lanes", [16, 32, 128])
def test_kernel_block_size_does_not_change_results(scene, lanes):
    """Every lane's result is independent of its block: any power-of-two
    block size and any padding of the last block give the same hits. (The
    interpreter compiles the block's arithmetic per width, so chord
    lengths may differ in the last bits and t is compared to 1e-2.)"""
    rays = _rays(200, seed=5)
    bh = BlackHoleParams(**BH)
    ref = pallas_trace(scene, bh, rays, n_seg=63, interpret=True)
    h = pallas_trace(scene, bh, rays, n_seg=63, interpret=True, lanes=lanes)
    np.testing.assert_array_equal(np.asarray(h.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(h.prim_id),
                                  np.asarray(ref.prim_id))
    np.testing.assert_allclose(np.asarray(h.t), np.asarray(ref.t),
                               rtol=1e-2)


def test_kernel_matches_brute_force():
    """The flat kernel against `closest_hit_brute` on the torus."""
    s, cam = load_scene(scene_path("torus"), 24, 24, fov_mode="native")
    rays = kc.probe_rays(s, cam, 24)["bounce"]
    hb, _ = kc.brute_trace(s, None, rays, 1)
    hp = pallas_trace(s, None, rays, 1, interpret=True)
    res = kc.check(hp, hb, False, None)
    assert res["ok"] and res["hits"] > 50, res


def test_kernel_seg_matches_xla(scene):
    """The winning segment index (trace_with_seg, used by trace_diff)."""
    rays = _rays(400, seed=3)
    bh = BlackHoleParams(**BH)
    hp, sp = pallas_trace(scene, bh, rays, n_seg=63, interpret=True,
                          return_seg=True)
    hx, sx = T.trace_with_seg(scene, bh, rays, n_seg=63, backend="xla")
    calm = kc.calm_lanes(bh, rays, 63, jnp.maximum(sp, sx))
    m = calm & np.asarray(hp.hit)
    assert m.sum() > 50
    np.testing.assert_array_equal(np.asarray(sp)[m], np.asarray(sx)[m])
    assert (np.asarray(sp)[~np.asarray(hp.hit)] == 63).all()


def test_hierarchy_shapes():
    h = tk.Hierarchy.of(28608)
    assert h.n_tris == 28608 and h.n_tris % tk.TILE == 0
    assert h.n_clusters * tk.TILE >= h.n_tris
    assert h.n_clusters == h.n_groups * tk.GROUP
    h = tk.Hierarchy.of(1)
    assert (h.n_tris, h.n_clusters, h.n_groups) == (
        tk.TILE, tk.GROUP, 1)


def test_empty_boxes_fail_every_slab(scene):
    """Padding clusters get a point box at +BIG, never an inverted box."""
    tri, cbox, gbox, sph = tk.build_tables(scene)
    h = tk.Hierarchy.of(scene.n_tris)
    assert tri.shape == (10, h.n_tris)
    assert cbox.shape == (6, h.n_clusters)
    assert gbox.shape == (6, h.n_groups + 1)      # + the root box
    g = np.asarray(gbox)
    assert (g[:3, -1] <= g[:3, :-1].min(axis=1)).all()
    assert (g[3:, -1] >= g[3:, :-1].max(axis=1)).all()
    cbox = np.asarray(cbox)
    empty = cbox[0] >= tk.BIG
    assert empty.any() and (cbox[:, empty] == np.float32(tk.BIG)).all()
    assert (cbox[:3, ~empty] <= cbox[3:, ~empty]).all()


def test_auto_backend_is_xla_off_gpu(scene):
    """"auto" resolves to the XLA path on the CPU, and asking for the
    kernel where it cannot compile is an error, not a silent fallback."""
    assert T._resolve_backend("auto") == "xla"
    rays = _rays(8)
    with pytest.raises(ValueError, match="CUDA GPU"):
        T.trace(scene, None, rays, backend="pallas")
    with pytest.raises(ValueError, match="unknown"):
        T._resolve_backend("mosaic")


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (covered by chip_smoke.py phase d)")


@pytest.mark.gpu
def test_compiled_kernel_matches_references(gpu):
    """The compiled kernel at real width on both Cornell-class scenes."""
    for name in ("cornell_lambertian", "cornell_blob"):
        s, cam = load_scene(scene_path(name), 256, 256)
        for rays in kc.probe_rays(s, cam, 256).values():
            for bh in (None, BlackHoleParams(**BH)):
                res = kc.compare(s, bh, rays, brute_lanes=8192)
                assert all(r["ok"] for r in res.values()), (name, res)
