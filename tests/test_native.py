"""Native C++ data-loading library vs the NumPy fallbacks."""
import numpy as np
import pytest

from rrt_tpu.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built")


def test_parse_floats():
    text = "  1.5 -2e3\n0.25\t7 "
    np.testing.assert_array_equal(
        native.parse_floats(text), [1.5, -2000.0, 0.25, 7.0])


def test_parse_ints():
    np.testing.assert_array_equal(
        native.parse_ints("3 1 4 1 5 92"), [3, 1, 4, 1, 5, 92])


def test_morton_order_matches_numpy():
    from rrt_tpu.geometry import clusters
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-3, 3, (500, 3))
    v1 = v0 + rng.uniform(-0.2, 0.2, (500, 3))
    v2 = v0 + rng.uniform(-0.2, 0.2, (500, 3))
    nat = native.morton_order(v0, v1, v2)
    c = (v0 + v1 + v2) / 3.0
    ref = np.argsort(clusters.morton3(c), kind="stable")
    np.testing.assert_array_equal(nat, ref)


def test_cluster_bboxes_match_numpy():
    rng = np.random.default_rng(1)
    n = 256
    v0 = rng.uniform(-3, 3, (n, 3))
    v1 = v0 + 0.1
    v2 = v0 - 0.1
    valid = rng.random(n) > 0.1
    lo_n, hi_n = native.cluster_bboxes(v0, v1, v2, valid, 64)
    # numpy fallback path
    from rrt_tpu.geometry.clusters import cluster_bboxes as py_impl
    import rrt_tpu.utils.native as nat_mod
    saved = nat_mod._LIB
    nat_mod._LIB = None
    nat_mod._TRIED = True
    try:
        lo_p, hi_p = py_impl(v0, v1, v2, valid, 64)
    finally:
        nat_mod._LIB = saved
    np.testing.assert_allclose(lo_n, lo_p)
    np.testing.assert_allclose(hi_n, hi_p)


def test_vertex_normals_match_numpy():
    rng = np.random.default_rng(2)
    verts = rng.uniform(-1, 1, (50, 3))
    tris = rng.integers(0, 50, (80, 3))
    nat = native.vertex_normals(verts, tris)
    import rrt_tpu.utils.native as nat_mod
    saved = nat_mod._LIB
    nat_mod._LIB = None
    nat_mod._TRIED = True
    try:
        from rrt_tpu.scene.mesh import vertex_normals
        ref = vertex_normals(verts, tris)
    finally:
        nat_mod._LIB = saved
    np.testing.assert_allclose(nat, ref, atol=1e-12)


def test_concurrent_builds_leave_a_loadable_library():
    """Parallel first uses each compile to a private temp file and rename
    it into place: every builder succeeds, the result loads, and no
    temporary file is left behind."""
    import ctypes
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-m", "rrt_tpu.utils.native"],
                              env=env, cwd=root, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-1000:]
    ctypes.CDLL(native._SO)
    build_dir = os.path.dirname(native._SO)
    assert [f for f in os.listdir(build_dir) if f.startswith(".")] == []
