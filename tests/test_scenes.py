"""The scene generator (rrt_tpu/scene/cornell.py): committed files are
exactly what it writes, and each scene has the counts it promises."""
import numpy as np
import pytest

from rrt_tpu.scene import cornell
from rrt_tpu.scene.build import load_scene
from rrt_tpu.types import LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_POINT

# name -> (live triangles, live spheres, light kinds)
EXPECTED = {
    "cornell_lambertian": (8, 2, [LIGHT_AREA]),
    "cornell_specular": (8, 2, [LIGHT_AREA]),
    "cornell_microfacet": (8, 2, [LIGHT_AREA]),
    "cornell_empty": (8, 0, [LIGHT_POINT]),
    "cornell_blob": (8 + cornell.BLOB_TRIS, 0, [LIGHT_AREA]),
    "torus": (cornell.TORUS_TRIS, 0, [LIGHT_DIRECTIONAL]),
}


def test_expected_covers_every_scene():
    assert sorted(EXPECTED) == sorted(cornell.SCENES)


@pytest.mark.parametrize("name", sorted(cornell.SCENES))
def test_committed_scene_is_regenerated_byte_identical(name):
    with open(cornell.scene_path(name), encoding="utf-8", newline="") as f:
        committed = f.read()
    assert cornell.generate(name) == committed, (
        f"scenes/{name}.dae is stale: run python -m rrt_tpu.scene.cornell")


@pytest.mark.parametrize("name", sorted(cornell.SCENES))
def test_scene_counts(name):
    n_tris, n_sph, lights = EXPECTED[name]
    scene, _ = load_scene(cornell.scene_path(name))
    assert int(np.sum(np.asarray(scene.tri_bsdf) >= 0)) == n_tris
    assert int(np.sum(np.asarray(scene.sph_bsdf) >= 0)) == n_sph
    assert list(np.asarray(scene.lights.kind)) == lights


def test_write_all_to_other_dir(tmp_path):
    paths = cornell.write_all(str(tmp_path))
    assert len(paths) == len(cornell.SCENES)
    for p in paths:
        name = p.rsplit("/", 1)[-1][:-4]
        assert open(p, encoding="utf-8").read() == cornell.generate(name)


def test_blob_is_closed():
    """Every edge of the seeded blob is shared by exactly two triangles,
    with opposite orientation (a closed, consistently wound surface)."""
    from rrt_tpu.io import collada
    info = collada.load(cornell.scene_path("cornell_blob"))
    blob = [n.instance for n in info.nodes if n.name == "blob"][0]
    edges = {}
    for a, b, c in blob.polygons:
        for u, v in ((a, b), (b, c), (c, a)):
            edges[(u, v)] = edges.get((u, v), 0) + 1
    assert all(n == 1 for n in edges.values())
    assert all((v, u) in edges for u, v in edges)
