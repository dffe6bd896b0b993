"""Scene I/O tests: parse every committed scene (scenes/*.dae, written by
rrt_tpu/scene/cornell.py) and check the quantities the generator fixes."""
import math

import numpy as np
import pytest

from rrt_tpu.io import collada
from rrt_tpu.scene.build import load_scene
from rrt_tpu.types import LIGHT_AREA, LIGHT_HEMISPHERE
from rrt_tpu.scene.cornell import SCENES, scene_path


@pytest.mark.parametrize("name", sorted(SCENES))
def test_parse_all_scenes(name):
    scene, cam = load_scene(scene_path(name))
    n_tris = int(np.sum(np.asarray(scene.tri_bsdf) >= 0))
    n_sph = int(np.sum(np.asarray(scene.sph_bsdf) >= 0))
    assert n_tris + n_sph > 0
    assert np.all(np.isfinite(np.asarray(cam.pos)))
    # padded rows are tagged -1 and sit at the end
    tb = np.asarray(scene.tri_bsdf)
    assert np.all(tb[:n_tris] >= 0)
    assert np.all(tb[n_tris:] == -1)


def test_cbspheres_lambertian_structure():
    scene, cam = load_scene(scene_path("cornell_lambertian"))
    # 2 spheres + the open box's floor, back and side walls (4 quads)
    assert int(np.sum(np.asarray(scene.sph_bsdf) >= 0)) == 2
    assert int(np.sum(np.asarray(scene.tri_bsdf) >= 0)) == 8
    np.testing.assert_allclose(np.asarray(scene.sph_radius)[:2], 0.3, atol=1e-6)

    # area light at (0, 1.49, 0) pointing down, dims 0.6 x 0.8
    lk = np.asarray(scene.lights.kind)
    assert list(lk) == [LIGHT_AREA]
    np.testing.assert_allclose(
        np.asarray(scene.lights.position)[0], [0, 1.49, 0], atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(scene.lights.direction)[0], [0, -1, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.lights.area)[0], 0.48,
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(scene.lights.radiance)[0], [10, 10, 10], atol=1e-6)

    # camera: fitted fov for 800x600 from xfov=49.13434 (collada aspect fit)
    assert cam.h_fov == pytest.approx(49.13434, abs=1e-3)
    assert cam.v_fov == pytest.approx(
        2 * math.degrees(math.atan(
            math.tan(math.radians(49.13434 / 2)) / (800 / 600))), abs=1e-3)


def test_cbempty_point_light():
    # the empty box has only a technique_common <point> light (no CGL
    # profile)
    from rrt_tpu.types import LIGHT_POINT
    scene, _ = load_scene(scene_path("cornell_empty"))
    assert list(np.asarray(scene.lights.kind)) == [LIGHT_POINT]


def test_cbbunny_tri_count():
    scene, _ = load_scene(scene_path("cornell_blob"))
    # 28,576-tri seeded blob (the BVH-scale stand-in) + 8 box tris
    assert int(np.sum(np.asarray(scene.tri_bsdf) >= 0)) == 28584


def test_vertex_normals_unit_and_smooth():
    from rrt_tpu.scene import mesh as meshlib
    # a flat square split into two tris: all normals must be +z
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    n = meshlib.vertex_normals(verts, tris)
    np.testing.assert_allclose(n, np.tile([0, 0, 1.0], (4, 1)), atol=1e-12)


def test_camera_settings_roundtrip(tmp_path):
    _, cam = load_scene(scene_path("cornell_lambertian"))
    p = tmp_path / "cam.txt"
    cam.dump_settings(str(p))
    from rrt_tpu.scene.camera import Camera
    cam2 = Camera()
    cam2.load_settings(str(p))
    np.testing.assert_allclose(cam2.pos, cam.pos, rtol=1e-12)
    np.testing.assert_allclose(cam2.c2w, cam.c2w, rtol=1e-12)
    assert cam2.h_fov == pytest.approx(cam.h_fov)
    assert cam2.focal_distance == pytest.approx(cam.focal_distance)


def test_materials_glass_mirror():
    info = collada.load(scene_path("cornell_specular"))
    mats = [n.instance.material for n in info.nodes
            if isinstance(n.instance, collada.SphereInfo)]
    kinds = sorted(m.kind for m in mats if m)
    assert kinds == ["glass", "mirror"]


def test_polymesh_normals_texcoords_parsed():
    """Authored NORMAL/TEXCOORD sources + per-corner indices round-trip
    (collada.cpp:718-846); the renderer recomputes normals like the
    reference, but the data must be carried."""
    info = collada.load(scene_path("cornell_lambertian"))
    pm = [n.instance for n in info.nodes
          if type(n.instance).__name__ == "PolymeshInfo"]
    floor = [p for p in pm if len(p.vertices) == 4][0]
    assert floor.normals.shape[1] == 3 and len(floor.normals) >= 1
    assert floor.texcoords.shape[1] == 2
    assert len(floor.normal_indices) == len(floor.polygons)
    assert len(floor.texcoord_indices) == len(floor.polygons)
    for poly, ni, ti in zip(floor.polygons, floor.normal_indices,
                            floor.texcoord_indices):
        assert len(ni) == len(poly) and len(ti) == len(poly)
