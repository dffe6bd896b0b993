"""Deterministic COLLADA scenes: the Cornell family and two seeded meshes.

Every scene the tests, `bench.py` and `chip_smoke.py` render is written by
this module in the CGL profile that `rrt_tpu.io.collada` parses (polylist
triangles with NORMAL/TEXCOORD inputs, CGL `<sphere>` geometry, CGL area
lights and materials, `technique_common` point/directional lights). The
files are committed under `scenes/`; regenerate them with

    python -m rrt_tpu.scene.cornell [OUT_DIR]

Output is byte-identical across runs: geometry comes from closed-form
parametrisations and `random.Random(seed)` amplitudes, and every float is
written with a fixed format.

The Cornell box here has a floor, a back wall and two coloured side
walls (8 triangles); its front and top are open. In curved spacetime the
reference discards a shadow ray's distance limit (each chord carries its
own range, geometry/trace.py), so any surface beyond the light — a
ceiling, or an emissive panel around the light — would occlude every
curved shadow ray and leave the box lit by nothing. With the top open,
curved next-event estimation reaches the light, and shadow rays that
escape march all ⌈2π/Δθ⌉ chords, the trace's worst case.

Scenes (`SCENES`):
  cornell_lambertian  box + CGL area light under the open top + two
                      diffuse spheres (8 triangles, 2 spheres)
  cornell_specular    the same box with a mirror and a glass sphere
  cornell_microfacet  the same box with a copper microfacet sphere and a
                      diffuse one
  cornell_empty       the box lit by a point light, no spheres
  cornell_blob        the box plus a seeded closed mesh of 28,576
                      triangles (28,584 in all): the BVH-scale scene
  torus               a seeded bumpy torus of 2,496 triangles in free
                      space with a directional light
"""
from __future__ import annotations

import math
import os
import random
import sys
from typing import Dict, List, Sequence, Tuple

SCENE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "scenes")

Vec = Tuple[float, float, float]

# box interior: x, z in [-1, 1], y in [0, BOX_H]; front (+z) and top open
BOX_H = 1.5
LIGHT_Y = 1.49
LIGHT_RADIANCE = 10.0
SPHERE_R = 0.3
SPHERES = ((-0.45, SPHERE_R, -0.3), (0.45, SPHERE_R, 0.3))
BLOB_TRIS = 28576
TORUS_TRIS = 2496


def scene_path(name: str) -> str:
    """Path of a committed scene, e.g. scene_path("cornell_blob")."""
    return os.path.join(SCENE_DIR, name + ".dae")


def _f(v: float) -> str:
    s = f"{v:.6f}"
    return "0.000000" if s == "-0.000000" else s


def _fs(vals: Sequence[float]) -> str:
    return " ".join(_f(v) for v in vals)


def _matrix(rows: Sequence[Sequence[float]]) -> str:
    return "<matrix>" + " ".join(_fs(r) for r in rows) + "</matrix>"


def _translate(x: float, y: float, z: float) -> str:
    return _matrix(((1, 0, 0, x), (0, 1, 0, y), (0, 0, 1, z), (0, 0, 0, 1)))


class _Doc:
    """Accumulates library entries and scene nodes of one COLLADA file."""

    def __init__(self):
        self.cameras: List[str] = []
        self.lights: List[str] = []
        self.effects: List[str] = []
        self.materials: List[str] = []
        self.geometries: List[str] = []
        self.nodes: List[str] = []

    # ------------------------------------------------------- materials
    def diffuse(self, mid: str, rgb: Vec) -> str:
        self.effects.append(
            f'<effect id="{mid}-fx"><profile_COMMON><technique sid="common">'
            f"<phong><diffuse><color>{_fs(rgb)} 1.000000</color></diffuse>"
            f"</phong></technique></profile_COMMON></effect>")
        return self._material(mid)

    def cgl(self, mid: str, body: str) -> str:
        self.effects.append(
            f'<effect id="{mid}-fx"><extra><technique profile="CGL">{body}'
            f"</technique></extra></effect>")
        return self._material(mid)

    def _material(self, mid: str) -> str:
        self.materials.append(
            f'<material id="{mid}-mat"><instance_effect url="#{mid}-fx"/>'
            f"</material>")
        return mid + "-mat"

    # ------------------------------------------------------- geometry
    @staticmethod
    def _bind(mat: str) -> str:
        return (f"<bind_material><technique_common>"
                f'<instance_material symbol="m" target="#{mat}"/>'
                f"</technique_common></bind_material>")

    def mesh(self, gid: str, verts: Sequence[Vec],
             tris: Sequence[Tuple[int, int, int]], mat: str,
             normal: Vec = None):
        """Triangle polylist. With `normal`, one authored normal and a UV
        per vertex ride along (flat walls), so NORMAL/TEXCOORD inputs are
        exercised the way exported scenes carry them."""
        pos = [c for v in verts for c in v]
        src = (f'<source id="{gid}-pos"><float_array id="{gid}-pos-array" '
               f'count="{len(pos)}">{_fs(pos)}</float_array></source>')
        inputs = f'<input semantic="VERTEX" source="#{gid}-verts" offset="0"/>'
        if normal is not None:
            uv = [0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0][:2 * len(verts)]
            src += (f'<source id="{gid}-nrm"><float_array '
                    f'id="{gid}-nrm-array" count="3">{_fs(normal)}'
                    f"</float_array></source>"
                    f'<source id="{gid}-uv"><float_array id="{gid}-uv-array" '
                    f'count="{len(uv)}">{_fs(uv)}</float_array></source>')
            inputs += (f'<input semantic="NORMAL" source="#{gid}-nrm" '
                       f'offset="1"/><input semantic="TEXCOORD" '
                       f'source="#{gid}-uv" offset="2"/>')
            p = " ".join(f"{i} 0 {i}" for t in tris for i in t)
        else:
            p = " ".join(str(i) for t in tris for i in t)
        self.geometries.append(
            f'<geometry id="{gid}"><mesh>{src}'
            f'<vertices id="{gid}-verts"><input semantic="POSITION" '
            f'source="#{gid}-pos"/></vertices>'
            f'<polylist count="{len(tris)}">{inputs}'
            f"<vcount>{' '.join('3' for _ in tris)}</vcount><p>{p}</p>"
            f"</polylist></mesh></geometry>")
        self.nodes.append(
            f'<node id="{gid}-node" name="{gid}">'
            f'<instance_geometry url="#{gid}">{self._bind(mat)}'
            f"</instance_geometry></node>")

    def quad(self, gid: str, center: Vec, u: Vec, v: Vec, normal: Vec,
             mat: str):
        """Rectangle center ± u ± v as two triangles whose shading normal
        is `normal`. The loader gives an open mesh's boundary vertices the
        NEGATED winding normal (the reference's quirk, scene/mesh.py), so
        the triangles are wound against `normal`."""
        if _dot(_cross(u, v), normal) > 0:
            u, v = v, u
        c = center
        verts = [tuple(c[i] + su * u[i] + sv * v[i] for i in range(3))
                 for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        self.mesh(gid, verts, [(0, 1, 2), (0, 2, 3)], mat, normal=normal)

    def sphere(self, name: str, center: Vec, radius: float, mat: str):
        self.geometries.append(
            f'<geometry id="{name}-geo"><extra><technique profile="CGL">'
            f"<sphere><radius>{_f(radius)}</radius></sphere></technique>"
            f"</extra></geometry>")
        self.nodes.append(
            f'<node id="{name}-node" name="{name}">{_translate(*center)}'
            f'<instance_geometry url="#{name}-geo">{self._bind(mat)}'
            f"</instance_geometry></node>")

    # ------------------------------------------------------- camera, lights
    def camera(self, offset: Vec, xfov: float = 49.13434):
        """The loader orbits the camera about the scene bbox centre along
        unit(T·(0,0,-1,1)), so the node translation only sets the viewing
        direction (see scene/build.py)."""
        self.cameras.append(
            '<camera id="camera"><optics><technique_common><perspective>'
            f"<xfov>{_f(xfov)}</xfov><aspect_ratio>{_f(4 / 3)}"
            "</aspect_ratio><znear>0.100000</znear><zfar>100.000000</zfar>"
            "</perspective></technique_common></optics></camera>")
        self.nodes.append(
            f'<node id="camera-node" name="camera">{_translate(*offset)}'
            f'<instance_camera url="#camera"/></node>')

    def area_light(self):
        """0.6 × 0.8 CGL area light at y = LIGHT_Y facing down: the node
        matrix maps the light's local -z to -y, x to 0.6·x and y to 0.8·z."""
        rgb = (LIGHT_RADIANCE,) * 3
        self.lights.append(
            f'<light id="area"><extra><technique profile="CGL"><area>'
            f"<color>{_fs(rgb)}</color></area></technique></extra></light>")
        m = ((0.6, 0, 0, 0), (0, 0, 1, LIGHT_Y), (0, 0.8, 0, 0),
             (0, 0, 0, 1))
        self.nodes.append(f'<node id="area-node" name="area_light">'
                          f'{_matrix(m)}<instance_light url="#area"/></node>')

    def point_light(self, pos: Vec, rgb: Vec):
        self.lights.append(
            f'<light id="point"><technique_common><point><color>{_fs(rgb)}'
            f"</color><constant_attenuation>1.000000</constant_attenuation>"
            f"</point></technique_common></light>")
        self.nodes.append(f'<node id="point-node" name="point_light">'
                          f'{_translate(*pos)}<instance_light url="#point"/>'
                          f"</node>")

    def directional_light(self, to_light: Vec, rgb: Vec):
        """The loader transforms the light's (0,0,-1) as a point, so the
        translation is chosen to make T·(0,0,-1,1) = to_light."""
        self.lights.append(
            f'<light id="sun"><technique_common><directional>'
            f"<color>{_fs(rgb)}</color></directional></technique_common>"
            f"</light>")
        x, y, z = to_light
        self.nodes.append(f'<node id="sun-node" name="sun">'
                          f'{_translate(x, y, z + 1.0)}'
                          f'<instance_light url="#sun"/></node>')

    def xml(self) -> str:
        lib = lambda tag, items: (f"<{tag}>\n" + "\n".join(items)
                                  + f"\n</{tag}>\n") if items else ""
        return (
            '<?xml version="1.0" encoding="utf-8"?>\n'
            '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" '
            'version="1.4.1">\n'
            "<asset><up_axis>Y_UP</up_axis></asset>\n"
            + lib("library_cameras", self.cameras)
            + lib("library_lights", self.lights)
            + lib("library_effects", self.effects)
            + lib("library_materials", self.materials)
            + lib("library_geometries", self.geometries)
            + '<library_visual_scenes><visual_scene id="scene">\n'
            + "\n".join(self.nodes)
            + "\n</visual_scene></library_visual_scenes>\n"
            '<scene><instance_visual_scene url="#scene"/></scene>\n'
            "</COLLADA>\n")


def _cross(a: Vec, b: Vec) -> Vec:
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a: Vec, b: Vec) -> float:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _box(doc: _Doc, light: bool = True):
    """Floor, back and side walls facing inward, and the area light."""
    white = doc.diffuse("white", (0.725, 0.71, 0.68))
    red = doc.diffuse("red", (0.63, 0.065, 0.05))
    green = doc.diffuse("green", (0.14, 0.45, 0.091))
    h = BOX_H / 2
    doc.quad("floor", (0, 0, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0), white)
    doc.quad("back", (0, h, -1), (1, 0, 0), (0, h, 0), (0, 0, 1), white)
    doc.quad("left", (-1, h, 0), (0, 0, 1), (0, h, 0), (1, 0, 0), red)
    doc.quad("right", (1, h, 0), (0, 0, 1), (0, h, 0), (-1, 0, 0), green)
    if light:
        doc.area_light()
    doc.camera((0.0, 0.0, 2.0))


def _cornell(kind: str) -> str:
    doc = _Doc()
    _box(doc)
    if kind == "lambertian":
        a = doc.diffuse("sphere_a", (0.8, 0.8, 0.8))
        b = doc.diffuse("sphere_b", (0.6, 0.7, 0.9))
    elif kind == "specular":
        a = doc.cgl("mirror", "<mirror><reflectance>"
                    f"{_fs((1, 1, 1))}</reflectance></mirror>")
        b = doc.cgl("glass", "<glass><transmittance>"
                    f"{_fs((1, 1, 1))}</transmittance><reflectance>"
                    f"{_fs((1, 1, 1))}</reflectance><ior>1.500000</ior>"
                    "</glass>")
    elif kind == "microfacet":
        # copper: eta/k at the R, G, B sample wavelengths
        a = doc.cgl("copper", "<microfacet><alpha>0.300000</alpha>"
                    f"<eta>{_fs((0.2004, 0.924, 1.1022))}</eta>"
                    f"<k>{_fs((3.9129, 2.4528, 2.1421))}</k></microfacet>")
        b = doc.diffuse("sphere_b", (0.6, 0.7, 0.9))
    else:
        raise ValueError(kind)
    doc.sphere("sphere_a", SPHERES[0], SPHERE_R, a)
    doc.sphere("sphere_b", SPHERES[1], SPHERE_R, b)
    return doc.xml()


def _cornell_empty() -> str:
    doc = _Doc()
    _box(doc, light=False)
    doc.point_light((0.0, 1.3, 0.0), (3.0, 3.0, 3.0))
    return doc.xml()


def _bumps(rng: random.Random, n: int, amp: float):
    """n seeded (amplitude, m, k, phase) terms with Σ|amplitude| ≤ amp."""
    terms = [(rng.uniform(0.2, 1.0), rng.randint(1, 5), rng.randint(1, 4),
              rng.uniform(0.0, 2 * math.pi)) for _ in range(n)]
    s = sum(t[0] for t in terms)
    return [(a * amp / s, m, k, p) for a, m, k, p in terms]


def _blob(seed: int = 7) -> str:
    """Closed star-shaped mesh on the box floor: a UV sphere of
    STACKS × SLICES whose radius carries seeded sin(kθ)·sin(mφ+p) bumps
    (zero at the poles, so the surface stays closed and smooth there).
    2·SLICES·(STACKS-1) = 28,576 triangles."""
    slices, stacks = 188, 77
    rng = random.Random(seed)
    terms = _bumps(rng, 6, 0.35)
    r0, cy = 0.42, 0.6

    def radius(th: float, ph: float) -> float:
        return r0 * (1.0 + sum(a * math.sin(k * th) * math.sin(m * ph + p)
                               for a, m, k, p in terms))

    verts: List[Vec] = [(0.0, cy + r0, 0.0)]
    for i in range(1, stacks):
        th = math.pi * i / stacks
        for j in range(slices):
            ph = 2 * math.pi * j / slices
            r = radius(th, ph)
            verts.append((r * math.sin(th) * math.cos(ph),
                          cy + r * math.cos(th),
                          r * math.sin(th) * math.sin(ph)))
    verts.append((0.0, cy - r0, 0.0))
    south = len(verts) - 1
    ring = lambda i, j: 1 + (i - 1) * slices + j % slices
    tris = []
    for j in range(slices):
        tris.append((0, ring(1, j + 1), ring(1, j)))
        tris.append((south, ring(stacks - 1, j), ring(stacks - 1, j + 1)))
    for i in range(1, stacks - 1):
        for j in range(slices):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j + 1), ring(i + 1, j)
            tris += [(a, b, c), (a, c, d)]
    assert len(tris) == BLOB_TRIS
    doc = _Doc()
    _box(doc)
    mesh_mat = doc.diffuse("blob", (0.75, 0.72, 0.65))
    doc.mesh("blob", verts, _outward(verts, tris, lambda c: (0.0, cy, 0.0)),
             mesh_mat)
    return doc.xml()


def _torus(seed: int = 11) -> str:
    """Seeded bumpy torus, 2·52·24 = 2,496 triangles, with a camera and a
    directional light and no box around it."""
    major, minor, nu, nv = 1.0, 0.35, 52, 24
    rng = random.Random(seed)
    terms = _bumps(rng, 4, 0.3)
    verts: List[Vec] = []
    for i in range(nu):
        u = 2 * math.pi * i / nu
        for j in range(nv):
            v = 2 * math.pi * j / nv
            r = minor * (1.0 + sum(a * math.sin(k * v + p) * math.cos(m * u)
                                   for a, m, k, p in terms))
            verts.append(((major + r * math.cos(v)) * math.cos(u),
                          r * math.sin(v),
                          (major + r * math.cos(v)) * math.sin(u)))
    idx = lambda i, j: (i % nu) * nv + j % nv
    tris = []
    for i in range(nu):
        for j in range(nv):
            a, b = idx(i, j), idx(i + 1, j)
            c, d = idx(i + 1, j + 1), idx(i, j + 1)
            tris += [(a, b, c), (a, c, d)]
    assert len(tris) == TORUS_TRIS
    def ring_centre(c: Vec) -> Vec:
        ang = math.atan2(c[2], c[0])
        return (major * math.cos(ang), 0.0, major * math.sin(ang))

    doc = _Doc()
    mat = doc.diffuse("torus", (0.7, 0.5, 0.3))
    doc.mesh("torus", verts, _outward(verts, tris, ring_centre), mat)
    doc.directional_light((0.3, 1.0, 0.5), (2.0, 2.0, 2.0))
    doc.camera((0.0, -0.6, 2.0))
    return doc.xml()


def _sub(a: Vec, b: Vec) -> Vec:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _outward(verts, tris, centre_of):
    """Wind every triangle away from `centre_of(triangle centroid)`."""
    out = []
    for t in tris:
        p = [verts[i] for i in t]
        c = tuple(sum(q[k] for q in p) / 3 for k in range(3))
        n = _cross(_sub(p[1], p[0]), _sub(p[2], p[0]))
        out.append(t if _dot(n, _sub(c, centre_of(c))) >= 0
                   else (t[0], t[2], t[1]))
    return out


SCENES: Dict[str, object] = {
    "cornell_lambertian": lambda: _cornell("lambertian"),
    "cornell_specular": lambda: _cornell("specular"),
    "cornell_microfacet": lambda: _cornell("microfacet"),
    "cornell_empty": _cornell_empty,
    "cornell_blob": _blob,
    "torus": _torus,
}


def generate(name: str) -> str:
    """The COLLADA text of one scene."""
    return SCENES[name]()


def write_all(out_dir: str = SCENE_DIR) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in SCENES:
        path = os.path.join(out_dir, name + ".dae")
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            f.write(generate(name))
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in write_all(*(sys.argv[1:2] or [SCENE_DIR])):
        print(p)
