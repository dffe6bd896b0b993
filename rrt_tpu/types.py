"""Core pytree types: rays, hits, the flat SoA scene representation.

The reference keeps a pointer-rich object graph (Primitive*/BSDF* trees,
`static_scene/scene.h:48-77`). Here everything is flattened into
struct-of-arrays pytrees so that a megabatch of rays can be traced and shaded
with pure array ops under `jit`/`shard_map`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree. Fields made with
    `static_field` are metadata (part of the tree structure, hashed by
    `jit`); every other field is a child. Adds `.replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls


def static_field(default):
    return dataclasses.field(default=default, metadata={"static": True})


# BSDF type tags (reference classes in pathtracer/src/bsdf.h)
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_MICROFACET = 2
BSDF_REFRACTION = 3
BSDF_GLASS = 4
BSDF_EMISSION = 5

# Light type tags (reference classes in pathtracer/src/static_scene/light.h)
LIGHT_DIRECTIONAL = 0
LIGHT_HEMISPHERE = 1
LIGHT_POINT = 2
LIGHT_SPOT = 3        # stub in the reference (light.cpp:61-69): samples zero
LIGHT_AREA = 4
LIGHT_ENV = 5


@pytree_dataclass
class Rays:
    """A flat batch of rays; all fields broadcast on the leading batch axis.

    Mirrors `struct Ray` (reference src/ray.h:20-76) minus the mutable
    `max_t` narrowing, which becomes a functional `Hit.t` reduction.
    """

    o: jnp.ndarray        # (..., 3) origin
    d: jnp.ndarray        # (..., 3) unit direction
    min_t: jnp.ndarray    # (...,)
    max_t: jnp.ndarray    # (...,)


@pytree_dataclass
class Hit:
    """Closest-hit record (reference `struct Intersection`, intersection.h).

    Like the reference, stores world-space hit point and outgoing direction
    instead of a global `t` — with micro-ray marching there is no single
    parameter along the *original* ray (intersection.h:20-35 comment).
    """

    hit: jnp.ndarray        # (...,) bool
    t: jnp.ndarray          # (...,) chord-local t of the winning segment
    p: jnp.ndarray          # (..., 3) world hit point
    n: jnp.ndarray          # (..., 3) interpolated shading normal (NOT normalized,
                            #          matching barycentric sum in triangle.cpp:49)
    w_out: jnp.ndarray      # (..., 3) -micro_ray.d at the hit
    prim_id: jnp.ndarray    # (...,) int32 flat primitive id (tri ids then sphere ids)
    bsdf_id: jnp.ndarray    # (...,) int32 index into BSDFTable (-1 = none)


@pytree_dataclass
class BSDFTable:
    """SoA of every material in the scene (one row per BSDF instance).

    Parameters follow the constructors built by the COLLADA parser
    (reference collada.cpp:852-936).
    """

    kind: jnp.ndarray           # (B,) int32, BSDF_* tag
    reflectance: jnp.ndarray    # (B, 3) diffuse albedo / mirror / glass reflectance
    transmittance: jnp.ndarray  # (B, 3) refraction/glass
    emission: jnp.ndarray       # (B, 3) EmissionBSDF radiance
    eta: jnp.ndarray            # (B, 3) microfacet η spectrum
    k: jnp.ndarray              # (B, 3) microfacet k spectrum
    alpha: jnp.ndarray          # (B,) microfacet roughness
    ior: jnp.ndarray            # (B,) refraction/glass index

    def is_delta(self):
        """Delta (specular) BSDFs: mirror, refraction, glass (bsdf.h)."""
        return (
            (self.kind == BSDF_MIRROR)
            | (self.kind == BSDF_REFRACTION)
            | (self.kind == BSDF_GLASS)
        )


@pytree_dataclass
class LightTable:
    """SoA of scene lights (reference static_scene/light.{h,cpp}).

    The environment light is kept separately in `SceneData.env_*` because its
    CDF tables have their own shapes; rows here with kind LIGHT_ENV delegate
    to it.
    """

    kind: jnp.ndarray       # (L,) int32
    radiance: jnp.ndarray   # (L, 3)
    position: jnp.ndarray   # (L, 3)
    direction: jnp.ndarray  # (L, 3) AreaLight one-sided emission direction;
                            #        DirectionalLight stores dirToLight here
    dim_x: jnp.ndarray      # (L, 3) area light edge vectors
    dim_y: jnp.ndarray      # (L, 3)
    area: jnp.ndarray       # (L,)
    # static host-side copy of `kind` — the integrator unrolls the light
    # loop at trace time, like the reference's per-light for loop
    kind_host: tuple = static_field(())

    def is_delta(self):
        """Delta lights get 1 NEE sample instead of ns_area_light
        (part1_code.cpp:42). Directional/point are delta; hemisphere, area,
        and env are not; the spot stub is delta in the reference
        (light.h SpotLight::is_delta_light returns true)."""
        return (
            (self.kind == LIGHT_DIRECTIONAL)
            | (self.kind == LIGHT_POINT)
            | (self.kind == LIGHT_SPOT)
        )


@pytree_dataclass
class EnvMap:
    """Lat-long HDR environment light with 2-level CDF tables
    (reference environment_light.cpp:21-49)."""

    data: jnp.ndarray        # (H, W, 3) radiance
    pdf: jnp.ndarray         # (H, W) discrete pixel probabilities (sum = 1)
    cond_cdf: jnp.ndarray    # (H, W) per-row conditional CDF
    marg_cdf: jnp.ndarray    # (H,) row marginal CDF


@pytree_dataclass
class BlackHoleParams:
    """Differentiable Schwarzschild parameters (reference blackhole.{h,cpp}).

    `radius` doubles as event-horizon and Schwarzschild radius, exactly as in
    the reference (blackhole.cpp:13-15). `enabled` is static metadata."""

    position: jnp.ndarray     # (3,)
    radius: jnp.ndarray       # ()
    delta_theta: jnp.ndarray  # ()
    enabled: bool = static_field(True)


@pytree_dataclass
class SceneData:
    """The immutable render scene: flat triangle/sphere/material/light SoA.

    Replaces StaticScene::Scene + BVHAccel's primitive list (reference
    static_scene/scene.h, object.cpp:16-58). Triangles come first in the flat
    primitive index space, then spheres.
    """

    # triangles (T rows; padded rows have bsdf_id == -1 and degenerate verts)
    tri_v0: jnp.ndarray   # (T, 3)
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_n0: jnp.ndarray   # (T, 3) vertex normals
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_bsdf: jnp.ndarray  # (T,) int32

    # spheres (S rows)
    sph_center: jnp.ndarray  # (S, 3)
    sph_radius: jnp.ndarray  # (S,)
    sph_bsdf: jnp.ndarray    # (S,) int32

    bsdfs: BSDFTable
    lights: LightTable
    env: Optional[EnvMap] = None

    # two-level acceleration: Morton-ordered triangle rows grouped into
    # fixed-size clusters with AABBs (see geometry/clusters.py)
    cluster_lo: Optional[jnp.ndarray] = None  # (K, 3)
    cluster_hi: Optional[jnp.ndarray] = None  # (K, 3)
    cluster_size: int = static_field(64)
    # number of LIVE sphere rows (the build pads dead rows at the tail to
    # a fixed lane width); -1 = unknown → treat every row as live
    n_live_spheres: int = static_field(-1)

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_prims(self):
        return self.n_tris + self.n_spheres
