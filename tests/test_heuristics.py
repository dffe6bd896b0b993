"""Guardrails for the traversal's lane-sort gate (geometry/trace.py).

These pin the DECISION, not a timing: the (octant, origin-Morton) lane
sort runs only for batches large enough to amortize the argsort and for
scenes with clusters to skip; a change that flips it for a committed
scene class must be deliberate, with fresh measurements.
"""
import jax.numpy as jnp

from rrt_tpu.geometry import trace as T
from rrt_tpu.io import collada
from rrt_tpu.scene.build import build_scene
from rrt_tpu.scene.cornell import scene_path


def test_sort_gate_pinned():
    assert not T.should_sort(1024, 1000)    # small batch
    assert not T.should_sort(65536, 16)     # few clusters
    assert T.should_sort(2048, 32)
    assert T.should_sort(65536, 894)        # BVH-scale class


def test_sort_gate_on_shipped_scene_classes():
    small, _ = build_scene(
        collada.load(scene_path("cornell_lambertian")), 64, 64)
    big, _ = build_scene(collada.load(scene_path("cornell_blob")), 64, 64)
    # BVH-scale frames sort; small direct-light batches on the sphere
    # scene never pay for it
    assert T.should_sort(512 * 512, int(big.cluster_lo.shape[0]))
    assert not T.should_sort(1500, int(small.cluster_lo.shape[0]))


def test_lane_order_is_a_permutation():
    big, _ = build_scene(collada.load(scene_path("cornell_blob")), 64, 64)
    n = 4096
    o = jnp.stack([jnp.linspace(-1, 1, n)] * 3, axis=-1)
    d = jnp.stack([jnp.cos(jnp.arange(n)), jnp.sin(jnp.arange(n)),
                   jnp.ones(n)], axis=-1)
    perm = T.lane_order(big, o, d)
    assert perm is not None
    assert sorted(perm.tolist()) == list(range(n))
    small, _ = build_scene(
        collada.load(scene_path("cornell_lambertian")), 64, 64)
    assert T.lane_order(small, o, d) is None
