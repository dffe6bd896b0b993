"""rrt_tpu — a differentiable relativistic path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
yvbbrjdr/relativistic-ray-tracer (a CPU C++ path tracer with Schwarzschild
ray bending): COLLADA scene loading, BVH-accelerated intersection, multi-BSDF
global illumination, area/point/directional/environment lights, adaptive
sampling, thin-lens depth of field, and geodesic ray marching around black
holes — reformulated as a wavefront renderer over flat ray batches, sharded
across device meshes, and differentiable w.r.t. scene and metric parameters.

Layer map (≈ reference layers, see SURVEY.md §1):
  utils/      L0  math helpers, config, PRNG, timers
  io/         L2  COLLADA / PNG / EXR
  scene/      L3-L5 scene build: meshes, cameras, lights, flat SoA scene
  geometry/   L7  BVH build + traversal, primitive intersection
  physics/    L7  geodesic integrators (Schwarzschild / Kerr / flat)
  render/     L6,L8 BSDFs, lights sampling, wavefront integrator, film
  parallel/   —   device mesh sharding (replaces the pthread tile pool)
  ops/        —   the fused trace kernel (Pallas through Triton, CUDA GPUs)
"""

__version__ = "0.1.0"

from rrt_tpu.utils.config import RenderConfig, BlackHoleConfig  # noqa: F401
