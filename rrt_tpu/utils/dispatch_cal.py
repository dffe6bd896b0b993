"""Measured dispatch-planner calibration.

The renderer's dispatch planner bounds per-dispatch device time with a
two-constant cost model: `calls × ALPHA + lanes·segments × BETA` seconds
(`render/renderer.py::_dispatch_plan`). The constants are FIT from a
one-shot measured probe — two steady-state trace timings at different
lane counts on the actual device and scene — and persisted per (device kind, backend) in the cache
directory, so every later process reuses the measurement.

The probe only runs when the planner would actually bind (the naive
estimate with conservative priors exceeds the dispatch budget); small
renders never pay for it. `RRT_DISPATCH_ALPHA`/`RRT_DISPATCH_BETA`
remain explicit overrides that skip both the cache and the probe.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Tuple

# conservative priors (seconds): used only to decide whether the probe
# is needed at all, and as clamps against degenerate fits
PRIOR_ALPHA = 0.5
PRIOR_BETA = 2.5e-8
ALPHA_RANGE = (1e-3, 10.0)
BETA_RANGE = (1e-11, 1e-5)


def cache_path(cache_dir: str, device_kind: str, backend: str) -> str:
    safe = "".join(c if c.isalnum() else "_" for c in device_kind)
    return os.path.join(cache_dir, f"dispatch_cal_{safe}_{backend}.json")


def fit_constants(runner: Callable[[int], float],
                  n_small: int = 1024,
                  n_large: int = 16384,
                  lane_cost_unit: int = 1) -> Tuple[float, float]:
    """Fit (alpha, beta) from two probe timings.

    `runner(n_lanes)` returns measured steady seconds for one trace call
    over n_lanes lanes; `lane_cost_unit` is the per-lane work multiplier
    the planner will use (n_seg for curved traces) so beta comes out in
    the planner's units (seconds per lane·segment).
    """
    t1 = runner(n_small)
    t2 = runner(n_large)
    beta = (t2 - t1) / max((n_large - n_small) * lane_cost_unit, 1)
    alpha = t1 - n_small * lane_cost_unit * beta
    beta = min(max(beta, BETA_RANGE[0]), BETA_RANGE[1])
    alpha = min(max(alpha, ALPHA_RANGE[0]), ALPHA_RANGE[1])
    return alpha, beta


def load_or_calibrate(cache_dir: str, device_kind: str, backend: str,
                      runner: Optional[Callable[[int], float]],
                      lane_cost_unit: int = 1) -> Tuple[float, float]:
    """Constants from (in order): env override, per-device cache file,
    fresh probe via `runner` (persisted), else priors."""
    env_a = os.environ.get("RRT_DISPATCH_ALPHA")
    env_b = os.environ.get("RRT_DISPATCH_BETA")
    if env_a or env_b:
        return (float(env_a or PRIOR_ALPHA), float(env_b or PRIOR_BETA))
    path = cache_path(cache_dir, device_kind, backend)
    try:
        with open(path) as f:
            d = json.load(f)
        return float(d["alpha"]), float(d["beta"])
    except (OSError, KeyError, ValueError):
        pass
    if runner is None:
        return PRIOR_ALPHA, PRIOR_BETA
    alpha, beta = fit_constants(runner, lane_cost_unit=lane_cost_unit)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"alpha": alpha, "beta": beta,
                       "device": device_kind, "backend": backend,
                       "when": time.time()}, f)
        os.replace(tmp, path)
    except OSError:
        pass
    return alpha, beta


def make_trace_runner(scene, bh, n_seg: int, backend: str,
                      clock: Callable[[], float] = time.monotonic):
    """Real probe: steady-state wall time of one closest-hit trace over n
    random lanes (compile + first dispatch excluded by a warmup call)."""
    import jax
    import jax.numpy as jnp
    from rrt_tpu.geometry.trace import trace
    from rrt_tpu.types import Rays

    def runner(n: int) -> float:
        import numpy as np
        rng = np.random.default_rng(0)
        o = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)
        d = rng.normal(size=(n, 3))
        d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                        jnp.float32)
        rays = Rays(o=o, d=d, min_t=jnp.zeros(n), max_t=jnp.full(n, 1e9))
        f = jax.jit(lambda r: trace(scene, bh, r, n_seg=n_seg,
                                    backend=backend).hit)
        jax.block_until_ready(f(rays))          # compile + warm
        t0 = clock()
        jax.block_until_ready(f(rays))
        return max(clock() - t0, 1e-4)

    return runner
