"""Kerr null-geodesic integration — new physics beyond the reference.

The reference only bends rays with the Schwarzschild photon-orbit ODE
(`blackhole.cpp:13-40`). For spinning holes we integrate the full Kerr
geodesics in Kerr–Schild (Cartesian) form, which is horizon-regular and
free of the Boyer–Lindquist coordinate singularities:

    g^{μν} = η^{μν} − 2H lᵘ lᵛ,     H = M r³ / (r⁴ + a² z²),
    l_μ = (1, (r x + a y)/(r²+a²), (r y − a x)/(r²+a²), z/r),

with r(x,y,z) the Kerr radius  r² = ½(ρ²−a²) + √(¼(ρ²−a²)² + a² z²).

Null rays follow Hamilton's equations of ℋ(x,p) = ½ g^{μν} p_μ p_ν with
RK4 in an affine parameter; ∂ℋ/∂x comes from `jax.grad` of the closed-form
scalar — exact Christoffel transport without writing a single Christoffel
symbol. a=0 reduces to exact-GR Schwarzschild (M = r_s/2), cross-validated
against an independent float64 Binet-equation (u'' = −u + 3Mu²) oracle in
tests/test_kerr.py::test_a0_cross_validates_binet_oracle. NOTE: this does
NOT match physics/schwarzschild.py, which deliberately reproduces the
reference's chord stepper — that stepper re-derives u' from the secant
chord each step, halving the effective curvature (deflection ≈ r_s/b,
half the GR value 2·r_s/b; pinned by
test_reference_stepper_bends_half_of_gr). Reference parity and correct
physics are different targets; this module is the latter.

The marcher exposes the same chord-segment interface as the reference's
micro-ray loop: each RK4 step yields a straight chord; callers intersect
scene geometry / the accretion disk against chords, kill rays inside the
horizon, and treat far-field rays as escaped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from rrt_tpu.types import pytree_dataclass


@pytree_dataclass
class KerrParams:
    position: jnp.ndarray   # (3,) hole center (world frame; spin axis = +y)
    mass: jnp.ndarray       # () geometric mass M (r_s = 2M)
    spin: jnp.ndarray       # () a = J/M in [0, M)

    @property
    def horizon_radius(self):
        return self.mass + jnp.sqrt(
            jnp.maximum(self.mass ** 2 - self.spin ** 2, 0.0))


def _kerr_r2(x, y, z, a):
    """Kerr radius² in Kerr–Schild coordinates (spin along z here)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    return 0.5 * b + jnp.sqrt(0.25 * b * b + a * a * z * z + 1e-30)


def hamiltonian(x3, p3, pt, mass, a):
    """ℋ = ½ g^{μν} p_μ p_ν for covariant momentum (pt, p3) at position x3.

    Spin axis is +z in this local frame (callers rotate world → hole
    frame). pt = p_t is conserved (stationarity); returns a scalar per
    batch element.
    """
    x, y, z = x3[..., 0], x3[..., 1], x3[..., 2]
    r2 = _kerr_r2(x, y, z, a)
    r = jnp.sqrt(r2)
    H = mass * r2 * r / (r2 * r2 + a * a * z * z + 1e-30)
    r2a2 = r2 + a * a
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / jnp.maximum(r, 1e-20)
    # g^{μν} p_μ p_ν = η^{μν} p_μ p_ν − 2H (l^μ p_μ)², η = diag(−1,1,1,1),
    # l_μ = (1, lx, ly, lz) ⇒ l^μ p_μ = −p_t + l⃗·p⃗
    p_sq = jnp.sum(p3 * p3, axis=-1)
    lp = -pt + p3[..., 0] * lx + p3[..., 1] * ly + p3[..., 2] * lz
    return 0.5 * (-pt * pt + p_sq - 2.0 * H * lp * lp)


def init_momentum(x3, d3, mass, a):
    """Covariant momentum for a null ray through x3 with spatial direction
    d3 (unit, hole frame), normalized to p_t = −1.

    Ansatz p3 = κ·d3 (spatial covariant momentum along the coordinate
    direction; exact as H→0, i.e. far from the hole where camera rays are
    born). The null condition fixes κ:

        ℋ = ½ g^{μν} p_μ p_ν,   g^{μν} = η^{μν} − 2H l^μ l^ν,
        η-part:   −p_t² + κ²|d3|² = −1 + κ²          (p_t = −1, |d3| = 1)
        l^μ p_μ = −p_t + κ·(l⃗·d3) = 1 + κ·ld
        ⇒ 2ℋ(κ) = κ²(1 − 2H·ld²) − 4H·ld·κ − (1 + 2H) = 0

    so A = 1 − 2H·ld², B = −4H·ld, C = −(1+2H) below. C < 0 always, so
    the two real roots straddle zero; (−B+√disc)/(2A) is the positive
    (future-directed, forward-along-d3) root for A > 0, which holds
    outside the ergosphere where rays are initialized.
    """
    pt = -1.0
    x, y, z = x3[..., 0], x3[..., 1], x3[..., 2]
    r2 = _kerr_r2(x, y, z, a)
    r = jnp.sqrt(r2)
    H = mass * r2 * r / (r2 * r2 + a * a * z * z + 1e-30)
    r2a2 = r2 + a * a
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / jnp.maximum(r, 1e-20)
    ld = d3[..., 0] * lx + d3[..., 1] * ly + d3[..., 2] * lz
    # ℋ(κ) = ½(−1 + κ²|d|² − 2H(−pt·1? ...)) — expand with lp = −pt + κ·ld
    # = ½(−1 + κ² − 2H (1 + κ·ld)²)  for unit d3, pt=−1 ⇒ lp = 1·? sign:
    # lp = −pt + κ ld = 1 + κ ld
    A = 1.0 - 2.0 * H * ld * ld
    B = -4.0 * H * ld
    C = -1.0 - 2.0 * H
    disc = jnp.maximum(B * B - 4.0 * A * C, 0.0)
    kappa = (-B + jnp.sqrt(disc)) / (2.0 * A)
    return pt * jnp.ones(x3.shape[:-1], x3.dtype), kappa[..., None] * d3


def _rhs(x3, p3, pt, mass, a):
    """Hamilton's equations via autodiff of ℋ."""
    dH_dp = jax.grad(
        lambda p: jnp.sum(hamiltonian(x3, p, pt, mass, a)))(p3)
    dH_dx = jax.grad(
        lambda x: jnp.sum(hamiltonian(x, p3, pt, mass, a)))(x3)
    return dH_dp, -dH_dx


def rk4_step(x3, p3, pt, mass, a, dlam):
    """One RK4 step of Hamilton's equations (batched; dlam may be scalar
    or per-lane (...,))."""
    dlam = jnp.asarray(dlam)
    if dlam.ndim == x3.ndim - 1:
        dlam = dlam[..., None]
    k1x, k1p = _rhs(x3, p3, pt, mass, a)
    k2x, k2p = _rhs(x3 + 0.5 * dlam * k1x, p3 + 0.5 * dlam * k1p,
                    pt, mass, a)
    k3x, k3p = _rhs(x3 + 0.5 * dlam * k2x, p3 + 0.5 * dlam * k2p,
                    pt, mass, a)
    k4x, k4p = _rhs(x3 + dlam * k3x, p3 + dlam * k3p, pt, mass, a)
    nx = x3 + dlam / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
    np_ = p3 + dlam / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)
    return nx, np_


class MarchState(NamedTuple):
    x: jnp.ndarray          # (..., 3) position (hole frame)
    p: jnp.ndarray          # (..., 3) covariant spatial momentum
    pt: jnp.ndarray         # (...,)
    captured: jnp.ndarray   # (...,) bool
    escaped: jnp.ndarray    # (...,) bool


def make_state(o_world, d_world, bh: KerrParams):
    """World rays → hole-frame march state. World spin axis is +y (the
    reference's up axis); the hole frame puts spin along +z."""
    # world→hole rotation: (x, y, z)_w → (x, −z, y)_h maps world +y (up)
    # to the hole's spin axis +z
    o = o_world - bh.position
    x3 = jnp.stack([o[..., 0], -o[..., 2], o[..., 1]], axis=-1)
    d3 = jnp.stack(
        [d_world[..., 0], -d_world[..., 2], d_world[..., 1]], axis=-1)
    pt, p3 = init_momentum(x3, d3, bh.mass, bh.spin)
    shape = x3.shape[:-1]
    return MarchState(
        x=x3, p=p3, pt=pt,
        captured=jnp.zeros(shape, bool),
        escaped=jnp.zeros(shape, bool))


def to_world(x3, bh: KerrParams):
    """Hole frame → world points (inverse of make_state rotation)."""
    return jnp.stack(
        [x3[..., 0], x3[..., 2], -x3[..., 1]], axis=-1) + bh.position


def march_step(st: MarchState, bh: KerrParams, dlam,
               r_escape: float = 50.0) -> Tuple[MarchState, Tuple]:
    """Advance one RK4 step; returns (new_state, (chord_a, chord_b)) in
    hole-frame coordinates. Captured/escaped rays freeze."""
    active = ~(st.captured | st.escaped)
    nx, np_ = rk4_step(st.x, st.p, st.pt, bh.mass, bh.spin, dlam)
    nx = jnp.where(active[..., None], nx, st.x)
    np_ = jnp.where(active[..., None], np_, st.p)
    r2 = _kerr_r2(nx[..., 0], nx[..., 1], nx[..., 2], bh.spin)
    rh = bh.horizon_radius
    captured = st.captured | (active & (r2 <= (rh * 1.02) ** 2))
    escaped = st.escaped | (active & (r2 > r_escape * r_escape))
    return MarchState(nx, np_, st.pt, captured, escaped), (st.x, nx)
