"""Table-driven BSDF evaluation and importance sampling.

The reference dispatches through C++ virtual calls on per-primitive BSDF
objects (`bsdf.h:57-113`); here each ray lane gathers its material row from
the `BSDFTable` and all six models are evaluated branchlessly, with the
lane's `kind` tag selecting the result — the batched replacement for
virtual dispatch (no divergence, everything fuses into the wavefront
kernel).

All directions are in the local shading frame (z = shading normal). The
math matches the reference exactly, including its quirks:

* Diffuse: f = albedo/π, cosine-weighted sampling with pdf = √(1−ξ₁)/π
  (part1_code.cpp:165-173, sampler.cpp:47-56).
* Mirror: delta; weight reflectance/|cosθ|, pdf 1 (bsdf.cpp:33-41).
* Microfacet: Beckmann NDF + erf-Smith Λ + (Rs+Rp)/2 conductor Fresnel;
  half-vector importance sampling with the reference's pdf conversion
  (bsdf.h:159-191, bsdf.cpp:43-96).
* Refraction: stub that scatters nothing (bsdf.cpp:100-106).
* Glass: Schlick coin-flip between reflection and refraction — with the
  reference's quirk of feeding the REFRACTED direction's cosine into
  Schlick (bsdf.cpp:108-140).
* Emission: emits radiance, scatters nothing (bsdf.cpp:163-171).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from rrt_tpu.types import (
    BSDF_DIFFUSE, BSDF_EMISSION, BSDF_GLASS, BSDF_MICROFACET, BSDF_MIRROR,
    BSDF_REFRACTION, BSDFTable,
)

PI = math.pi


class BSDFSample(NamedTuple):
    wi: jnp.ndarray      # (..., 3) local sampled direction
    pdf: jnp.ndarray     # (...,)
    value: jnp.ndarray   # (..., 3) the sample_f return (f or delta weight)


def _gather(table: BSDFTable, bsdf_id):
    """Per-lane material parameters (clipped gather; id<0 lanes are masked
    by callers)."""
    i = jnp.clip(bsdf_id, 0, table.kind.shape[0] - 1)
    return jax.tree_util.tree_map(lambda a: a[i], table)


def emission(table: BSDFTable, bsdf_id):
    """get_emission(): radiance for EmissionBSDF, black otherwise."""
    m = _gather(table, bsdf_id)
    is_em = (m.kind == BSDF_EMISSION) & (bsdf_id >= 0)
    return jnp.where(is_em[..., None], m.emission, 0.0)


def is_delta(table: BSDFTable, bsdf_id):
    m = _gather(table, bsdf_id)
    return m.is_delta() & (bsdf_id >= 0)


# ------------------------------------------------------------- microfacet

def _safe_alpha(alpha):
    """Non-microfacet rows carry alpha=0; clamp for NaN-free lanes (their
    results are kind-masked out anyway)."""
    return jnp.maximum(alpha, 1e-4)


def _mf_lambda(w, alpha):
    """Smith Λ with the reference's erf form (bsdf.h:169-173), including
    its θ clamp via acos(clamp(z, ±(1−1e-5)))."""
    z = jnp.clip(w[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    theta = jnp.arccos(z)
    tan_t = jnp.clip(jnp.tan(theta), 1e-6, 1e6)
    a = 1.0 / (_safe_alpha(alpha) * tan_t)
    return 0.5 * (jax.lax.erf(a) - 1.0 + jnp.exp(-a * a) / (a * PI))


def _mf_G(wo, wi, alpha):
    return 1.0 / (1.0 + _mf_lambda(wi, alpha) + _mf_lambda(wo, alpha))


def _mf_D(h, alpha):
    z = jnp.clip(h[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    theta = jnp.arccos(z)
    tan_t = jnp.tan(theta)
    cos2 = jnp.maximum(h[..., 2] * h[..., 2], 1e-12)
    a2 = _safe_alpha(alpha) ** 2
    return jnp.exp(-tan_t * tan_t / a2) / (PI * a2 * cos2 * cos2)


def _mf_F(wi, eta, k):
    """Air→conductor Fresnel via the Rs/Rp approximation (bsdf.cpp:58-66).

    The branchless dispatch evaluates this for EVERY lane with the lane's
    own table row, including non-microfacet rows whose eta = k = 0: at a
    grazing wi (ci → 0) rs becomes 0/0 and, although the forward value is
    selected away, reverse-mode's 0·NaN poisons the summed eta/k table
    gradients. Guard the denominators — they vanish only in that
    selected-away configuration, so the substitution never changes a
    consumed value."""
    e2k2 = eta * eta + k * k
    ci = wi[..., 2:3]
    ci2 = ci * ci
    two_eta_ci = 2.0 * eta * ci
    den_s = e2k2 + two_eta_ci + ci2
    den_p = e2k2 * ci2 + two_eta_ci + 1.0
    safe = lambda d: jnp.where(jnp.abs(d) < 1e-12, 1.0, d)
    rs = (e2k2 - two_eta_ci + ci2) / safe(den_s)
    rp = (e2k2 * ci2 - two_eta_ci + 1.0) / safe(den_p)
    return (rs + rp) / 2.0


def _mf_f(wo, wi, eta, k, alpha):
    ok = (wo[..., 2] > 0) & (wi[..., 2] > 0)
    # sanitize masked lanes BEFORE the math: where() does not stop NaN
    # cotangents from the untaken branch
    up = jnp.zeros_like(wo).at[..., 2].set(1.0)
    wo = jnp.where(ok[..., None], wo, up)
    wi = jnp.where(ok[..., None], wi, up)
    hsum = wo + wi
    n2 = jnp.sum(hsum * hsum, axis=-1, keepdims=True)
    h = hsum / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0))
    val = (
        _mf_F(wi, eta, k)
        * (_mf_G(wo, wi, alpha) * _mf_D(h, alpha))[..., None]
        / (4.0 * wo[..., 2:3] * wi[..., 2:3])
    )
    return jnp.where(ok[..., None], val, 0.0)


# ------------------------------------------------------------- public API

def evaluate(table: BSDFTable, bsdf_id, wo, wi):
    """f(wo, wi): nonzero only for diffuse and microfacet."""
    m = _gather(table, bsdf_id)
    f_diff = m.reflectance / PI
    f_mf = _mf_f(wo, wi, m.eta, m.k, m.alpha)
    out = jnp.where((m.kind == BSDF_DIFFUSE)[..., None], f_diff, 0.0)
    out = jnp.where((m.kind == BSDF_MICROFACET)[..., None], f_mf, out)
    return jnp.where((bsdf_id >= 0)[..., None], out, 0.0)


def _reflect(wo):
    return jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)


def _refract(wo, ior):
    """Snell w/ TIR detection (bsdf.cpp:146-159). Returns (ok, wi).

    Non-glass table rows carry ior=0; 1/ior would be inf forward and
    NaN·0 in reverse even though the glass branch is kind-masked — clamp
    (results for those rows are masked out anyway)."""
    ior = jnp.where(ior > 0, ior, 1.0)
    eta = jnp.where(wo[..., 2] > 0, 1.0 / ior, ior)
    wi_z2 = 1.0 - eta * eta * (1.0 - wo[..., 2] * wo[..., 2])
    ok = wi_z2 >= 0
    # safe sqrt for AD; d√x → ∞ at the TIR boundary (x → 0⁺) poisons
    # reverse mode even under zero cotangents — near-critical refraction
    # takes the exact-critical limit z = 0
    pos = wi_z2 > 1e-12
    z = jnp.where(pos, jnp.sqrt(jnp.where(pos, wi_z2, 1.0)), 0.0)
    z = jnp.where(wo[..., 2] > 0, -z, z)
    wi = jnp.stack([-eta * wo[..., 0], -eta * wo[..., 1], z], axis=-1)
    return ok, wi


def sample(table: BSDFTable, bsdf_id, wo, key,
           microfacet_hemi: bool = False) -> BSDFSample:
    """sample_f(wo) for every lane; all models computed, kind-selected.

    `microfacet_hemi=True` reproduces the reference's MICROFACET_HEMI==1
    compile switch (bsdf.h:4): the microfacet lobe falls back to
    cosine-hemisphere sampling (the docs' importance-vs-uniform noise
    comparison mode) instead of Beckmann half-vector importance sampling.
    """
    m = _gather(table, bsdf_id)
    shape = bsdf_id.shape
    k1, k2, k3 = jax.random.split(key, 3)
    xi = jax.random.uniform(k1, shape + (2,), wo.dtype)
    xi1, xi2 = xi[..., 0], xi[..., 1]

    # --- diffuse / emission share the cosine-weighted sampler
    r = jnp.sqrt(xi1)
    th = 2.0 * PI * xi2
    cos_z = jnp.sqrt(1.0 - xi1)
    wi_cos = jnp.stack([r * jnp.cos(th), r * jnp.sin(th), cos_z], axis=-1)
    pdf_cos = cos_z / PI
    val_diff = m.reflectance / PI

    # --- mirror
    wi_mir = _reflect(wo)
    val_mir = m.reflectance / jnp.maximum(jnp.abs(wi_mir[..., 2:3]), 1e-12)

    # --- microfacet: Beckmann half-vector importance sampling
    xim = jax.random.uniform(k2, shape + (2,), wo.dtype)
    a2 = _safe_alpha(m.alpha) ** 2
    theta_h = jnp.arctan(jnp.sqrt(-a2 * jnp.log1p(-xim[..., 0])))
    phi_h = 2.0 * PI * xim[..., 1]
    sin_h, cos_h = jnp.sin(theta_h), jnp.cos(theta_h)
    tan_h = jnp.tan(theta_h)
    p_theta = (2.0 * sin_h * jnp.exp(-tan_h * tan_h / a2)
               / (a2 * cos_h * cos_h * cos_h))
    p_phi = 0.5 / PI
    h = jnp.stack(
        [sin_h * jnp.cos(phi_h), sin_h * jnp.sin(phi_h), cos_h], axis=-1)
    wi_mf = 2.0 * jnp.sum(wo * h, axis=-1, keepdims=True) * h - wo
    below = wi_mf[..., 2] <= 0
    mf_denom = sin_h * 4.0 * jnp.sum(wi_mf * h, axis=-1)
    pdf_mf = p_theta * p_phi / jnp.where(
        jnp.abs(mf_denom) > 1e-12, mf_denom, 1.0)
    pdf_mf = jnp.where(below | (jnp.abs(mf_denom) <= 1e-12), 0.0, pdf_mf)
    val_mf = jnp.where(below[..., None], 0.0,
                       _mf_f(wo, wi_mf, m.eta, m.k, m.alpha))

    # --- glass
    can_refract, wi_refr = _refract(wo, m.ior)
    ior_g = jnp.where(m.ior > 0, m.ior, 1.0)   # see _refract note
    r0 = ((1.0 - ior_g) / (1.0 + ior_g)) ** 2
    tt = 1.0 - jnp.abs(wi_refr[..., 2])
    schlick = r0 + (1.0 - r0) * tt * tt * tt * tt * tt
    coin = jax.random.uniform(k3, shape, wo.dtype) < schlick
    eta_g = jnp.where(wo[..., 2] > 0, 1.0 / ior_g, ior_g)
    # TIR → pure mirror; else coin: reflect vs refract
    use_reflect = ~can_refract | coin
    wi_glass = jnp.where(use_reflect[..., None], _reflect(wo), wi_refr)
    pdf_glass = jnp.where(
        ~can_refract, 1.0, jnp.where(coin, schlick, 1.0 - schlick))
    w_refl = jnp.where(~can_refract, 1.0, schlick)[..., None] * m.reflectance
    abs_z = jnp.maximum(jnp.abs(wi_glass[..., 2:3]), 1e-12)
    val_glass = jnp.where(
        use_reflect[..., None],
        w_refl / abs_z,
        ((1.0 - schlick) / (abs_z[..., 0] * eta_g * eta_g))[..., None]
        * m.transmittance,
    )

    if microfacet_hemi:
        # MICROFACET_HEMI==1: cosine-hemisphere proposals, f evaluated
        wi_mf = wi_cos
        pdf_mf = pdf_cos
        val_mf = _mf_f(wo, wi_cos, m.eta, m.k, m.alpha)

    # --- select by kind
    kind = m.kind
    wi = jnp.where((kind == BSDF_MIRROR)[..., None], wi_mir, wi_cos)
    wi = jnp.where((kind == BSDF_MICROFACET)[..., None], wi_mf, wi)
    wi = jnp.where((kind == BSDF_GLASS)[..., None], wi_glass, wi)

    pdf = jnp.where(kind == BSDF_MIRROR, 1.0, pdf_cos)
    pdf = jnp.where(kind == BSDF_MICROFACET, pdf_mf, pdf)
    pdf = jnp.where(kind == BSDF_GLASS, pdf_glass, pdf)
    pdf = jnp.where(kind == BSDF_REFRACTION, 0.0, pdf)

    val = jnp.where((kind == BSDF_DIFFUSE)[..., None], val_diff, 0.0)
    val = jnp.where((kind == BSDF_MIRROR)[..., None], val_mir, val)
    val = jnp.where((kind == BSDF_MICROFACET)[..., None], val_mf, val)
    val = jnp.where((kind == BSDF_GLASS)[..., None], val_glass, val)
    # refraction stub and emission scatter nothing

    bad = bsdf_id < 0
    pdf = jnp.where(bad, 0.0, pdf)
    val = jnp.where(bad[..., None], 0.0, val)
    return BSDFSample(wi=wi, pdf=pdf, value=val)
