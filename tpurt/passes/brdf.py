"""PBR BRDF library — vectorized jnp forms of every formula the reference
ships (reference: src/vk_renderer/shaders/brdfs.glsl:6-101).

All functions are elementwise over arbitrary leading batch axes; color inputs
carry a trailing axis of 3. Everything here fuses into the shading pass under
jit — there is no per-pixel dispatch, the whole image is one fused program.
"""
from __future__ import annotations

import jax.numpy as jnp

PI = 3.14159265359
MEDIUMP_FLT_MAX = 65504.0


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def d_ggx(roughness, NdotH):
    """Walter et al. 2007 GGX NDF (brdfs.glsl:6-14)."""
    one_minus_noh2 = 1.0 - NdotH * NdotH
    a = NdotH * roughness
    k = roughness / (one_minus_noh2 + a * a)
    return k * k * (1.0 / PI)


def v_smith_ggx_correlated(roughness, NdotV, NdotL):
    """Heitz 2014 height-correlated Smith visibility (brdfs.glsl:16-23)."""
    a2 = roughness * roughness
    lambda_v = NdotL * jnp.sqrt((NdotV - a2 * NdotV) * NdotV + a2)
    lambda_l = NdotV * jnp.sqrt((NdotL - a2 * NdotL) * NdotL + a2)
    return 0.5 / (lambda_v + lambda_l)


def v_smith_ggx_correlated_fast(roughness, NdotV, NdotL):
    """Hammon 2017 approximation (brdfs.glsl:25-29) — the one the reference's
    specular term actually uses (brdfs.glsl:46)."""
    return 0.5 / _mix(2.0 * NdotL * NdotV, NdotL + NdotV, roughness)


def _mix(a, b, t):
    return a + (b - a) * t


def f_schlick(F0, HdotV, F90=1.0):
    """Schlick Fresnel (brdfs.glsl:31-42). F0 may be scalar or (..., 3)."""
    HdotV = jnp.asarray(HdotV)
    if jnp.ndim(F0) > jnp.ndim(HdotV):
        HdotV = HdotV[..., None]
    return F0 + (F90 - F0) * jnp.power(1.0 - HdotV, 5.0)


def cook_torrance_specular(NdotL, NdotV, NdotH, roughness, F):
    """(D * G_fast) * F (brdfs.glsl:44-49). F is (..., 3)."""
    D = d_ggx(roughness, NdotH)
    G = v_smith_ggx_correlated_fast(roughness, NdotV, NdotL)
    return (D * G)[..., None] * F


def oren_nayar_diffuse(LdotV, NdotL, NdotV, roughness, Kd):
    """brdfs.glsl:70-79. Kd is (..., 3)."""
    s = LdotV - NdotL * NdotV
    t = _mix(jnp.ones_like(s), jnp.maximum(NdotL, NdotV), jnp.where(s >= 0.0, 1.0, 0.0))
    sigma2 = roughness * roughness
    A = 1.0 + sigma2[..., None] * (Kd / (sigma2[..., None] + 0.13)
                                   + 0.5 / (sigma2[..., None] + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    return NdotL[..., None] * (A + (B * s / t)[..., None]) / PI


def burley_diffuse(roughness, NdotV, NdotL, LdotH):
    """Burley 2012 (brdfs.glsl:81-87)."""
    f90 = 0.5 + 2.0 * roughness * LdotH * LdotH
    light_scatter = f_schlick(1.0, NdotL, f90)
    view_scatter = f_schlick(1.0, NdotV, f90)
    return light_scatter * view_scatter * (1.0 / PI)


def burley_diffuse_local_sss(roughness, NdotV, nc_NdotV, nc_NdotL, LdotH,
                             local_sss_diffuse_ratio):
    """Burley diffuse with a local subsurface-scattering term
    (brdfs.glsl:89-99) — the diffuse lobe used per light in the primary
    shading loop (raytrace.rgen.glsl:162, ratio 0.4)."""
    F_SS90 = roughness * LdotH * LdotH
    F_SS = f_schlick(1.0, nc_NdotL, F_SS90) * f_schlick(1.0, nc_NdotV, F_SS90)
    f_ss = (1.0 / (nc_NdotV * nc_NdotL) - 0.5) * F_SS + 0.5
    local_sss = 1.25 * local_sss_diffuse_ratio * f_ss

    f90 = 0.5 + 2.0 * F_SS90
    diffuse = ((1.0 - local_sss_diffuse_ratio)
               * f_schlick(1.0, nc_NdotL, f90) * f_schlick(1.0, nc_NdotV, f90))
    return NdotV * (diffuse + local_sss) * (1.0 / PI)


def lambertian_diffuse():
    """brdfs.glsl:101."""
    return 1.0 / PI
