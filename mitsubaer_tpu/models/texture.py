"""Texture evaluation (reference src/textures/*.cpp + mipmap.h).

Textures modulate BSDF reflectance per hit point: integrators look up
`scene.bsdfs.texture[b_idx]` and multiply the result into the reflectance via
the `refl_scale` argument of models/bsdf.py. Procedural textures
(checkerboard.cpp, gridtexture.cpp, wireframe.cpp) are pure elementwise arithmetic;
bitmap.cpp becomes a bilinear row-gather into the scene's shared image
(MIP mapping omitted: renders supersample instead of prefiltering).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import smalltab
from ..scene.types import (
    TEX_BITMAP,
    TEX_BUMPMAP,
    TEX_CHECKERBOARD,
    TEX_GRIDTEXTURE,
    TEX_NORMALMAP,
    TEX_SCALE,
    TEX_WIREFRAME,
    Textures,
)


def eval_texture(tex: Textures, tex_idx, uv, bary=None):
    """RGB texture value at uv for per-lane texture ids (N,).

    tex_idx = -1 -> 1.0 (no modulation). `bary` (N,2) optionally carries the
    raw barycentrics for wireframe.cpp edge distance."""
    nt = tex.kind.shape[0]
    i = jnp.clip(tex_idx, 0, nt - 1)
    kind = jnp.where(tex_idx >= 0, smalltab.take(tex.kind, i), -1)
    c0 = smalltab.take(tex.color0, i)
    c1 = smalltab.take(tex.color1, i)
    scale = smalltab.take(tex.uv_scale, i)
    offset = smalltab.take(tex.uv_offset, i)
    lw = smalltab.take(tex.line_width, i)
    use_bm = smalltab.take(tex.use_bitmap, i)

    st = uv * scale + offset

    # checkerboard.cpp: alternate color0/color1 on integer cells
    cell = jnp.floor(st).astype(jnp.int32)
    check = ((cell[..., 0] + cell[..., 1]) % 2) == 0
    v_check = jnp.where(check[..., None], c0, c1)

    # gridtexture.cpp: lines of width lw at integer coordinates
    f = st - jnp.floor(st)
    on_line = (jnp.minimum(f[..., 0], 1.0 - f[..., 0]) < lw) | (
        jnp.minimum(f[..., 1], 1.0 - f[..., 1]) < lw)
    v_grid = jnp.where(on_line[..., None], c1, c0)

    # wireframe.cpp: distance to triangle edge in barycentric space
    if bary is None:
        bary = uv
    b0 = bary[..., 0]
    b1 = bary[..., 1]
    edge = jnp.minimum(jnp.minimum(b0, b1), jnp.maximum(1.0 - b0 - b1, 0.0))
    v_wire = jnp.where((edge < lw)[..., None], c1, c0)

    # bitmap.cpp: bilinear lookup, repeat wrapping
    Hb, Wb = tex.bitmap.shape[:2]
    img = tex.bitmap.reshape(-1, 3)
    x = (st[..., 0] % 1.0) * Wb - 0.5
    y = (st[..., 1] % 1.0) * Hb - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = x0 % Wb
    xi1 = (x0 + 1) % Wb
    yi0 = y0 % Hb
    yi1 = (y0 + 1) % Hb
    p00 = jnp.take(img, yi0 * Wb + xi0, axis=0)
    p10 = jnp.take(img, yi0 * Wb + xi1, axis=0)
    p01 = jnp.take(img, yi1 * Wb + xi0, axis=0)
    p11 = jnp.take(img, yi1 * Wb + xi1, axis=0)
    v_bitmap = ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
                + (p01 * (1 - fx) + p11 * fx) * fy)
    # scale.cpp folded: color0 * bitmap
    v_bitmap = jnp.where(use_bm[..., None], v_bitmap * jnp.where(
        (kind == TEX_SCALE)[..., None], c0, 1.0), v_bitmap)

    out = jnp.ones_like(c0)
    from ..core import noise as noise_m
    from ..scene.types import TEX_NOISE

    pn = jnp.stack([st[..., 0] * 8.0, st[..., 1] * 8.0,
                    jnp.zeros_like(st[..., 0])], axis=-1)
    tnoise = 0.5 * (noise_m.fbm(pn, octaves=4) + 1.0)[..., None]
    v_noise = c0 * (1.0 - tnoise) + c1 * tnoise
    out = jnp.where((kind == TEX_NOISE)[..., None], v_noise, out)
    out = jnp.where((kind == TEX_CHECKERBOARD)[..., None], v_check, out)
    out = jnp.where((kind == TEX_GRIDTEXTURE)[..., None], v_grid, out)
    out = jnp.where((kind == TEX_WIREFRAME)[..., None], v_wire, out)
    out = jnp.where(((kind == TEX_BITMAP) | (kind == TEX_SCALE))[..., None],
                    v_bitmap, out)
    return out


def _bitmap_bilinear(tex: Textures, i, st):
    Hb, Wb = tex.bitmap.shape[:2]
    img = tex.bitmap.reshape(-1, 3)
    x = (st[..., 0] % 1.0) * Wb - 0.5
    y = (st[..., 1] % 1.0) * Hb - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    p00 = jnp.take(img, (y0 % Hb) * Wb + x0 % Wb, axis=0)
    p10 = jnp.take(img, (y0 % Hb) * Wb + (x0 + 1) % Wb, axis=0)
    p01 = jnp.take(img, ((y0 + 1) % Hb) * Wb + x0 % Wb, axis=0)
    p11 = jnp.take(img, ((y0 + 1) % Hb) * Wb + (x0 + 1) % Wb, axis=0)
    return ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
            + (p01 * (1 - fx) + p11 * fx) * fy)


def shading_normal(scene, b_idx, uv, enabled=True):
    """Tangent-space shading normal from the BSDF's normal_tex row
    (normalmap.cpp: n = 2*rgb - 1; bumpmap.cpp: n from the height-field uv
    gradient, strength = color0[0]). Returns (N, 3) unit local normals or
    None when the scene carries no perturbation (static gate)."""
    bs = scene.bsdfs
    if not enabled or getattr(bs, "normal_tex", None) is None:
        return None
    tex = scene.textures
    nb = bs.kind.shape[0]
    bi = jnp.clip(b_idx, 0, nb - 1)
    t_idx = jnp.where(b_idx >= 0, smalltab.take(bs.normal_tex, bi), -1)
    nt = tex.kind.shape[0]
    i = jnp.clip(t_idx, 0, nt - 1)
    kind = jnp.where(t_idx >= 0, smalltab.take(tex.kind, i), -1)
    scale = smalltab.take(tex.uv_scale, i)
    offset = smalltab.take(tex.uv_offset, i)
    strength = smalltab.take(tex.color0, i)[..., 0]
    st = uv * scale + offset

    rgb = _bitmap_bilinear(tex, i, st)
    n_nm = rgb * 2.0 - 1.0

    # bumpmap: central-difference height gradient in texel units
    Hb, Wb = tex.bitmap.shape[:2]
    du = jnp.stack([jnp.full(st.shape[:-1], 1.0 / Wb),
                    jnp.zeros(st.shape[:-1])], axis=-1)
    dv = jnp.stack([jnp.zeros(st.shape[:-1]),
                    jnp.full(st.shape[:-1], 1.0 / Hb)], axis=-1)
    h = lambda s: jnp.mean(_bitmap_bilinear(tex, i, s), axis=-1)
    dhdu = (h(st + du) - h(st - du)) * (0.5 * Wb)
    dhdv = (h(st + dv) - h(st - dv)) * (0.5 * Hb)
    n_bm = jnp.stack([-strength * dhdu, -strength * dhdv,
                      jnp.ones_like(dhdu)], axis=-1)

    n_loc = jnp.where((kind == TEX_BUMPMAP)[..., None], n_bm,
                      jnp.where((kind == TEX_NORMALMAP)[..., None], n_nm,
                                jnp.array([0.0, 0.0, 1.0])))
    n_loc = n_loc / jnp.maximum(
        jnp.linalg.norm(n_loc, axis=-1, keepdims=True), 1e-6)
    # keep the perturbed normal in the upper hemisphere of the frame
    flip = n_loc[..., 2] < 1e-3
    return jnp.where(flip[..., None], jnp.array([0.0, 0.0, 1.0]), n_loc)


def uv_tangent_frame(scene, hit):
    """UV-aligned shading frame at triangle hits (trimesh.cpp tangent
    computation): dp/du from the edge/uv-edge system, orthonormalized
    against the geometric normal. Falls back to the arbitrary
    Frame.from_normal basis on spheres / degenerate uv charts."""
    from ..core.math import Frame, coordinate_system, dot, normalize

    geo = scene.geo
    nt = geo.v0.shape[0]
    is_tri = hit.prim < (1 << 30)
    ti = jnp.clip(jnp.where(is_tri, hit.prim, 0), 0, nt - 1)
    e1 = jnp.take(geo.e1, ti, axis=0)
    e2 = jnp.take(geo.e2, ti, axis=0)
    u1 = jnp.take(geo.uve1, ti, axis=0)
    u2 = jnp.take(geo.uve2, ti, axis=0)
    det = u1[..., 0] * u2[..., 1] - u2[..., 0] * u1[..., 1]
    ok = is_tri & (jnp.abs(det) > 1e-12)
    inv = 1.0 / jnp.where(ok, det, 1.0)
    dpdu = (u2[..., 1:2] * e1 - u1[..., 1:2] * e2) * inv[..., None]
    n = hit.ng
    t = dpdu - dot(dpdu, n, keepdims=True) * n
    tlen = jnp.linalg.norm(t, axis=-1, keepdims=True)
    ok = ok & (tlen[..., 0] > 1e-9)
    t = t / jnp.maximum(tlen, 1e-12)
    s0, t0 = coordinate_system(n)
    s_ax = jnp.where(ok[..., None], t, s0)
    t_ax = jnp.where(ok[..., None], jnp.cross(n, t), t0)
    return Frame(s_ax, t_ax, n)


def bsdf_refl_scale(scene, b_idx, uv, bary=None, enabled=True):
    """Texture multiplier for a batch of surface hits; `enabled` is a static
    flag (RenderConfig.has_textures) so untextured scenes compile none of
    this."""
    if not enabled:
        return None
    nb = scene.bsdfs.kind.shape[0]
    bi = jnp.clip(b_idx, 0, nb - 1)
    t_idx = jnp.where(b_idx >= 0, smalltab.take(scene.bsdfs.texture, bi), -1)
    return eval_texture(scene.textures, t_idx, uv, bary)
