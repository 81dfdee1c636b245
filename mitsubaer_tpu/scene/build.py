"""Host-side scene construction: accumulates shapes/BSDFs/emitters/media in
numpy, then freezes into the flat device pytree (scene/types.py).

Replaces the reference's SceneHandler plugin instantiation + Scene::configure
wiring (librender/scenehandler.cpp, scene.cpp) with an explicit builder; the
XML front end (scene/xml.py) drives this same API.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..core import spline
from . import types as T

# triangle count above which scene build attaches a flattened BVH
_BVH_MIN_TRIS = 512


@dataclass
class _BSDF:
    kind: int = T.BSDF_DIFFUSE
    reflectance: tuple = (0.5, 0.5, 0.5)
    specular_r: tuple = (1.0, 1.0, 1.0)
    specular_t: tuple = (1.0, 1.0, 1.0)
    eta: float = 1.5046
    cond_eta: tuple = (0.0, 0.0, 0.0)
    cond_k: tuple = (1.0, 1.0, 1.0)
    alpha: float = 0.1
    exponent: float = 30.0
    alpha_v: float = 0.1
    opacity: float = 1.0
    texture: int = -1
    twosided: bool = False
    child0: int = -1
    child1: int = -1
    mix_w: float = 0.5
    normal_tex: int = -1


@dataclass
class _Emitter:
    kind: int = T.EM_AREA
    radiance: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    shape_id: int = -1
    cutoff_deg: float = 20.0
    beam_width_deg: float = 15.0
    envmap: Optional[np.ndarray] = None  # (He, We, 3) lat-long radiance
    to_world: Optional[np.ndarray] = None
    scale: float = 1.0


@dataclass
class _Texture:
    kind: int = T.TEX_CHECKERBOARD
    color0: tuple = (0.4, 0.4, 0.4)
    color1: tuple = (0.2, 0.2, 0.2)
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    line_width: float = 0.01
    bitmap: Optional[np.ndarray] = None  # (Hb, Wb, 3)


@dataclass
class _Medium:
    kind: int = T.MED_HOMOGENEOUS
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: tuple = (0.0, 0.0, 0.0)
    sampling_weight: float = -1.0
    strategy: int = T.STRAT_BALANCE
    manual_density: float = 1.0
    phase_kind: int = T.PH_ISOTROPIC
    g: float = 0.0
    g2: float = 0.0
    phase_mix: float = 1.0
    kappa: float = 4.0
    fiber_axis: tuple = (0.0, 0.0, 1.0)
    scale: float = 1.0
    # heterogeneous
    density: Optional[np.ndarray] = None       # (nz, ny, nx)
    density_aabb: Optional[tuple] = None
    albedo_grid: Optional[np.ndarray] = None   # (nz, ny, nx, 3)
    orientation: Optional[np.ndarray] = None   # (nz, ny, nx, 3) local axes
    # refractive
    rif_kind: int = 0                          # eikonal.RIF_* (0 = const)
    rif_params: tuple = (1.0, 0, 0, 0, 0, 0, 0, 0)
    rif: Optional[np.ndarray] = None           # (nz, ny, nx) samples (spline)
    rif_aabb: Optional[tuple] = None
    sdf_kind: int = 0                          # eikonal.SDF_*
    sdf_params: tuple = (0,) * 8
    sdf: Optional[np.ndarray] = None
    sdf_aabb: Optional[tuple] = None


class SceneBuilder:
    def __init__(self):
        self._verts = []       # list of (V,3)
        self._faces = []       # list of (F,3) with vertex offset applied
        self._face_shape = []  # list of shape ids per face array
        self._spheres = []     # (center, radius, shape_id)
        self._shapes = []      # dicts: bsdf, emitter, interior, exterior
        self._bsdfs: list[_BSDF] = []
        self._emitters: list[_Emitter] = []
        self._textures: list[_Texture] = []
        self._mesh_uvs = []    # per-mesh (V,2) uv arrays or None
        self._media: list[_Medium] = []
        self._sensor = None
        self.config = T.RenderConfig()
        self.camera_medium = -1

    # -- materials ---------------------------------------------------------
    def add_bsdf(self, kind=T.BSDF_DIFFUSE, **kw) -> int:
        self._bsdfs.append(_BSDF(kind=kind, **kw))
        return len(self._bsdfs) - 1

    def add_medium(self, **kw) -> int:
        self._media.append(_Medium(**kw))
        return len(self._media) - 1

    def add_emitter(self, kind, **kw) -> int:
        self._emitters.append(_Emitter(kind=kind, **kw))
        return len(self._emitters) - 1

    def add_texture(self, kind=T.TEX_CHECKERBOARD, **kw) -> int:
        """Register a texture (reference src/textures/*.cpp); returns its id
        for _BSDF.texture."""
        self._textures.append(_Texture(kind=kind, **kw))
        return len(self._textures) - 1

    # -- shapes ------------------------------------------------------------
    def add_mesh(self, verts, faces, bsdf=-1, emitter_radiance=None,
                 interior=-1, exterior=-1, to_world=None, uv=None) -> int:
        verts = np.asarray(verts, np.float32)
        if to_world is not None:
            m = np.asarray(to_world, np.float32)
            verts = verts @ m[:3, :3].T + m[:3, 3]
        shape_id = len(self._shapes)
        emitter = -1
        if emitter_radiance is not None:
            emitter = len(self._emitters)
            self._emitters.append(
                _Emitter(kind=T.EM_AREA, radiance=tuple(np.asarray(emitter_radiance, np.float64)), shape_id=shape_id)
            )
        self._shapes.append(dict(bsdf=bsdf, emitter=emitter, interior=interior, exterior=exterior))
        self._verts.append(verts)
        self._faces.append(np.asarray(faces, np.int32))
        self._face_shape.append(shape_id)
        self._mesh_uvs.append(None if uv is None else np.asarray(uv, np.float32))
        return shape_id

    def add_sphere(self, center, radius, bsdf=-1, emitter_radiance=None,
                   interior=-1, exterior=-1) -> int:
        shape_id = len(self._shapes)
        emitter = -1
        if emitter_radiance is not None:
            emitter = len(self._emitters)
            self._emitters.append(
                _Emitter(kind=T.EM_AREA, radiance=tuple(emitter_radiance), shape_id=shape_id)
            )
        self._shapes.append(dict(bsdf=bsdf, emitter=emitter, interior=interior, exterior=exterior))
        self._spheres.append((np.asarray(center, np.float32), float(radius), shape_id))
        return shape_id

    def add_rectangle(self, to_world, **kw) -> int:
        """Unit rectangle [-1,1]^2 in the XY plane (shapes/rectangle.cpp)."""
        v = np.array(
            [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
        )
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def add_disk(self, to_world, segments: int = 64, **kw) -> int:
        """Unit disk in the XY plane (shapes/disk.cpp), tessellated."""
        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
        v = np.concatenate([[[0.0, 0.0, 0.0]], rim]).astype(np.float32)
        f = np.stack([np.zeros(segments, np.int32),
                      np.arange(1, segments + 1, dtype=np.int32),
                      np.roll(np.arange(1, segments + 1, dtype=np.int32), -1)],
                     -1)
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def add_cylinder(self, p0, p1, radius, segments: int = 64, **kw) -> int:
        """Open cylinder between p0 and p1 (shapes/cylinder.cpp)."""
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        axis = p1 - p0
        ln = np.linalg.norm(axis)
        w = axis / max(ln, 1e-9)
        # orthonormal frame
        a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(w, a)
        u /= np.linalg.norm(u)
        vv = np.cross(w, u)
        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ring = (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * vv) * radius
        verts = np.concatenate([p0 + ring, p1 + ring]).astype(np.float32)
        f = []
        for i in range(segments):
            j = (i + 1) % segments
            f += [[i, j, segments + j], [i, segments + j, segments + i]]
        return self.add_mesh(verts, np.asarray(f, np.int32), **kw)

    def add_heightfield(self, heights, to_world=None, uv_tile=(1.0, 1.0),
                        **kw) -> int:
        """Displaced grid over [-1,1]^2 in XY with z = heights (Hh, Wh)
        (shapes/heightfield.cpp — the reference ray-marches the implicit
        field; a tessellated grid is the wavefront-friendly equivalent and
        feeds the same BVH as any mesh)."""
        h = np.asarray(heights, np.float32)
        Hh, Wh = h.shape
        ys = np.linspace(-1.0, 1.0, Hh, dtype=np.float32)
        xs = np.linspace(-1.0, 1.0, Wh, dtype=np.float32)
        X, Y = np.meshgrid(xs, ys)
        verts = np.stack([X, Y, h], axis=-1).reshape(-1, 3)
        i = np.arange(Hh - 1)[:, None] * Wh + np.arange(Wh - 1)[None, :]
        i = i.reshape(-1)
        faces = np.concatenate([
            np.stack([i, i + 1, i + Wh + 1], axis=-1),
            np.stack([i, i + Wh + 1, i + Wh], axis=-1),
        ]).astype(np.int32)
        u = (X + 1) * 0.5 * uv_tile[0]
        v = (Y + 1) * 0.5 * uv_tile[1]
        uv = np.stack([u, v], axis=-1).reshape(-1, 2)
        return self.add_mesh(verts, faces, to_world=to_world, uv=uv, **kw)

    def add_instances(self, verts, faces, to_worlds, **kw) -> list:
        """Instanced mesh (shapes/instance.cpp + shapegroup.cpp): one
        prototype replicated under per-instance transforms. The reference
        nests a second kd-tree per shapegroup (two-level hierarchy); here
        instances flatten into the global buffer — the single-level BVH
        over the flattened soup is the accelerator-friendly trade (no per-lane
        transform indirection in the traversal inner loop) at the cost of
        duplicated vertex storage. Returns the per-instance shape ids."""
        return [self.add_mesh(verts, faces, to_world=m, **kw)
                for m in to_worlds]

    def add_cube(self, to_world, **kw) -> int:
        """Unit cube [-1,1]^3 (shapes/cube.cpp), outward normals."""
        v = np.array(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ],
            np.float32,
        )
        f = np.array(
            [
                [0, 2, 1], [0, 3, 2],  # z = -1
                [4, 5, 6], [4, 6, 7],  # z = +1
                [0, 1, 5], [0, 5, 4],  # y = -1
                [3, 6, 2], [3, 7, 6],  # y = +1
                [0, 4, 7], [0, 7, 3],  # x = -1
                [1, 2, 6], [1, 6, 5],  # x = +1
            ],
            np.int32,
        )
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def set_perspective_sensor(self, to_world, fov_deg, fov_axis="x",
                               near=1e-2, far=1e4, width=None, height=None,
                               kind=T.SENSOR_PERSPECTIVE, aperture=0.0,
                               focus=1.0):
        self._sensor = dict(
            to_world=np.asarray(to_world, np.float32),
            fov_deg=float(fov_deg), fov_axis=fov_axis, near=near, far=far,
            kind=kind, aperture=float(aperture), focus=float(focus),
        )
        if width:
            self.config = self.config._replace(width=width)
        if height:
            self.config = self.config._replace(height=height)

    def set_sensor(self, kind, to_world, **kw):
        """General sensor config (thinlens/orthographic/spherical/
        radiancemeter; reference src/sensors/*.cpp)."""
        self.set_perspective_sensor(to_world, kw.pop("fov_deg", 45.0),
                                    kind=kind, **kw)

    # -- freeze ------------------------------------------------------------
    def build(self) -> T.Scene:
        # geometry
        if self._verts:
            tri_v, tri_s, tri_uv = [], [], []
            for verts, faces, sid, uv in zip(self._verts, self._faces,
                                             self._face_shape, self._mesh_uvs):
                tri = verts[faces]  # (F, 3, 3)
                tri_v.append(tri)
                tri_s.append(np.full(len(faces), sid, np.int32))
                if uv is None:
                    # default: barycentric uv per face (u,v of MT intersection)
                    base = np.zeros((len(faces), 3, 2), np.float32)
                    base[:, 1, 0] = 1.0
                    base[:, 2, 1] = 1.0
                    tri_uv.append(base)
                else:
                    tri_uv.append(uv[faces])
            tri = np.concatenate(tri_v, axis=0)
            tri_shape = np.concatenate(tri_s, axis=0)
            tri_uvs = np.concatenate(tri_uv, axis=0)  # (F, 3, 2)
        else:
            tri = np.zeros((1, 3, 3), np.float32)
            tri_shape = np.full((1,), -1, np.int32)
            tri_uvs = np.zeros((1, 3, 2), np.float32)
        v0 = tri[:, 0]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        ngu = np.cross(e1, e2)
        areas2 = np.linalg.norm(ngu, axis=-1)
        ng = ngu / np.maximum(areas2, 1e-20)[:, None]

        if self._spheres:
            sc = np.stack([s[0] for s in self._spheres])
            sr = np.array([s[1] for s in self._spheres], np.float32)
            ss = np.array([s[2] for s in self._spheres], np.int32)
        else:
            sc = np.zeros((1, 3), np.float32)
            sr = np.zeros((1,), np.float32)
            ss = np.full((1,), -1, np.int32)

        # big meshes get a flattened BVH (reference skdtree.h analogue);
        # small scenes stay on the brute-force unrolled/chunked intersector
        tree = None
        if v0.shape[0] >= _BVH_MIN_TRIS:
            from . import bvh as bvh_m

            tree = bvh_m.build_bvh(v0, e1, e2)
        geo = T.Geometry(
            v0=jnp.asarray(v0), e1=jnp.asarray(e1), e2=jnp.asarray(e2),
            ng=jnp.asarray(ng), shape_id=jnp.asarray(tri_shape),
            uv0=jnp.asarray(tri_uvs[:, 0]),
            uve1=jnp.asarray(tri_uvs[:, 1] - tri_uvs[:, 0]),
            uve2=jnp.asarray(tri_uvs[:, 2] - tri_uvs[:, 0]),
            sph_center=jnp.asarray(sc), sph_radius=jnp.asarray(sr),
            sph_shape_id=jnp.asarray(ss), bvh=tree,
        )

        ns = max(len(self._shapes), 1)
        sh = T.Shapes(
            bsdf=jnp.asarray(np.array([s["bsdf"] for s in self._shapes] or [-1], np.int32)),
            emitter=jnp.asarray(np.array([s["emitter"] for s in self._shapes] or [-1], np.int32)),
            interior=jnp.asarray(np.array([s["interior"] for s in self._shapes] or [-1], np.int32)),
            exterior=jnp.asarray(np.array([s["exterior"] for s in self._shapes] or [-1], np.int32)),
        )

        if not self._bsdfs:
            self._bsdfs.append(_BSDF())
        bs = T.BSDFs(
            kind=jnp.asarray(np.array([b.kind for b in self._bsdfs], np.int32)),
            reflectance=jnp.asarray(np.array([b.reflectance for b in self._bsdfs], np.float32)),
            specular_r=jnp.asarray(np.array([b.specular_r for b in self._bsdfs], np.float32)),
            specular_t=jnp.asarray(np.array([b.specular_t for b in self._bsdfs], np.float32)),
            eta=jnp.asarray(np.array([b.eta for b in self._bsdfs], np.float32)),
            cond_eta=jnp.asarray(np.array([b.cond_eta for b in self._bsdfs], np.float32)),
            cond_k=jnp.asarray(np.array([b.cond_k for b in self._bsdfs], np.float32)),
            alpha=jnp.asarray(np.array([b.alpha for b in self._bsdfs], np.float32)),
            exponent=jnp.asarray(np.array([b.exponent for b in self._bsdfs], np.float32)),
            alpha_v=jnp.asarray(np.array([b.alpha_v for b in self._bsdfs], np.float32)),
            opacity=jnp.asarray(np.array([b.opacity for b in self._bsdfs], np.float32)),
            texture=jnp.asarray(np.array([b.texture for b in self._bsdfs], np.int32)),
            twosided=jnp.asarray(np.array([b.twosided for b in self._bsdfs], bool)),
            child0=jnp.asarray(np.array([b.child0 for b in self._bsdfs], np.int32)),
            child1=jnp.asarray(np.array([b.child1 for b in self._bsdfs], np.int32)),
            mix_w=jnp.asarray(np.array([b.mix_w for b in self._bsdfs], np.float32)),
            normal_tex=jnp.asarray(np.array([b.normal_tex for b in self._bsdfs], np.int32)),
        )
        _wrap = (T.BSDF_MIXTURE, T.BSDF_TWOSIDED)
        for b in self._bsdfs:
            if b.kind in _wrap:
                cs = [b.child0] + ([b.child1] if b.kind == T.BSDF_MIXTURE
                                   else [])
                for c in cs:
                    assert 0 <= c < len(self._bsdfs), "wrapper child id"
                    assert self._bsdfs[c].kind not in _wrap, \
                        "wrapper children must be base BSDFs (one level; " \
                        "the reference's mixturebsdf flattens nesting too)" 

        emitters = self._build_emitters(tri, tri_shape, areas2)
        sensor = self._build_sensor()
        media = self._build_media()
        textures = self._build_textures()

        kinds = {b.kind for b in self._bsdfs}
        for b in self._bsdfs:
            if b.kind == T.BSDF_MIXTURE:
                kinds.add(self._bsdfs[b.child0].kind)
                kinds.add(self._bsdfs[b.child1].kind)
            if b.kind == T.BSDF_TWOSIDED:
                kinds.add(self._bsdfs[b.child0].kind)
        if any(s_["bsdf"] < 0 for s_ in self._shapes):
            kinds.add(T.BSDF_NULL)
        self.config = self.config._replace(
            bsdf_kinds=tuple(sorted(kinds)),
            has_textures=any(b.texture >= 0 for b in self._bsdfs),
            has_normal_tex=any(b.normal_tex >= 0 for b in self._bsdfs),
            medium_strategies=any(
                m.strategy != T.STRAT_BALANCE for m in self._media),
            phase_kinds=tuple(sorted({m.phase_kind for m in self._media}))
            or (T.PH_ISOTROPIC,),
            rif_kinds=tuple(sorted({m.rif_kind for m in self._media
                                    if m.kind == T.MED_REFRACTIVE})),
            phase_orient=any(m.orientation is not None for m in self._media),
            sensor_kind=int((self._sensor or {}).get(
                "kind", T.SENSOR_PERSPECTIVE)),
        )

        # scene bounds
        pts = [tri.reshape(-1, 3)]
        for c, r, _ in self._spheres:
            pts.append(c[None, :] - r)
            pts.append(c[None, :] + r)
        allp = np.concatenate(pts, axis=0)
        return T.Scene(
            geo=geo, shapes=sh, bsdfs=bs, emitters=emitters, sensor=sensor,
            media=media, textures=textures,
            aabb_min=jnp.asarray(allp.min(axis=0)),
            aabb_max=jnp.asarray(allp.max(axis=0)),
            camera_medium=jnp.asarray(self.camera_medium, jnp.int32),
        )

    def _build_emitters(self, tri, tri_shape, areas2) -> T.Emitters:
        if not self._emitters:
            self._emitters.append(_Emitter(kind=T.EM_POINT, radiance=(0, 0, 0)))
        ne = len(self._emitters)
        tri_index, tri_cdf, tri_emitter = [], [], []
        tri_offset = np.zeros(ne, np.int32)
        tri_count = np.zeros(ne, np.int32)
        area = np.zeros(ne, np.float32)
        for ei, em in enumerate(self._emitters):
            tri_offset[ei] = len(tri_index)
            if em.kind == T.EM_AREA and em.shape_id >= 0:
                ids = np.nonzero(tri_shape == em.shape_id)[0]
                a = 0.5 * areas2[ids]
                total = a.sum()
                area[ei] = total
                cdf = np.cumsum(a) / max(total, 1e-20)
                tri_index.extend(ids.tolist())
                tri_cdf.extend(cdf.tolist())
                tri_emitter.extend([ei] * len(ids))
                tri_count[ei] = len(ids)
        if not tri_index:
            tri_index, tri_cdf, tri_emitter = [0], [1.0], [-1]
        return T.Emitters(
            kind=jnp.asarray(np.array([e.kind for e in self._emitters], np.int32)),
            radiance=jnp.asarray(np.array([e.radiance for e in self._emitters], np.float32)),
            position=jnp.asarray(np.array([e.position for e in self._emitters], np.float32)),
            direction=jnp.asarray(
                np.array(
                    [np.asarray(e.direction) / max(np.linalg.norm(e.direction), 1e-20) for e in self._emitters],
                    np.float32,
                )
            ),
            shape_id=jnp.asarray(np.array([e.shape_id for e in self._emitters], np.int32)),
            area=jnp.asarray(area),
            cutoff_cos=jnp.asarray(
                np.array([np.cos(np.deg2rad(e.cutoff_deg)) for e in self._emitters], np.float32)
            ),
            beam_falloff_cos=jnp.asarray(
                np.array([np.cos(np.deg2rad(e.beam_width_deg)) for e in self._emitters], np.float32)
            ),
            tri_index=jnp.asarray(np.array(tri_index, np.int32)),
            tri_cdf=jnp.asarray(np.array(tri_cdf, np.float32)),
            tri_emitter=jnp.asarray(np.array(tri_emitter, np.int32)),
            tri_offset=jnp.asarray(tri_offset),
            tri_count=jnp.asarray(tri_count),
            **self._envmap_tables(),
        )

    def _envmap_tables(self):
        """Precompute lat-long importance-sampling CDFs (envmap.cpp builds
        the same hierarchical tables at load; a flat row/col CDF suffices)."""
        env = next((e for e in self._emitters if e.kind == T.EM_ENVMAP
                    and e.envmap is not None), None)
        if env is None:
            return dict(
                env_map=jnp.ones((1, 1, 3), jnp.float32),
                env_cdf_rows=jnp.ones((1,), jnp.float32),
                env_cdf_cond=jnp.ones((1, 1), jnp.float32),
                env_to_world=jnp.eye(3, dtype=jnp.float32),
                env_scale=jnp.asarray(1.0, jnp.float32),
            )
        img = np.asarray(env.envmap, np.float32)
        He, We = img.shape[:2]
        lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        theta = (np.arange(He) + 0.5) / He * np.pi
        w = lum * np.sin(theta)[:, None] + 1e-12
        row_w = w.sum(axis=1)
        cdf_rows = np.cumsum(row_w) / row_w.sum()
        cdf_cond = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
        rot = np.eye(3, dtype=np.float32)
        if env.to_world is not None:
            rot = np.asarray(env.to_world, np.float32)[:3, :3]
        return dict(
            env_map=jnp.asarray(img),
            env_cdf_rows=jnp.asarray(cdf_rows.astype(np.float32)),
            env_cdf_cond=jnp.asarray(cdf_cond.astype(np.float32)),
            env_to_world=jnp.asarray(rot),
            env_scale=jnp.asarray(env.scale, jnp.float32),
        )

    def _build_textures(self) -> T.Textures:
        if not self._textures:
            return T.empty_textures()
        bitmap = np.ones((1, 1, 3), np.float32)
        use_bitmap = []
        n_bitmaps = sum(1 for t in self._textures if t.bitmap is not None)
        if n_bitmaps > 1:
            # single-shared-bitmap constraint: with >1 distinct images every
            # bitmap texture would silently sample the last-loaded one
            raise ValueError(
                f"scene uses {n_bitmaps} bitmap textures but the texture "
                "table holds a single shared image; atlas them into one "
                "bitmap or use procedural textures")
        for t in self._textures:
            if t.bitmap is not None:
                bitmap = np.asarray(t.bitmap, np.float32)
                use_bitmap.append(True)
            else:
                use_bitmap.append(False)
        return T.Textures(
            kind=jnp.asarray(np.array([t.kind for t in self._textures], np.int32)),
            color0=jnp.asarray(np.array([t.color0 for t in self._textures], np.float32)),
            color1=jnp.asarray(np.array([t.color1 for t in self._textures], np.float32)),
            uv_scale=jnp.asarray(np.array([t.uv_scale for t in self._textures], np.float32)),
            uv_offset=jnp.asarray(np.array([t.uv_offset for t in self._textures], np.float32)),
            line_width=jnp.asarray(np.array([t.line_width for t in self._textures], np.float32)),
            use_bitmap=jnp.asarray(np.array(use_bitmap, bool)),
            bitmap=jnp.asarray(bitmap),
        )

    def _build_sensor(self) -> T.Sensor:
        s = self._sensor or dict(
            to_world=np.eye(4, dtype=np.float32), fov_deg=45.0, fov_axis="x",
            near=1e-2, far=1e4,
        )
        s.setdefault("kind", T.SENSOR_PERSPECTIVE)
        s.setdefault("aperture", 0.0)
        s.setdefault("focus", 1.0)
        s.setdefault("kc", (0.0, 0.0))
        w, h = self.config.width, self.config.height
        aspect = w / h
        tan_half = np.tan(np.deg2rad(s["fov_deg"]) / 2)
        if s["fov_axis"] == "x":
            tan_x, tan_y = tan_half, tan_half / aspect
        elif s["fov_axis"] == "y":
            tan_x, tan_y = tan_half * aspect, tan_half
        else:  # smaller | larger | diagonal -> approximate with smaller
            tan_x, tan_y = tan_half, tan_half / aspect
        return T.Sensor(
            kind=jnp.asarray(s["kind"], jnp.int32),
            to_world=jnp.asarray(s["to_world"]),
            tan_x=jnp.asarray(tan_x, jnp.float32),
            tan_y=jnp.asarray(tan_y, jnp.float32),
            near=jnp.asarray(s["near"], jnp.float32),
            far=jnp.asarray(s["far"], jnp.float32),
            aperture=jnp.asarray(s["aperture"], jnp.float32),
            focus=jnp.asarray(s["focus"], jnp.float32),
            kc=jnp.asarray(s["kc"], jnp.float32),
        )

    def _build_media(self) -> T.Media:
        if not self._media:
            return T.empty_media()
        nm = len(self._media)
        kind = np.array([m.kind for m in self._media], np.int32)
        sigma_a = np.array([m.sigma_a for m in self._media], np.float32)
        sigma_s = np.array([m.sigma_s for m in self._media], np.float32)
        sw = np.array([m.sampling_weight for m in self._media], np.float32)
        # default sampling weight = max channel albedo clamped to >= 0.5
        # (homogeneous.cpp:168-184)
        sigma_t = sigma_a + sigma_s
        for i in range(nm):
            if sw[i] < 0:
                with np.errstate(divide="ignore", invalid="ignore"):
                    alb = np.where(sigma_t[i] > 0, sigma_s[i] / sigma_t[i], 0.0)
                w = alb.max() if np.any(sigma_t[i] > 0) else 0.0
                sw[i] = max(w, 0.5) if w > 0 else 0.0

        g1 = T.GridData(jnp.zeros((1, 1, 1), jnp.float32), jnp.zeros(3), jnp.ones(3))
        density = g1
        albedo = g1
        brick_map = np.zeros((1, 1, 1, 128), np.int32)
        majorant = 0.0
        rif_coeff, rif_aabb = np.ones((1, 1, 1), np.float32), (np.zeros(3), np.ones(3))
        sdf_coeff, sdf_aabb = np.ones((1, 1, 1), np.float32), (np.zeros(3), np.ones(3))
        orient = T.GridData(jnp.zeros((1, 1, 1, 3), jnp.float32),
                            jnp.zeros(3), jnp.ones(3))
        sdf_error = 0.0
        rif_kind, rif_params = 0, (1.0, 0, 0, 0, 0, 0, 0, 0)
        sdf_kind, sdf_params = 0, (0.0,) * 8
        for m in self._media:
            if m.kind == T.MED_HETEROGENEOUS and m.density is not None:
                lo, hi = m.density_aabb
                density = T.GridData(
                    jnp.asarray(m.density, jnp.float32),
                    jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32),
                )
                if m.albedo_grid is not None:
                    albedo = T.GridData(
                        jnp.asarray(m.albedo_grid, jnp.float32),
                        jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32),
                    )
                if m.orientation is not None:
                    orient = T.GridData(
                        jnp.asarray(m.orientation, jnp.float32),
                        jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32),
                    )
                majorant = float(np.max(m.density) * m.scale)
                from ..models.medium import build_brick_map

                nz, ny, nx = m.density.shape[:3]
                brick_map = build_brick_map(nz, ny, nx)
            if m.kind == T.MED_REFRACTIVE:
                rif_kind, rif_params = m.rif_kind, tuple(m.rif_params) + (0,) * (8 - len(m.rif_params))
                sdf_kind, sdf_params = m.sdf_kind, tuple(m.sdf_params) + (0,) * (8 - len(m.sdf_params))
                if m.rif is not None:
                    rif_coeff = spline.prefilter(m.rif)
                    rif_aabb = (np.asarray(m.rif_aabb[0]), np.asarray(m.rif_aabb[1]))
                if m.sdf is not None:
                    sdf_coeff = spline.prefilter(m.sdf)
                    sdf_aabb = (np.asarray(m.sdf_aabb[0]), np.asarray(m.sdf_aabb[1]))
                    res = np.array(m.sdf.shape[::-1], np.float64)  # nx, ny, nz
                    ext = np.asarray(sdf_aabb[1], np.float64) - np.asarray(sdf_aabb[0], np.float64)
                    sdf_error = float(np.linalg.norm(ext / np.maximum(res - 1, 1)))

        return T.Media(
            kind=jnp.asarray(kind),
            sigma_a=jnp.asarray(sigma_a),
            sigma_s=jnp.asarray(sigma_s),
            sampling_weight=jnp.asarray(sw),
            strategy=jnp.asarray(np.array([m.strategy for m in self._media], np.int32)),
            manual_density=jnp.asarray(np.array([m.manual_density for m in self._media], np.float32)),
            phase=T.PhaseTable(
                kind=jnp.asarray(np.array([m.phase_kind for m in self._media], np.int32)),
                g=jnp.asarray(np.array([m.g for m in self._media], np.float32)),
                g2=jnp.asarray(np.array([m.g2 for m in self._media], np.float32)),
                mix=jnp.asarray(np.array([m.phase_mix for m in self._media], np.float32)),
                kappa=jnp.asarray(np.array([m.kappa for m in self._media], np.float32)),
                axis=jnp.asarray(np.array(
                    [np.asarray(m.fiber_axis) / max(np.linalg.norm(m.fiber_axis), 1e-9)
                     for m in self._media], np.float32)),
            ),
            scale=jnp.asarray(np.array([m.scale for m in self._media], np.float32)),
            density=density,
            albedo=albedo,
            orient=orient,
            brick_map=jnp.asarray(brick_map),
            majorant=jnp.asarray(majorant, jnp.float32),
            rif_kind=jnp.asarray(rif_kind, jnp.int32),
            rif_params=jnp.asarray(rif_params, jnp.float32),
            rif_coeff=jnp.asarray(rif_coeff),
            rif_min=jnp.asarray(rif_aabb[0], jnp.float32),
            rif_max=jnp.asarray(rif_aabb[1], jnp.float32),
            sdf_kind=jnp.asarray(sdf_kind, jnp.int32),
            sdf_params=jnp.asarray(sdf_params, jnp.float32),
            sdf_coeff=jnp.asarray(sdf_coeff),
            sdf_min=jnp.asarray(sdf_aabb[0], jnp.float32),
            sdf_max=jnp.asarray(sdf_aabb[1], jnp.float32),
            sdf_error=jnp.asarray(sdf_error, jnp.float32),
        )
