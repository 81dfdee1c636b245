"""Scene representation: flat pytrees of arrays.

Array-program redesign of the reference's object graph (Scene/Shape/BSDF/...
ref-counted C++ objects, include/mitsuba/render/scene.h:49): the whole scene
is a pytree of dense arrays indexed by integer ids, so one jitted program
renders any scene of the same "shape class" and all per-type dispatch is
branchless masked arithmetic. Static render settings live in RenderConfig
(hashable, passed static to jit).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

# BSDF kinds (models/bsdf.py)
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_CONDUCTOR = 2
BSDF_NULL = 3
BSDF_PLASTIC = 4
BSDF_ROUGHCONDUCTOR = 5
BSDF_THINDIELECTRIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_PHONG = 8
BSDF_MIRROR = 9
BSDF_HDIELECTRIC = 10  # eta queried from RIF at the hit point (hdielectric.cpp)
BSDF_ROUGHPLASTIC = 11
BSDF_WARD = 12
BSDF_DIFFTRANS = 13       # diffuse transmitter (difftrans.cpp)
BSDF_HROUGHDIELECTRIC = 14  # rough dielectric w/ RIF-queried eta (hroughdielectric.cpp)
BSDF_MIXTURE = 15         # convex combination of two base BSDFs (mixturebsdf.cpp/blendbsdf.cpp)
BSDF_TWOSIDED = 16        # twosided.cpp wrapper: child0 shaded on both faces
BSDF_HK = 17              # Hanrahan-Krueger thin-slab single scattering
BSDF_ROUGHDIFFUSE = 18    # Oren-Nayar rough diffuse (roughdiffuse.cpp)
BSDF_COATING = 19         # smooth dielectric coat over child0 (coating.cpp)
BSDF_ROUGHCOATING = 20    # GGX-rough coat over child0 (roughcoating.cpp)
#   (hk.cpp): specular_r = sigma_s, specular_t = sigma_a,
#   alpha = slab thickness, mix_w = HG g; single-scatter reflection +
#   transmission lobes and attenuated delta straight-through

# Texture kinds (models/texture.py; reference src/textures/*)
TEX_NONE = -1
TEX_CHECKERBOARD = 0
TEX_GRIDTEXTURE = 1
TEX_BITMAP = 2
TEX_WIREFRAME = 3
TEX_SCALE = 4          # scale.cpp: constant * nested (we fold: color0 * bitmap)
TEX_NORMALMAP = 5      # normalmap.cpp: tangent-space normal from RGB
TEX_BUMPMAP = 6        # bumpmap.cpp: height field; normal from uv gradient
TEX_NOISE = 7          # noise.cpp: Perlin fBm blending color0/color1
#   (bump strength = color0[0])

# Emitter kinds (models/emitter.py)
EM_AREA = 0
EM_POINT = 1
EM_DIRECTIONAL = 2
EM_COLLIMATED = 3
EM_CONSTANT = 4
EM_SPOT = 5
EM_ENVMAP = 6

# Medium kinds (models/medium.py)
MED_HOMOGENEOUS = 0
MED_HETEROGENEOUS = 1
MED_REFRACTIVE = 2

# Homogeneous distance-sampling strategies (homogeneous.cpp:143 EBalance/
# ESingle/EManual/EMaximum)
STRAT_BALANCE = 0
STRAT_SINGLE = 1
STRAT_MANUAL = 2
STRAT_MAXIMUM = 3

# Phase kinds
PH_ISOTROPIC = 0
PH_HG = 1
PH_RAYLEIGH = 2
PH_VMF = 3        # von Mises-Fisher lobe (src/phase/vmf.cpp, vmf2.cpp)
PH_MIXTURE = 4    # two-lobe HG mixture (src/phase/mixturephase.cpp)
PH_KKAY = 5       # Kajiya-Kay fiber phase (src/phase/kkay.cpp)
PH_MICROFLAKE = 6  # vMF-distributed flakes about a fiber axis
#   (src/phase/microflake.cpp + microflake_fiber.h; constant-axis variant —
#   per-voxel orientation fields hook in via Media.albedo-style grids later)


class Geometry(NamedTuple):
    """All triangles of the scene in one SoA buffer + analytic spheres."""

    v0: jnp.ndarray        # (T, 3)
    e1: jnp.ndarray        # (T, 3) v1 - v0
    e2: jnp.ndarray        # (T, 3) v2 - v0
    ng: jnp.ndarray        # (T, 3) unit geometric normal
    shape_id: jnp.ndarray  # (T,) int32
    uv0: jnp.ndarray       # (T, 2) texture coords at v0 (trimesh.cpp m_texcoords)
    uve1: jnp.ndarray      # (T, 2) uv1 - uv0
    uve2: jnp.ndarray      # (T, 2) uv2 - uv0
    sph_center: jnp.ndarray    # (S, 3)
    sph_radius: jnp.ndarray    # (S,)
    sph_shape_id: jnp.ndarray  # (S,) int32
    bvh: object = None         # Optional[scene.bvh.Bvh]: flattened BVH for
    #   big meshes (built by scene/build.py above _BVH_MIN_TRIS; None keeps
    #   the brute-force chunked scan — speed of light for O(10-100) tris)


class Shapes(NamedTuple):
    """Per-shape wiring (reference Shape::addChild, shape.cpp:129-180)."""

    bsdf: jnp.ndarray       # (NS,) int32, -1 = none (pure medium boundary)
    emitter: jnp.ndarray    # (NS,) int32, -1 = none
    interior: jnp.ndarray   # (NS,) int32 medium id, -1 = vacuum
    exterior: jnp.ndarray   # (NS,) int32 medium id, -1 = vacuum


class BSDFs(NamedTuple):
    """Tagged-union BSDF parameter table."""

    kind: jnp.ndarray           # (NB,) int32
    reflectance: jnp.ndarray    # (NB, 3) diffuse albedo / plastic diffuse
    specular_r: jnp.ndarray     # (NB, 3)
    specular_t: jnp.ndarray     # (NB, 3)
    eta: jnp.ndarray            # (NB,) relative IOR int/ext (dielectrics)
    cond_eta: jnp.ndarray       # (NB, 3) conductor eta
    cond_k: jnp.ndarray         # (NB, 3) conductor k
    alpha: jnp.ndarray          # (NB,) GGX roughness (ward: alpha_u)
    exponent: jnp.ndarray       # (NB,) phong exponent
    alpha_v: jnp.ndarray        # (NB,) ward anisotropic roughness v
    opacity: jnp.ndarray        # (NB,) mask.cpp opacity (1 = fully opaque)
    texture: jnp.ndarray        # (NB,) int32 texture id modulating
    #   reflectance (-1 = constant; models/texture.py)
    twosided: jnp.ndarray       # (NB,) bool twosided.cpp wrapper: shade
    #   back faces by mirroring the frame
    child0: jnp.ndarray         # (NB,) int32 mixture child A (-1 unused)
    child1: jnp.ndarray         # (NB,) int32 mixture child B
    mix_w: jnp.ndarray          # (NB,) mixture weight of child A
    normal_tex: jnp.ndarray = None  # (NB,) int32 TEX_NORMALMAP/TEX_BUMPMAP
    #   texture perturbing the shading frame (-1/None = geometric normal;
    #   normalmap.cpp, bumpmap.cpp — applied integrator-side where frames
    #   are built, models/texture.py shading_normal)


class Textures(NamedTuple):
    """Texture table (reference src/textures/*.cpp). One shared bitmap per
    scene (static pytree shape); procedural textures are per-row params."""

    kind: jnp.ndarray       # (NT,) int32 TEX_*
    color0: jnp.ndarray     # (NT, 3)
    color1: jnp.ndarray     # (NT, 3)
    uv_scale: jnp.ndarray   # (NT, 2)
    uv_offset: jnp.ndarray  # (NT, 2)
    line_width: jnp.ndarray  # (NT,) gridtexture/wireframe line width
    use_bitmap: jnp.ndarray  # (NT,) bool: row samples the shared bitmap
    bitmap: jnp.ndarray     # (Hb, Wb, 3) shared image ((1,1,3) if unused)


class Emitters(NamedTuple):
    kind: jnp.ndarray        # (NE,) int32
    radiance: jnp.ndarray    # (NE, 3) area radiance / point intensity /
    #                           directional irradiance / collimated power
    position: jnp.ndarray    # (NE, 3)
    direction: jnp.ndarray   # (NE, 3) unit
    shape_id: jnp.ndarray    # (NE,) int32 (area emitters), -1 otherwise
    area: jnp.ndarray        # (NE,) total surface area of area emitters
    cutoff_cos: jnp.ndarray  # (NE,) spot cutoff cosine
    beam_falloff_cos: jnp.ndarray  # (NE,)
    # shared lat-long environment map (envmap.cpp); (1,1,3) when absent.
    # env_* rows: precomputed sampling tables (importance-sampled lat-long)
    env_map: jnp.ndarray       # (He, We, 3)
    env_cdf_rows: jnp.ndarray  # (He,) marginal CDF over rows (sin-weighted)
    env_cdf_cond: jnp.ndarray  # (He, We) conditional CDF per row
    env_to_world: jnp.ndarray  # (3, 3) rotation
    env_scale: jnp.ndarray     # () radiance scale
    # flattened per-triangle sampling table for area emitters
    tri_index: jnp.ndarray   # (M,) int32 global triangle id
    tri_cdf: jnp.ndarray     # (M,) cdf within the owning emitter's segment
    tri_emitter: jnp.ndarray  # (M,) int32
    tri_offset: jnp.ndarray  # (NE,) int32 segment start in the flat table
    tri_count: jnp.ndarray   # (NE,) int32


# Sensor kinds (models/sensor.py)
SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_SPHERICAL = 3
SENSOR_RADIANCEMETER = 4
SENSOR_TELECENTRIC = 5     # telecentric.cpp: ortho footprint + thin lens
SENSOR_PERSPECTIVE_RDIST = 6  # perspective_rdist.cpp: radial distortion
SENSOR_FLUENCEMETER = 7    # fluencemeter.cpp: uniform-sphere rays from a point
SENSOR_IRRADIANCEMETER = 8  # irradiancemeter.cpp: cosine rays from a patch


class Sensor(NamedTuple):
    kind: jnp.ndarray        # () int32
    to_world: jnp.ndarray    # (4, 4) camera-to-world
    tan_x: jnp.ndarray       # tan(fov_x / 2) (perspective) / half-width (ortho)
    tan_y: jnp.ndarray
    near: jnp.ndarray
    far: jnp.ndarray
    aperture: jnp.ndarray    # () thin-lens aperture radius
    focus: jnp.ndarray       # () focus distance
    kc: jnp.ndarray          # (2,) radial distortion coefficients (rdist)


class PhaseTable(NamedTuple):
    kind: jnp.ndarray  # (NM,) int32 per medium
    g: jnp.ndarray     # (NM,) HG asymmetry (mixture: first lobe)
    g2: jnp.ndarray    # (NM,) mixture second-lobe asymmetry
    mix: jnp.ndarray   # (NM,) mixture weight of first lobe
    kappa: jnp.ndarray  # (NM,) vMF / microflake concentration
    axis: jnp.ndarray  # (NM, 3) fiber axis (kkay / microflake)


class GridData(NamedTuple):
    """A density/albedo voxel grid shared layout (constant grids use (1,1,1))."""

    data: jnp.ndarray      # (nz, ny, nx) or (nz, ny, nx, 3)
    aabb_min: jnp.ndarray  # (3,)
    aabb_max: jnp.ndarray  # (3,)


class Media(NamedTuple):
    """Tagged-union medium table (reference medium.h:113 + plugins).

    To keep the pytree static-shaped there is at most one heterogeneous
    density grid and one refractive-index field per scene (matching every
    reference scene); homogeneous coefficients are per-medium arrays.
    """

    kind: jnp.ndarray       # (NM,) int32
    sigma_a: jnp.ndarray    # (NM, 3)
    sigma_s: jnp.ndarray    # (NM, 3)
    sampling_weight: jnp.ndarray  # (NM,) mediumSamplingWeight
    strategy: jnp.ndarray   # (NM,) int32 STRAT_* (homogeneous sampling)
    manual_density: jnp.ndarray  # (NM,) EManual strategy density
    phase: PhaseTable
    scale: jnp.ndarray      # (NM,) heterogeneous density scale
    # heterogeneous: sigma_t = scale * density(p) * sigma_t_color
    density: GridData       # shared density grid (medium with kind HETEROGENEOUS)
    albedo: GridData        # shared albedo grid (3-channel or broadcast)
    orient: GridData        # shared per-voxel flake/fiber orientation field
    #   ((1,1,1,3) zeros when absent; heterogeneous.cpp:164 'orientation'
    #   VolumeDataSource for microflake media)
    brick_map: jnp.ndarray  # (nbz, nby, nbx, 128) int32 flat voxel ids per
    #   apron-padded 8x4x4 brick (see models/medium.py bricked access)
    majorant: jnp.ndarray   # () max sigma_t over grid for Woodcock tracking
    # refractive: RIF field (analytic or spline) + SDF for inside tests
    rif_kind: jnp.ndarray    # () int32 (models/eikonal.py RIF_*)
    rif_params: jnp.ndarray  # (8,) analytic RIF parameters
    rif_coeff: jnp.ndarray   # (nz, ny, nx) B-spline coefficients
    rif_min: jnp.ndarray     # (3,)
    rif_max: jnp.ndarray     # (3,)
    sdf_kind: jnp.ndarray    # () int32 (models/eikonal.py SDF_*)
    sdf_params: jnp.ndarray  # (8,) analytic SDF parameters
    sdf_coeff: jnp.ndarray   # (nz, ny, nx) B-spline coefficients of SDF
    sdf_min: jnp.ndarray
    sdf_max: jnp.ndarray
    sdf_error: jnp.ndarray   # () maxSDFError (voxel diagonal)


class Scene(NamedTuple):
    geo: Geometry
    shapes: Shapes
    bsdfs: BSDFs
    emitters: Emitters
    sensor: Sensor
    media: Media
    textures: Textures
    aabb_min: jnp.ndarray
    aabb_max: jnp.ndarray
    camera_medium: jnp.ndarray  # int32 medium id at the camera, -1 = vacuum


def empty_textures() -> Textures:
    return Textures(
        kind=jnp.full((1,), TEX_NONE, jnp.int32),
        color0=jnp.ones((1, 3), jnp.float32),
        color1=jnp.zeros((1, 3), jnp.float32),
        uv_scale=jnp.ones((1, 2), jnp.float32),
        uv_offset=jnp.zeros((1, 2), jnp.float32),
        line_width=jnp.full((1,), 0.01, jnp.float32),
        use_bitmap=jnp.zeros((1,), bool),
        bitmap=jnp.ones((1, 1, 3), jnp.float32),
    )


class RenderConfig(NamedTuple):
    """Static (hashable) render settings — the analogue of integrator/film
    Properties in the reference. Passed as a static argument to jit."""

    width: int = 256
    height: int = 256
    max_depth: int = 12          # reference MonteCarloIntegrator maxDepth
    rr_depth: int = 5            # russian roulette start depth
    integrator: str = "path"     # path | volpath | volpath_simple | direct | ao
    filter: str = "gaussian"     # box | tent | gaussian
    sampler: str = "independent"  # independent | lds | stratified
    spp: int = 16
    # transient / ToF decomposition (film.cpp:56-80)
    decomposition: str = "steadystate"  # steadystate | transient | bounce
    min_bound: float = 0.0
    max_bound: float = 0.0
    bin_width: float = 1.0
    # CW-ToF modulation (pathlengthsampler.cpp)
    modulation: str = "none"     # none | sine | square | hamiltonian | mseq | depthselective
    lambda_: float = 1.0
    phase: float = 0.0
    P: int = 32
    neighbors: int = 3
    # eikonal marching controls (heterogeneousrefractive.cpp:208-217)
    er_stepsize: float = 1e-3
    er_maxsteps: int = 4096
    bvp_tol2: float = 1e-6
    rr_weight: float = 1e-2
    bvp_restarts: int = 8        # max rounds of the curved-NEE restart loop
    #   (makeDirectConnections while(true); 0 = legacy single chord solve)
    er_bvp_hscale: float = 1.0   # march the BVP Newton iterations at
    #   h * this scale (the dominant sequential depth: restarts x iters x
    #   curve steps); the converged direction is re-traced at the scaled h
    #   too, whose O((s*h)^2) endpoint error stays ~1e-3 at s=4 (see
    #   scripts/er_h_study.py) while the solver's sequential depth drops
    #   by s — the restart/Zeltner machinery already tolerates imperfect
    #   solves by construction
    er_f64: bool = False         # run the eikonal ODE/BVP core in float64
    #   (reference compiles eikonal math double via FLOATDEBUG, fwd.h:174;
    #   needs jax x64 enabled — CPU validation / high-accuracy renders)
    hide_emitters: bool = False
    strict_normals: bool = False
    sample_direct: bool = True   # bdpt sampleDirect analogue
    has_beam: bool = False       # static: scene contains a collimated emitter
    #   (set by the scene builder; compiles the beam-NEE machinery only when
    #   needed)
    field: str = "shNormal"      # field-extraction integrator output
    engine: str = "auto"         # auto | loop | wavefront (forward engine;
    #   "auto" picks the persistent-wavefront engine for steady-state
    #   path/volpath renders with a box filter)
    wf_track_iters: int = 4      # wavefront engine: heterogeneous tracking
    #   iterations per event pass (tune to the scene's taps-per-bounce)
    wf_track_compact: int = 0    # wavefront engine: sort-compacted tracking
    #   (r5 rework). 0 = full-width; >0 enables a width LADDER: each
    #   tracking pass packs the active lanes (sort + row gather), runs
    #   wf_compact_k jumps at the smallest ladder width that fits the
    #   active count, and scatters the packed outcomes back
    wf_compact_k: int = 8        # majorant jumps per compacted tracking
    #   pass (packed slots are cheaper than full-width slots, so the
    #   compacted pass runs more jumps and resolves most lanes in one go)
    wf_mini_passes: int = 1      # wavefront engine: cheap transition passes
    #   per super-iteration (null crossings / env escapes / flush+regen
    #   resolve without paying for NEE setup + direction sampling); 0
    #   restores the round-2 E+T pattern. Best measured on the bench scene:
    #   1 mini + 3-6 batched tracking jumps
    bsdf_kinds: tuple = ()       # static set of BSDF kinds in the scene;
    #   jit compiles only these lobes (() = all, models/bsdf.py _on)
    has_textures: bool = False   # static: any BSDF carries a texture
    has_normal_tex: bool = False  # static: any BSDF perturbs the shading
    #   frame via a normal/bump map (normalmap.cpp, bumpmap.cpp)
    medium_strategies: bool = False  # static: any medium uses a non-balance
    #   homogeneous sampling strategy (single/manual/maximum)
    wf_epoch_ring: int = 0       # wavefront film ring depth (0 = sppc: no
    #   stalls, per-sample slots; small values cap pending-buffer traffic at
    #   the cost of a min-completed barrier across lanes)
    wf_dda: int = 0              # wavefront engine: macro-majorant grid
    #   resolution per axis (regular tracking with local majorants; 0 =
    #   reference-style single global majorant, heterogeneous.cpp:420).
    #   Cuts useful taps ~1.5x (measured 2.99 -> 1.99/sample on the bench
    #   scene) but costs +31%/slot in hop bookkeeping: a win only where
    #   pass cost tracks ACTIVE lanes (the grouped engine), a loss at
    #   full width — so off by default in the full-width engine
    wf_dda_hops: int = 2         # tap-free macro-cell boundary hops absorbed
    #   per tracking slot
    rif_kinds: tuple = ()        # static set of refractive-index kinds in
    #   the scene; the eikonal code compiles only these (() = all)
    phase_kinds: tuple = ()      # static set of phase kinds in the scene
    phase_orient: bool = False   # static: a medium carries a per-voxel
    #   orientation field (microflake/kkay local axes)
    sensor_kind: int = -1        # static sensor kind (-1 = compile all)
    kernels: str = "auto"        # hand-written kernels (core/kernels.py):
    #   auto = Pallas/Triton kernels on a GPU, plain XLA elsewhere; xla =
    #   never; triton = always (raises off the GPU)

    @property
    def n_frames(self) -> int:
        if self.decomposition in ("transient", "bounce") and self.modulation == "none":
            return max(int(np.ceil((self.max_bound - self.min_bound) / self.bin_width)), 1)
        return 1


def empty_media() -> Media:
    z3 = jnp.zeros((1, 3), jnp.float32)
    g1 = GridData(jnp.zeros((1, 1, 1), jnp.float32), jnp.zeros(3), jnp.ones(3))
    return Media(
        kind=jnp.zeros((1,), jnp.int32),
        sigma_a=z3,
        sigma_s=z3,
        sampling_weight=jnp.ones((1,), jnp.float32),
        strategy=jnp.zeros((1,), jnp.int32),
        manual_density=jnp.ones((1,), jnp.float32),
        phase=PhaseTable(jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.float32),
                         jnp.zeros((1,), jnp.float32), jnp.ones((1,), jnp.float32),
                         jnp.ones((1,), jnp.float32),
                         jnp.concatenate([jnp.zeros((1, 2)), jnp.ones((1, 1))], axis=-1).astype(jnp.float32)),
        scale=jnp.ones((1,), jnp.float32),
        density=g1,
        albedo=g1,
        orient=GridData(jnp.zeros((1, 1, 1, 3), jnp.float32),
                        jnp.zeros(3), jnp.ones(3)),
        brick_map=jnp.zeros((1, 1, 1, 128), jnp.int32),
        majorant=jnp.zeros((), jnp.float32),
        rif_kind=jnp.zeros((), jnp.int32),
        rif_params=jnp.concatenate([jnp.ones(1), jnp.zeros(7)]).astype(jnp.float32),
        rif_coeff=jnp.ones((1, 1, 1), jnp.float32),
        rif_min=jnp.zeros(3),
        rif_max=jnp.ones(3),
        sdf_kind=jnp.zeros((), jnp.int32),
        sdf_params=jnp.zeros(8, jnp.float32),
        sdf_coeff=jnp.ones((1, 1, 1), jnp.float32),
        sdf_min=jnp.zeros(3),
        sdf_max=jnp.ones(3),
        sdf_error=jnp.zeros((), jnp.float32),
    )
