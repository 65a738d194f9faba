"""Scene IR (counterpart of mcpt_tpu/scene/ir.py): the plain-old-data
contract between scene construction and `compile_scene`, as host-side
dataclasses holding numpy — never tensors.

A copy, field for field, of the reference classes the port renders, so
one RendererConfig converts into the other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class BsdfType(enum.IntEnum):
    # integer codes are device-side table values (csrt bsdf.hpp:17-27);
    # CLEARCOAT_CONDUCTOR is the archive-v1 extra
    # (archive/src/bsdfs/clear_coated_conductor.hpp)
    AREA_LIGHT = 0
    DIFFUSE = 1
    ROUGH_DIFFUSE = 2
    CONDUCTOR = 3
    DIELECTRIC = 4
    THIN_DIELECTRIC = 5
    PLASTIC = 6
    CLEARCOAT_CONDUCTOR = 7


class EmitterType(enum.IntEnum):
    # analytic (non-area) emitters (csrt emitter.hpp:19-28)
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2
    SUN = 3
    ENVMAP = 4
    CONSTANT = 5


class TextureRef(int):
    """Index into the scene's texture list."""


@dataclasses.dataclass
class CameraInfo:
    # csrt camera.hpp:12-21 defaults
    width: int = 1024
    height: int = 1024
    spp: int = 64
    fov_x: float = 19.5
    eye: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 6.8], np.float32)
    )
    look_at: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )


@dataclasses.dataclass
class IntegratorInfo:
    # csrt integrator.hpp:16-27
    itype: str = "path"          # "path" | "volpath"
    depth_max: int = 64
    depth_rr: int = 5
    pdf_rr: float = 0.95
    hide_emitters: bool = False
    # extension over the reference: per-sample clamp is configurable.
    # csrt hard-codes clamp-to-1 (renderer.cpp:77-79), which measured
    # ~40% energy loss vs the Tungsten ground truth on cornell — the
    # default here is OFF (unbiased); set 1.0 for reference-compat
    # firefly suppression (SURVEY §7.4).
    sample_clamp: float = 0.0    # <= 0 disables


@dataclasses.dataclass
class BsdfInfo:
    btype: BsdfType = BsdfType.DIFFUSE
    twosided: bool = False
    # texture ids (every scalar parameter is a texture, csrt-style)
    id_opacity: int = -1
    id_bump_map: int = -1
    id_radiance: int = -1             # area light
    weight: float = 1.0               # area light sampling weight
    id_diffuse_reflectance: int = -1  # diffuse / rough diffuse / plastic
    id_roughness: int = -1            # rough diffuse (sigma) / plastic
    id_roughness_u: int = -1          # conductor / dielectric
    id_roughness_v: int = -1
    id_specular_reflectance: int = -1
    id_specular_transmittance: int = -1
    # conductor Gulbrandsen parametrization as plain RGB values — the
    # parser derives them from (eta, k) (csrt parser.cpp:944-949) and the
    # reference stores them as Vec3, not textures (conductor ctor
    # bsdf.cpp:148-151)
    reflectivity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    edgetint: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    eta: float = 1.5                  # dielectric / thin / plastic scalar IOR
    use_fast_approx: bool = False     # rough diffuse
    # microfacet distribution: "ggx" (csrt main) or "beckmann" (archive
    # ndfs/beckmann.cpp; Mitsuba `distribution` parameter)
    ndf: str = "ggx"
    # clear-coated conductor (archive clear_coated_conductor.cpp)
    clear_coat: float = 0.0
    id_coat_roughness: int = -1


@dataclasses.dataclass
class MediumInfo:
    mtype: str = "homogeneous"
    sigma_a: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    sigma_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    phase: str = "isotropic"          # "isotropic" | "hg"
    g: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )


@dataclasses.dataclass
class MeshData:
    """Indexed triangle mesh in object space."""

    positions: np.ndarray                    # [V, 3] float32
    indices: np.ndarray                      # [F, 3] int32
    normals: Optional[np.ndarray] = None     # [V, 3]
    texcoords: Optional[np.ndarray] = None   # [V, 2]
    tangents: Optional[np.ndarray] = None    # [V, 3]


@dataclasses.dataclass
class InstanceInfo:
    """One shape instance (csrt instance.hpp:40-51)."""

    shape: str                              # rectangle/cube/mesh/sphere/disk/cylinder
    to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    mesh: Optional[MeshData] = None         # for shape == "mesh"
    radius: float = 1.0                     # sphere / cylinder
    center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    p0: np.ndarray = dataclasses.field(      # cylinder endpoints
        default_factory=lambda: np.zeros(3, np.float32)
    )
    p1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32)
    )
    flip_normals: bool = False
    id_bsdf: int = -1
    id_medium_int: int = -1
    id_medium_ext: int = -1


@dataclasses.dataclass
class EmitterInfo:
    etype: EmitterType = EmitterType.POINT
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    intensity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32)
    )
    radiance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    # spot
    cutoff_angle: float = 20.0
    beam_width: float = 15.0
    id_texture: int = -1
    to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    scale: float = 1.0


@dataclasses.dataclass
class RendererConfig:
    """The full scene IR (csrt renderer.hpp:18-28)."""

    camera: CameraInfo = dataclasses.field(default_factory=CameraInfo)
    integrator: IntegratorInfo = dataclasses.field(default_factory=IntegratorInfo)
    textures: list = dataclasses.field(default_factory=list)   # TextureBuilder
    bsdfs: list = dataclasses.field(default_factory=list)      # [BsdfInfo]
    media: list = dataclasses.field(default_factory=list)      # [MediumInfo]
    instances: list = dataclasses.field(default_factory=list)  # [InstanceInfo]
    emitters: list = dataclasses.field(default_factory=list)   # [EmitterInfo]
    # performance knobs of the reference's config tiers: Renderer turns
    # each into an MCPT_* environment default ({"march_leaf": 64} ->
    # MCPT_MARCH_LEAF=64) before it commits the scene
    perf: dict = dataclasses.field(default_factory=dict)
