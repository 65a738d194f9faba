"""The benchmark's scene description, and its writer as a Mitsuba scene.

A configuration module (`configs/<name>.py`) builds a `Scene` from the
numbers of its JSON file: world-space triangle meshes with vertex
normals and uvs, one-sided materials, an optional constant sky and an
optional directional sun.  `write_mitsuba` writes it as the files a user
would hand the renderer: one binary PLY a mesh and one XML.  The plain
reference (`reference/`) reads the same `Scene`, so both sides see the
same float32 vertices and the same parameters.

The geometry helpers below are frozen copies of the layouts the port's
built-in scenes use (the rectangle and the cube of its shape tables, the
UV sphere, the translate @ rot_y @ rot_x @ scale placement), written out
here so that the benchmark does not depend on the code it measures.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# rectangle: [-1, 1]^2 at z = 0, facing +z
RECT_POS = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                    np.float64)
RECT_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
RECT_NRM = np.array([[0, 0, 1]] * 4, np.float64)
RECT_IDX = np.array([[0, 1, 2], [2, 3, 0]], np.int64)

# cube: [-1, 1]^3, four vertices a face, outward face normals
CUBE_POS = np.array([
    [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
    [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
    [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
    [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
], np.float64)
CUBE_NRM = np.repeat(np.array([[0, -1, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1],
                               [-1, 0, 0], [0, 0, -1]], np.float64), 4, axis=0)
CUBE_UV = np.tile(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float64),
                  (6, 1))
CUBE_IDX = np.array([
    [0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6], [8, 9, 10], [11, 8, 10],
    [12, 13, 14], [15, 12, 14], [16, 17, 18], [19, 16, 18],
    [20, 21, 22], [23, 20, 22],
], np.int64)


def placement(scale=(1.0, 1.0, 1.0), rot_x=0.0, rot_y=0.0,
              t=(0.0, 0.0, 0.0)) -> np.ndarray:
    """translate(t) @ rot_y @ rot_x @ scale as a float64 [4, 4]."""
    ax, ay = np.radians(rot_x), np.radians(rot_y)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    m = np.eye(4)
    m[:3, :3] = ry @ rx @ np.diag(scale)
    m[:3, 3] = t
    return m


def uv_sphere(rings: int, segments: int):
    """A unit UV sphere of 2 * rings * segments triangles (those at the
    poles degenerate), outward winding, vertex normals = positions:
    (positions [V, 3], normals [V, 3], faces [F, 3])."""
    th = np.linspace(0, np.pi, rings + 1, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, segments + 1, dtype=np.float32)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)],
                 -1).reshape(-1, 3).astype(np.float32)
    ii = (np.arange(rings)[:, None] * (segments + 1)
          + np.arange(segments)[None, :])
    quad = np.stack([ii, ii + 1, ii + segments + 1, ii + segments + 2],
                    -1).reshape(-1, 4)
    faces = np.concatenate([quad[:, [0, 1, 2]], quad[:, [1, 3, 2]]], 0)
    return v.astype(np.float64), v.astype(np.float64), faces.astype(np.int64)


@dataclass
class Material:
    """A one-sided surface: `diffuse` (albedo rgb, or a checkerboard of
    color0 / color1 over uv scaled by uv_scale), `roughconductor` (GGX
    alpha, complex IOR eta + i k per channel) or `emitter` (radiance)."""

    kind: str
    albedo: tuple = (0.5, 0.5, 0.5)
    checker: tuple | None = None      # (color0, color1, uv_scale)
    alpha: float = 0.1
    eta: tuple = (0.2, 0.2, 0.2)
    k: tuple = (3.9, 3.9, 3.9)
    radiance: tuple = (1.0, 1.0, 1.0)


@dataclass
class Mesh:
    """World-space triangles: float32 positions, normals and uvs a
    vertex, int32 faces, and the name of its material."""

    name: str
    material: str
    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    faces: np.ndarray


@dataclass
class Scene:
    width: int
    height: int
    spp: int
    max_depth: int
    rr_depth: int
    fov_x: float
    origin: tuple
    target: tuple
    up: tuple
    materials: dict
    meshes: list
    sky: tuple | None = None                  # constant sky radiance
    sun: tuple | None = None                  # (direction, irradiance)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_triangles(self) -> int:
        return sum(len(m.faces) for m in self.meshes)


def make_mesh(name, material, positions, normals, uvs, faces,
              to_world) -> Mesh:
    """A mesh placed by `to_world` (normals by its inverse transpose)."""
    m = np.asarray(to_world, np.float64)
    pos = np.asarray(positions, np.float64) @ m[:3, :3].T + m[:3, 3]
    nrm = np.asarray(normals, np.float64) @ np.linalg.inv(m[:3, :3])
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    uv = (np.zeros((len(pos), 2)) if uvs is None
          else np.asarray(uvs, np.float64))
    return Mesh(name, material, pos.astype(np.float32), nrm.astype(np.float32),
                uv.astype(np.float32), np.asarray(faces, np.int32))


def rectangle(name, material, **place) -> Mesh:
    return make_mesh(name, material, RECT_POS, RECT_NRM, RECT_UV, RECT_IDX,
                     placement(**place))


def cube(name, material, **place) -> Mesh:
    return make_mesh(name, material, CUBE_POS, CUBE_NRM, CUBE_UV, CUBE_IDX,
                     placement(**place))


def merge(name, meshes) -> Mesh:
    """One mesh of several of the same material."""
    base = np.cumsum([0] + [len(m.positions) for m in meshes[:-1]])
    return Mesh(name, meshes[0].material,
                np.concatenate([m.positions for m in meshes]),
                np.concatenate([m.normals for m in meshes]),
                np.concatenate([m.uvs for m in meshes]),
                np.concatenate([m.faces + b for m, b in zip(meshes, base)]
                               ).astype(np.int32))


def write_ply(path, mesh: Mesh):
    """A binary little-endian PLY of the mesh's positions, normals, uvs
    and triangles."""
    v = np.zeros(len(mesh.positions), [("p", "<f4", 3), ("n", "<f4", 3),
                                       ("t", "<f4", 2)])
    v["p"], v["n"], v["t"] = mesh.positions, mesh.normals, mesh.uvs
    f = np.zeros(len(mesh.faces), [("k", "u1"), ("i", "<i4", 3)])
    f["k"], f["i"] = 3, mesh.faces
    props = "".join(f"property float {p}\n"
                    for p in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n{props}element face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(head.encode() + v.tobytes() + f.tobytes())


def _rgb(name, c):
    return '<rgb name="{}" value="{!r}, {!r}, {!r}"/>'.format(
        name, *map(float, c))


def _bsdf_xml(name, mat: Material) -> str:
    if mat.kind == "diffuse":
        if mat.checker is None:
            refl = _rgb("reflectance", mat.albedo)
        else:
            c0, c1, s = mat.checker
            refl = ('<texture type="checkerboard" name="reflectance">'
                    + _rgb("color0", c0) + _rgb("color1", c1)
                    + f'<transform name="to_uv"><scale x="{float(s)!r}" '
                    f'y="{float(s)!r}"/></transform></texture>')
        return f'<bsdf type="diffuse" id="{name}">{refl}</bsdf>'
    if mat.kind == "roughconductor":
        return (f'<bsdf type="roughconductor" id="{name}">'
                '<string name="distribution" value="ggx"/>'
                f'<float name="alpha" value="{float(mat.alpha)!r}"/>'
                + _rgb("eta", mat.eta) + _rgb("k", mat.k) + "</bsdf>")
    raise ValueError(f"no bsdf for material kind {mat.kind!r}")


def write_mitsuba(scene: Scene, directory) -> str:
    """scene.xml and a PLY a mesh in `directory`; returns the XML's path."""
    os.makedirs(directory, exist_ok=True)
    parts = [
        '<scene version="0.6.0">',
        '<sensor type="perspective">'
        f'<float name="fov" value="{float(scene.fov_x)!r}"/>'
        '<string name="fovAxis" value="x"/><transform name="toWorld">'
        '<lookat origin="{!r}, {!r}, {!r}" target="{!r}, {!r}, {!r}" '
        'up="{!r}, {!r}, {!r}"/></transform>'.format(
            *map(float, (*scene.origin, *scene.target, *scene.up)))
        + '<sampler type="independent"><integer name="sampleCount" '
        f'value="{scene.spp}"/></sampler><film type="hdrfilm">'
        f'<integer name="width" value="{scene.width}"/>'
        f'<integer name="height" value="{scene.height}"/></film></sensor>',
        '<integrator type="path">'
        f'<integer name="maxDepth" value="{scene.max_depth}"/>'
        f'<integer name="rrDepth" value="{scene.rr_depth}"/></integrator>',
    ]
    for name, mat in scene.materials.items():
        if mat.kind != "emitter":
            parts.append(_bsdf_xml(name, mat))
    for mesh in scene.meshes:
        fn = f"{mesh.name}.ply"
        write_ply(os.path.join(directory, fn), mesh)
        mat = scene.materials[mesh.material]
        inner = (f'<emitter type="area">{_rgb("radiance", mat.radiance)}'
                 '</emitter>' if mat.kind == "emitter"
                 else f'<ref id="{mesh.material}"/>')
        parts.append(f'<shape type="ply"><string name="filename" '
                     f'value="{fn}"/>{inner}</shape>')
    if scene.sky is not None:
        parts.append(f'<emitter type="constant">{_rgb("radiance", scene.sky)}'
                     '</emitter>')
    if scene.sun is not None:
        d, e = scene.sun
        parts.append('<emitter type="directional"><vector name="direction" '
                     'x="{!r}" y="{!r}" z="{!r}"/>'.format(*map(float, d))
                     + _rgb("irradiance", e) + "</emitter>")
    parts.append("</scene>")
    path = os.path.join(directory, "scene.xml")
    with open(path, "w") as fh:
        fh.write("".join(parts))
    return path
