"""Host-side shape tessellation + world-space transform (counterpart of
mcpt_tpu/scene/shapes.py; csrt src/rtcore/scene.cpp:196-281).

Rectangle and cube tessellate exactly like the reference, and mesh
instances pass through, so prim k here is prim k there.  Spheres, disks
and cylinders are never tessellated: compile_scene makes them analytic
quadric rows (ops/quadric.py), as the reference's does.
"""

from __future__ import annotations

import numpy as np

from mcpt_tpu_torch.scene.ir import InstanceInfo, MeshData

# Rectangle: [-1,1]^2 at z=0, +z normal (csrt scene.cpp:196-212)
_RECT_POS = np.array(
    [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
)
_RECT_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
_RECT_NRM = np.array([[0, 0, 1]] * 4, np.float32)
_RECT_IDX = np.array([[0, 1, 2], [2, 3, 0]], np.int32)

# Cube: [-1,1]^3, 24 verts / 12 tris, outward per-face normals
# (csrt scene.cpp:214-245)
_CUBE_POS = np.array(
    [
        [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
        [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
        [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
        [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    ],
    np.float32,
)
_CUBE_NRM = np.array(
    [
        [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
        [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0],
        [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0],
        [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1],
        [-1, 0, 0], [-1, 0, 0], [-1, 0, 0], [-1, 0, 0],
        [0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, -1],
    ],
    np.float32,
)
_CUBE_UV = np.tile(
    np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32), (6, 1)
)
_CUBE_IDX = np.array(
    [
        [0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6],
        [8, 9, 10], [11, 8, 10], [12, 13, 14], [15, 12, 14],
        [16, 17, 18], [19, 16, 18], [20, 21, 22], [23, 20, 22],
    ],
    np.int32,
)


def rectangle_mesh() -> MeshData:
    return MeshData(
        positions=_RECT_POS.copy(),
        indices=_RECT_IDX.copy(),
        normals=_RECT_NRM.copy(),
        texcoords=_RECT_UV.copy(),
    )


def cube_mesh() -> MeshData:
    return MeshData(
        positions=_CUBE_POS.copy(),
        indices=_CUBE_IDX.copy(),
        normals=_CUBE_NRM.copy(),
        texcoords=_CUBE_UV.copy(),
    )


def instance_triangles(info: InstanceInfo):
    """Lower one instance to world-space triangle soup.

    Returns (positions [F,3,3], normals [F,3,3] | None,
    texcoords [F,3,2] | None, tangents [F,3,3] | None).
    Mirrors csrt CommitMeshes' world transform (scene.cpp:261-281):
    positions via to_world, normals via inverse-transpose.
    """
    if info.shape == "rectangle":
        mesh = rectangle_mesh()
    elif info.shape == "cube":
        mesh = cube_mesh()
    elif info.shape == "mesh":
        mesh = info.mesh
        if mesh is None:
            raise ValueError("mesh instance without mesh data")
    else:
        raise ValueError(f"unsupported shape '{info.shape}'")

    m = np.asarray(info.to_world, np.float32)
    pos_h = np.concatenate(
        [mesh.positions, np.ones((len(mesh.positions), 1), np.float32)], axis=1
    )
    pos_w = (pos_h @ m.T)[:, :3]

    normals = mesh.normals
    if normals is not None:
        # normal matrix = inverse-transpose of the linear part
        nmat = np.linalg.inv(m[:3, :3]).T
        nrm_w = normals @ nmat.T
        nl = np.linalg.norm(nrm_w, axis=1, keepdims=True)
        nrm_w = nrm_w / np.maximum(nl, 1e-12)
        if info.flip_normals:
            nrm_w = -nrm_w
    else:
        nrm_w = None

    tangents = mesh.tangents
    if tangents is not None:
        tan_w = tangents @ m[:3, :3].T
        tl = np.linalg.norm(tan_w, axis=1, keepdims=True)
        tan_w = tan_w / np.maximum(tl, 1e-12)
    else:
        tan_w = None

    idx = np.asarray(mesh.indices, np.int64)
    tri_pos = pos_w[idx]
    tri_nrm = nrm_w[idx] if nrm_w is not None else None
    tri_uv = (
        np.asarray(mesh.texcoords, np.float32)[idx]
        if mesh.texcoords is not None
        else None
    )
    tri_tan = tan_w[idx] if tan_w is not None else None
    return tri_pos.astype(np.float32), tri_nrm, tri_uv, tri_tan


def triangle_areas(tri_pos: np.ndarray) -> np.ndarray:
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
