"""Isosurface extraction by vectorized marching tetrahedra, on the host.

A copy of ``semantic_abstraction_tpu/ops/marching.py`` for the port (numpy
only; the port imports nothing of the JAX package), so a volume gives the
same vertices and faces in both packages.

The reference extracts meshes with skimage's marching-cubes-lewiner
(reference: fusion.py:197-248, visualize.py:251-280); skimage is not a
dependency, and a 256-case cube table is unnecessary: each cell is
split into 6 tetrahedra whose 16 sign cases are derived programmatically
at import time (no hand-copied tables). Vertices lie on sign-crossing
edges with linear interpolation, so the surface is the same zero-level
set; triangle count is ~2x marching cubes.

All heavy work is vectorized numpy over active cells only.
"""
from __future__ import annotations

import numpy as np

# Cube corner offsets (Bourke layout)
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int64,
)

# 6-tetrahedra decomposition of the cube around the 0-6 diagonal
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int64,
)


def _build_tet_cases():
    """For each of the 16 inside/outside sign patterns of a tetrahedron's
    4 corners, the list of triangles as (corner_a, corner_b) edge pairs."""
    cases = []
    for mask in range(16):
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if not ((mask >> i) & 1)]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            e = [(a, o) for o in outside]
            tris = [[e[0], e[1], e[2]]]
        elif len(inside) == 3:
            a = outside[0]
            e = [(i, a) for i in inside]
            tris = [[e[0], e[2], e[1]]]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            ac, ad, bc, bd = (a, c), (a, d), (b, c), (b, d)
            tris = [[ac, ad, bd], [ac, bd, bc]]
        cases.append(tris)
    return cases


_TET_CASES = _build_tet_cases()
# Pad to fixed (16, 2 triangles, 3 edges, 2 endpoints); -1 marks unused
_CASE_EDGES = np.full((16, 2, 3, 2), -1, dtype=np.int64)
_CASE_NTRI = np.zeros(16, dtype=np.int64)
for _m, _tris in enumerate(_TET_CASES):
    _CASE_NTRI[_m] = len(_tris)
    for _t, _tri in enumerate(_tris):
        for _e, (_a, _b) in enumerate(_tri):
            _CASE_EDGES[_m, _t, _e] = (_a, _b)


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0):
    """Extract the ``level`` isosurface of a (X, Y, Z) scalar volume.

    Returns (verts (V, 3) float32 in voxel-index coordinates,
    faces (F, 3) int32). Vertices are deduplicated.
    """
    vol = np.asarray(volume, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError("volume must be 3-D")
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    inside = vol < level  # "inside" the surface (negative TSDF = occupied)

    # active cells: sign change among the 8 corners
    cnt = np.zeros((nx - 1, ny - 1, nz - 1), dtype=np.int8)
    for dx, dy, dz in _CORNERS:
        cnt += inside[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
    ci, cj, ck = np.nonzero((cnt > 0) & (cnt < 8))
    if ci.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    base = np.stack([ci, cj, ck], axis=1)  # (C, 3)

    # corner coordinates and values for active cells: (C, 8, 3), (C, 8)
    corner_idx = base[:, None, :] + _CORNERS[None]
    vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    ins = inside[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    # tetrahedra: (C, 6, 4)
    tvals = vals[:, _TETS]
    tins = ins[:, _TETS]
    tcoords = corner_idx[:, _TETS]  # (C, 6, 4, 3)
    mask = (
        tins[..., 0].astype(np.int64)
        | (tins[..., 1] << 1)
        | (tins[..., 2] << 2)
        | (tins[..., 3] << 3)
    )  # (C, 6)

    flat_mask = mask.reshape(-1)
    flat_vals = tvals.reshape(-1, 4)
    flat_coords = tcoords.reshape(-1, 4, 3).astype(np.float32)

    tri_edges = _CASE_EDGES[flat_mask]  # (T, 2, 3, 2)
    ntri = _CASE_NTRI[flat_mask]  # (T,)
    # expand to per-triangle rows
    t_sel, tri_sel = np.nonzero(
        np.arange(2)[None, :] < ntri[:, None]
    )  # tets x triangle slot
    edges = tri_edges[t_sel, tri_sel]  # (F, 3, 2) corner-id pairs
    va = np.take_along_axis(
        flat_vals[t_sel], edges[..., 0], axis=1
    )  # (F, 3)
    vb = np.take_along_axis(flat_vals[t_sel], edges[..., 1], axis=1)
    pa = np.take_along_axis(
        flat_coords[t_sel], edges[..., 0, None].repeat(3, -1), axis=1
    )  # (F, 3, 3)
    pb = np.take_along_axis(
        flat_coords[t_sel], edges[..., 1, None].repeat(3, -1), axis=1
    )
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-12, (level - va) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)[..., None]
    verts = pa + t * (pb - pa)  # (F, 3 verts, 3 xyz)

    # consistent OUTWARD winding (toward increasing values — empty space in
    # TSDF convention, matching skimage marching-cubes orientation
    # semantics): every case edge is ordered (inside, outside), so
    # mean(pb) - mean(pa) has a strictly positive dot with the local field
    # gradient on each tet (dot(grad, pb_j - pa_i) = phi_out - phi_in > 0);
    # flip triangles whose normal opposes it. The 6-tet cube decomposition
    # has mixed parity, so a fixed per-case winding alone cannot be
    # globally consistent.
    normal = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    outward = pb.mean(axis=1) - pa.mean(axis=1)
    flip = np.einsum("ij,ij->i", normal, outward) < 0
    verts[flip] = verts[flip][:, [0, 2, 1]]

    flat_verts = verts.reshape(-1, 3)
    # deduplicate (quantize to kill float noise)
    keys = np.round(flat_verts * 1024.0).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    out_verts = flat_verts[uniq_idx].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return out_verts, faces[good]
