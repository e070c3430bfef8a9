"""Host-side numpy geometry + subsampling for the input pipeline.

A copy of ``semantic_abstraction_tpu/data/transforms.py`` for the port; the
resize matrix comes from the port's ``ops/sampling.py`` (the same
numbers). Numpy equivalents of the reference's dataset-side geometry (reference:
point_cloud.py get_pointcloud :34-66 / check_pts_in_frustum :88-110 /
filter_pts_bounds :24-31; dataset.py transform_filter_subsample :106-166;
transforms3d euler/affines usage at dataset.py:521-534, :1164-1178).

These run in loader workers on the host: the device boundary is the
fixed-shape batch, so all ragged filtering/sampling stays here in numpy.
``native`` (the C++ loader kernels) is imported inside the functions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def depth_to_pointcloud_np(depth: np.ndarray, cam_intr: np.ndarray,
                           cam_pose: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W) depth -> (H*W, 3) points (camera or world frame)."""
    h, w = depth.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = depth.astype(np.float64)
    x = (xx - cam_intr[0, 2]) * z / cam_intr[0, 0]
    y = (yy - cam_intr[1, 2]) * z / cam_intr[1, 1]
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    if cam_pose is not None:
        pts = pts @ np.asarray(cam_pose)[:3, :3].T + np.asarray(cam_pose)[:3, 3]
    return pts.astype(np.float32)


def check_pts_in_frustum_np(xyz_pts: np.ndarray, depth_shape,
                            cam_pose: np.ndarray,
                            cam_intr: np.ndarray) -> np.ndarray:
    from .. import native

    nm = native.frustum_mask(np.asarray(xyz_pts), depth_shape, cam_pose,
                             cam_intr)
    if nm is not None:
        return nm
    h, w = depth_shape
    inv = np.linalg.inv(np.asarray(cam_pose, dtype=np.float64))
    cam = xyz_pts @ inv[:3, :3].T + inv[:3, 3]
    z = cam[:, 2]
    safe_z = np.where(z == 0, 1e-12, z)
    px = cam_intr[0, 0] / safe_z * cam[:, 0] + cam_intr[0, 2]
    py = cam_intr[1, 1] / safe_z * cam[:, 1] + cam_intr[1, 2]
    return (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)


def filter_pts_bounds_np(xyz_pts: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    from .. import native

    nm = native.bounds_mask(np.asarray(xyz_pts), bounds)
    if nm is not None:
        return nm
    b = np.asarray(bounds)
    # column-wise in-place accumulation: no (N, 3) temporaries, no
    # axis-reduce pass (~5x at the 500k-point loader scale)
    if xyz_pts.ndim == 2 and xyz_pts.shape[1] == 3:
        m = (xyz_pts[:, 0] >= b[0, 0]) & (xyz_pts[:, 0] <= b[1, 0])
        m &= (xyz_pts[:, 1] >= b[0, 1]) & (xyz_pts[:, 1] <= b[1, 1])
        m &= (xyz_pts[:, 2] >= b[0, 2]) & (xyz_pts[:, 2] <= b[1, 2])
        return m
    return np.all((xyz_pts >= b[0]) & (xyz_pts <= b[1]), axis=-1)


def euler2mat(ai: float, aj: float, ak: float) -> np.ndarray:
    """sxyz-convention Euler angles -> 3x3 rotation (transforms3d default)."""
    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return np.array(
        [
            [cj * ck, sj * sc - cs, sj * cc + ss],
            [cj * sk, sj * ss + cc, sj * cs - sc],
            [-sj, cj * si, cj * ci],
        ]
    )


def compose_affine(t: np.ndarray, r: np.ndarray, z: np.ndarray) -> np.ndarray:
    """4x4 homogeneous from translation, rotation, per-axis scale
    (transforms3d.affines.compose semantics)."""
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(z)
    m[:3, 3] = t
    return m


def random_domain_transform(rng: np.random.RandomState, scene_bounds: np.ndarray,
                            dr_pos: float, dr_orn: float,
                            dr_scale: float) -> np.ndarray:
    """Random affine domain randomization (reference dataset.py:521-534)."""
    dims = scene_bounds[1] - scene_bounds[0]
    t = rng.randn(3) * dims * dr_pos
    r = euler2mat(
        (rng.rand() - 0.5) * dr_orn,
        (rng.rand() - 0.5) * dr_orn,
        (rng.rand() - 0.5) * dr_orn,
    )
    z = rng.rand(3) * dr_scale + 1.0
    return compose_affine(t, r, z).astype(np.float32)


def weighted_sample(rng: np.random.RandomState, probs: np.ndarray, k: int,
                    replace: bool) -> np.ndarray:
    """Weighted index sampling, distributionally equivalent to
    ``rng.choice(n, k, p=probs, replace=...)`` but vectorized.

    - without replacement: Efraimidis-Spirakis exponential keys
      (key_i ~ Exp(1)/w_i, take the k smallest) — identical in
      distribution to sequential weighted draws, ~20x faster than
      np.random.choice's O(n*k) path at the reference's 400k-of-1M scale.
    - with replacement: inverse-CDF via cumsum + searchsorted.

    Raises ValueError like np.random.choice when a no-replacement draw is
    infeasible (k exceeds the number of positive-weight entries), so the
    reference's replace=True fallback (dataset.py:150-156) still engages.

    Determinism is PER ENVIRONMENT, not cross-environment: the native
    path (alias method / Efraimidis-Spirakis) and this numpy fallback map
    the same RandomState stream through different algorithms, so a host
    without a C++ toolchain draws different (equally distributed) indices
    than one with it. The reference makes no cross-machine guarantee
    either (np.random.choice's O(n*k) path vs ours already differ).
    """
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    try:
        from .. import native

        if native.available():
            return native.weighted_sample(rng, probs, k, replace)
    except RuntimeError:
        pass
    if not replace:
        nonzero = int((probs > 0).sum())
        if k > nonzero:
            raise ValueError(
                f"cannot draw {k} without replacement from {nonzero} "
                "positive-weight entries"
            )
        with np.errstate(divide="ignore"):
            keys = rng.exponential(size=n) / probs
        if k >= n:
            return np.arange(n)
        return np.argpartition(keys, k - 1)[:k]
    cum = np.cumsum(probs)
    if cum[-1] <= 0:
        raise ValueError("probabilities sum to zero")
    u = rng.random_sample(k) * cum[-1]
    return np.minimum(np.searchsorted(cum, u, side="right"), n - 1)


def transform_filter_subsample(
    xyz_pts: np.ndarray,
    scene_bounds: np.ndarray,
    num_subsample_pts: int,
    subsample_probabilities: np.ndarray,
    always_replace_pts: bool,
    rng: np.random.RandomState,
    transform_matrix: Optional[np.ndarray] = None,
    **arrays,
) -> Dict[str, Optional[np.ndarray]]:
    """Transform -> in-bounds filter -> weighted subsample
    (reference dataset.py:106-166). Side arrays are filtered along axis 0
    when their leading dim matches the point count, else along axis 1;
    sampling falls back to replace=True when the draw fails."""
    from .. import native

    n = len(xyz_pts)
    if transform_matrix is not None:
        xyz_pts = xyz_pts @ transform_matrix[:3, :3].T + transform_matrix[:3, 3]
    mask = filter_pts_bounds_np(xyz_pts, scene_bounds)
    filt_idx = np.flatnonzero(mask)
    m = len(filt_idx)
    probs = np.asarray(subsample_probabilities, np.float64)[filt_idx]
    s = probs.sum()
    probs = probs / s if s > 0 else np.full(m, 1.0 / max(m, 1))
    if num_subsample_pts == -1:
        out = {"xyz_pts": native.gather_rows(xyz_pts, filt_idx)}
        for k, v in arrays.items():
            if v is None:
                out[k] = None
            elif v.shape[0] == n:
                out[k] = native.gather_rows(v, filt_idx)
            elif v.ndim > 1 and v.shape[1] == n:
                out[k] = native.gather_axis1(v, filt_idx)
            else:
                raise ValueError(f"{k}: shape {v.shape} vs {n} points")
        return out
    try:
        idx = weighted_sample(rng, probs, num_subsample_pts,
                              replace=always_replace_pts)
    except ValueError:
        idx = weighted_sample(rng, probs, num_subsample_pts, replace=True)
    # compose filter + subsample into ONE gather from the originals: never
    # materialize the ~n-row filtered intermediates (the loader's largest
    # host copies at the 400k-of-1M reference scale)
    rows = filt_idx[idx]
    result = {"xyz_pts": native.gather_rows(xyz_pts, rows)}
    for k, v in arrays.items():
        if v is None:
            result[k] = None
        elif v.shape[0] == n:
            result[k] = native.gather_rows(v, rows)
        elif v.ndim > 1 and v.shape[1] == n:
            result[k] = native.gather_axis1(v, rows)
        else:
            raise ValueError(f"{k}: shape {v.shape} vs {n} points")
    return result


def compute_empty_mask(scene_bounds, depth_img, intrinsic_matrix,
                       extrinsic_matrix, voxel_resolution: int = 20) -> np.ndarray:
    """Coarse free-space mask: a voxel is 'empty' unless some pixel observed
    past it (reference point_cloud.py:173-242, minus its debug plotting).
    Returns a (v, v, v) bool grid."""
    sb = np.asarray(scene_bounds, np.float64)
    grid_shape = (voxel_resolution,) * 3
    axes = [np.arange(d) for d in grid_shape]
    idxs = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    scales = (sb[1] - sb[0]) / (np.asarray(grid_shape) - 1)
    pts = idxs * scales + sb[0]
    inv = np.linalg.inv(np.asarray(extrinsic_matrix, np.float64))
    cam = pts @ inv[:3, :3].T + inv[:3, 3]
    z = cam[:, 2]
    safe_z = np.where(z == 0, 1e-12, z)
    intr = np.asarray(intrinsic_matrix, np.float64)
    px = np.round(cam[:, 0] * intr[0, 0] / safe_z + intr[0, 2]).astype(int)
    py = np.round(cam[:, 1] * intr[1, 1] / safe_z + intr[1, 2]).astype(int)
    w, h = depth_img.shape  # reference quirk: im_w, im_h = depth.shape
    valid = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    mask = np.ones(grid_shape, bool)
    observed = valid.copy()
    observed[valid] = depth_img[py[valid], px[valid]] > z[valid]
    obs_idx = idxs[observed]
    mask[obs_idx[:, 0], obs_idx[:, 1], obs_idx[:, 2]] = False
    return mask


def balanced_class_subsample(seg_pts: np.ndarray, num_pts: int,
                             rng: np.random.RandomState,
                             balanced: bool = True) -> np.ndarray:
    """Per-class balanced index subsample (reference point_cloud.py:245-258)."""
    probs = np.ones(seg_pts.shape, np.float64)
    if balanced:
        uniq = np.unique(seg_pts)
        for sid in uniq:
            m = seg_pts == sid
            probs[m] = 1.0 / (m.sum() * len(uniq))
    else:
        probs /= probs.sum()
    probs /= probs.sum()
    return weighted_sample(rng, probs, num_pts, replace=False)


def resize_bilinear_np(maps: np.ndarray, out_hw) -> np.ndarray:
    """(..., H, W) bilinear resize, torch align_corners=False weights
    (shares the verified resize-matrix kernel with the device path)."""
    from ..ops.sampling import resize_matrix

    h, w = maps.shape[-2], maps.shape[-1]
    rm = np.asarray(resize_matrix(h, out_hw[0], "bilinear_torch"),
                    maps.dtype if maps.dtype == np.float64 else np.float32)
    cm = np.asarray(resize_matrix(w, out_hw[1], "bilinear_torch"),
                    rm.dtype)
    # two BLAS matmuls (np.einsum's c_einsum path is ~8x slower here):
    # rows: (..., H, W) -> (..., H', W) via rm @ maps over the H axis
    lead = maps.shape[:-2]
    m = np.ascontiguousarray(maps, rm.dtype).reshape(-1, h, w)
    out = np.matmul(rm[None], m)            # (B, H', W)
    out = np.matmul(out, cm.T[None])        # (B, H', W')
    return out.reshape(lead + (out_hw[0], out_hw[1]))


def resize_nearest_exact_np(maps: np.ndarray, out_hw) -> np.ndarray:
    """(..., H, W) nearest-exact resize, matching torch
    ``F.interpolate(mode="nearest-exact")``: src = floor((dst+0.5)*in/out),
    clamped. The reference stores relevancies downsampled this way
    (generate_relevancy.py:96-104)."""
    h, w = maps.shape[-2], maps.shape[-1]
    ri = np.minimum(
        ((np.arange(out_hw[0]) + 0.5) * (h / out_hw[0])).astype(np.int64), h - 1
    )
    ci = np.minimum(
        ((np.arange(out_hw[1]) + 0.5) * (w / out_hw[1])).astype(np.int64), w - 1
    )
    return maps[..., ri[:, None], ci[None, :]]


def balanced_subsample_probabilities(labels_row: np.ndarray) -> np.ndarray:
    """Per-patch positive/negative balancing weights
    (reference dataset.py:903-935)."""
    n = len(labels_row)
    p = np.ones(n, np.float64)
    pos = labels_row.astype(bool)
    if pos.any() and not pos.all():
        p[pos] = n / pos.sum()
        p[~pos] = n / (~pos).sum()
    return p / p.sum()
