"""Debug plots on the host (matplotlib, imported where a plot is drawn).

A copy of ``semantic_abstraction_tpu/ops/plot_utils.py`` for the port.

Replacements for the reference's plot_utils.py (plot_pointcloud :26-137,
view_tsdf :155-190) and visualize.py's relevancy grid. open3d is not a
dependency, so ``view_tsdf`` renders the marching-tetrahedra mesh with
matplotlib instead of an interactive open3d window.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def plot_pointcloud(
    xyz_pts: np.ndarray,
    rgb_pts: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    label_names: Optional[Dict[int, str]] = None,
    max_pts: int = 20000,
    view: tuple = (25, -130),
    save_path: Optional[str] = None,
):
    """3D scatter with optional per-class legend (reference
    plot_utils.py:26-137)."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz_pts = np.asarray(xyz_pts)
    if len(xyz_pts) > max_pts:
        idx = np.random.RandomState(0).choice(len(xyz_pts), max_pts, replace=False)
        xyz_pts = xyz_pts[idx]
        rgb_pts = rgb_pts[idx] if rgb_pts is not None else None
        labels = labels[idx] if labels is not None else None
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.view_init(*view)
    if labels is not None:
        for lab in np.unique(labels):
            m = labels == lab
            name = (label_names or {}).get(int(lab), str(lab))
            ax.scatter(xyz_pts[m, 0], xyz_pts[m, 1], xyz_pts[m, 2], s=1, label=name)
        ax.legend(loc="upper left", fontsize=6)
    else:
        colors = None
        if rgb_pts is not None:
            colors = np.clip(np.asarray(rgb_pts, np.float32), 0, 255)
            if colors.max() > 1.5:
                colors = colors / 255.0
        ax.scatter(xyz_pts[:, 0], xyz_pts[:, 1], xyz_pts[:, 2], s=1, c=colors)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        return save_path
    return fig


def view_tsdf(tsdf_vol: np.ndarray, save_path: Optional[str] = None):
    """Render the TSDF zero-surface (reference plot_utils.py:155-190
    used open3d; here: marching tetrahedra + matplotlib trisurf)."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .marching import marching_tetrahedra

    verts, faces = marching_tetrahedra(np.asarray(tsdf_vol), level=0.0)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    if len(verts):
        ax.plot_trisurf(
            verts[:, 0], verts[:, 1], faces, verts[:, 2],
            cmap="viridis", linewidth=0.1,
        )
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        return save_path
    return fig


def visualize_relevancies(
    rgb: np.ndarray,
    relevancies: np.ndarray,
    obj_classes: Sequence[str],
    dump_path: str,
    vmin: float = 0.002,
    vmax: float = 0.008,
):
    """Jet-overlay grid of per-label relevancy maps
    (reference generate_relevancy.py:434-450 / visualize.py usage)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(obj_classes)
    rows = int(np.ceil(np.sqrt(n)))
    cols = int(np.ceil(n / rows))
    fig, axes = plt.subplots(rows, cols, squeeze=False)
    cmap = plt.get_cmap("jet")
    for ax in axes.flatten():
        ax.axis("off")
    for ax, rel, label in zip(axes.flatten(), relevancies, obj_classes):
        ax.imshow(rgb)
        ax.set_title(label, fontsize=8)
        g = np.clip((rel - vmin) / (vmax - vmin), 0.0, 1.0)
        colored = cmap(g)
        colored[..., -1] = (1 - g) * 0.7
        ax.imshow(colored)
    plt.tight_layout(pad=0)
    fig.savefig(dump_path, dpi=150)
    plt.close(fig)
    return dump_path
