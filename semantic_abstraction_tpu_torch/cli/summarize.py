"""Summarize eval-stat pickles into the paper tables.

A copy of ``semantic_abstraction_tpu/cli/summarize.py`` for the port
(host-side pandas, so it runs where pandas is installed; it reads the
``<ckpt>_eval_stats.pkl`` files of either package's eval CLI).
Reference: summarize.py:14-268. Pure host pandas/rich; reproduces the
OVSSC THOR, FULL VOOL THOR and OVSSC NYU tables, with best-cutoff-per-
approach selection and the novel room / visual / vocab / class split
masks.

  python -m semantic_abstraction_tpu_torch.cli.summarize \
      [--models-dir models] [--table ovssc|vool|nyu|all]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data.datasets import SYNONYMS

# novel-class split definition (reference test_semantic_classes.txt)
TEST_SEMANTIC_CLASSES = {
    "pot", "mug", "safe", "teddy bear", "basket ball", "wine bottle",
}

NYU_CLASSES = [
    "ceiling", "floor", "wall", "window", "chair", "bed", "sofa", "table",
    "tvs", "furn", "objs",
]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _room_id(scene_id: str) -> int:
    return int(scene_id.split("_")[0].split("FloorPlan")[1])


def _best_cutoff(df, metric):
    return df.groupby("cutoff")[[metric]].mean()[metric].idxmax()


def _nanmean(values) -> float:
    """np.nanmean that returns NaN for empty/all-NaN input WITHOUT the
    "Mean of empty slice" RuntimeWarning — empty split masks are routine
    (e.g. a split file with no unseen_instances_dr scenes), and a silent
    NaN cell is the reference's rendering too."""
    arr = np.asarray(values, dtype=np.float64).ravel()
    arr = arr[~np.isnan(arr)]
    return float(arr.mean()) if arr.size else float("nan")


def summarize_ovssc(approaches: dict, metric="voxel32x32x32_iou"):
    """approaches: name -> detailed-stats DataFrame. Returns a DataFrame
    with novel room/visual/vocab/class columns (reference summarize.py:14-91)."""
    import pandas as pd

    rows = {"approach": [], "novel rooms": [], "novel visual": [],
            "novel vocab": [], "novel class": []}
    for name, df in approaches.items():
        df = df.copy()
        df["room_id"] = df["scene_id"].apply(_room_id)
        df[metric] = df[metric] * 100
        best = _best_cutoff(df, metric)
        df = df[df.cutoff == best]
        novel_class = df.label.isin(TEST_SEMANTIC_CLASSES)
        novel_vocab = df.label.isin(SYNONYMS.values())
        rows["approach"].append(name)
        d = df[(df.split == "unseen_instances") & ~novel_class]
        rows["novel rooms"].append(
            _nanmean(d.groupby("room_id")[metric].mean())
        )
        d = df[(df.split == "unseen_instances_dr") & ~novel_class]
        rows["novel visual"].append(
            _nanmean(d.groupby("room_id")[metric].mean())
        )
        d = df[novel_class]
        rows["novel class"].append(
            _nanmean(d.groupby("label")[metric].mean())
        )
        d = df[(df.split == "unseen_instances_synonyms") & novel_vocab]
        rows["novel vocab"].append(
            _nanmean(d.groupby("label")[metric].mean())
        )
    return pd.DataFrame.from_dict(rows)


def summarize_vool(approaches: dict, metric="voxel32x32x32_iou"):
    """Per-relation table + per-approach mean rows
    (reference summarize.py:94-213)."""
    import pandas as pd

    if not approaches:
        raise ValueError("summarize_vool needs at least one approach")
    rows = {"approach": [], "relation": [], "novel rooms": [],
            "novel visual": [], "novel vocab": [], "novel class": []}
    # relation set comes from the Ours stats like the reference
    # (summarize.py:115), not whichever approach happens to be first
    src = approaches.get("Ours", next(iter(approaches.values())))
    relations = [r for r in src.spatial_relation_name.unique() if r != "[pad]"]
    for name, df0 in approaches.items():
        df0 = df0.copy()
        df0["room_id"] = df0["scene_id"].apply(_room_id)
        best = _best_cutoff(df0, metric)
        df0[metric] = df0[metric] * 100
        for relation in relations:
            df = df0[(df0.cutoff == best) & (df0.spatial_relation_name == relation)]
            novel_vocab = df.target_obj_name.isin(SYNONYMS.values()) | \
                df.reference_obj_name.isin(SYNONYMS.values())
            novel_class = df.target_obj_name.isin(TEST_SEMANTIC_CLASSES) | \
                df.reference_obj_name.isin(TEST_SEMANTIC_CLASSES)
            rows["approach"].append(name)
            rows["relation"].append(relation)
            d = df[(df.split == "unseen_instances") & ~novel_class]
            rows["novel rooms"].append(
                _nanmean(d.groupby("room_id")[metric].mean())
            )
            d = df[(df.split == "unseen_instances_dr") & ~novel_class]
            rows["novel visual"].append(
                _nanmean(d.groupby("room_id")[metric].mean())
            )
            rows["novel class"].append(_nanmean(df[novel_class][metric]))
            d = df[(df.split == "unseen_instances_synonyms") & novel_vocab]
            rows["novel vocab"].append(_nanmean(d[metric]))
    out = pd.DataFrame.from_dict(rows)
    # per-approach mean rows, INTERLEAVED after each approach's relation
    # block like the reference's iloc splice (summarize.py:158-183), with
    # the reference's NaN-PROPAGATING np mean: a missing per-relation cell
    # must surface as a nan mean, not silently shrink the denominator
    blocks = []
    for name in approaches:
        sub = out[out.approach == name]
        mean_row = {
            "approach": name, "relation": "mean",
            **{c: float(np.asarray(sub[c], np.float64).mean())
               for c in ("novel rooms", "novel visual",
                         "novel vocab", "novel class")},
        }
        blocks.append(pd.concat([sub, pd.DataFrame([mean_row])],
                                ignore_index=True))
    return pd.concat(blocks, ignore_index=True)


def summarize_nyu(approaches: dict, metric="voxel60x60x60_iou"):
    """NYU per-class table (reference summarize.py:216-268)."""
    import pandas as pd

    rows = []
    for name, df in approaches.items():
        df = df.copy()
        df[metric] = df[metric] * 100
        best = _best_cutoff(df, metric)
        df = df[df.cutoff == best]
        row = {"approach": name}
        for c in NYU_CLASSES:
            row[c] = df[df.label == c][metric].mean()
        # exclude the "" pad-label group our static-shape eval padding
        # introduces (its metrics are all NaN by construction); the
        # reference eval path has no padded patches (subsample=-1) so its
        # groupby never sees one. The mean itself stays NaN-PROPAGATING
        # over real classes like the reference (summarize.py:259-261).
        lab_means = np.array(
            df[df.label != ""].groupby("label")[metric].mean()
        )
        row["mean"] = float(lab_means.mean()) if lab_means.size else float("nan")
        rows.append(row)
    return pd.DataFrame(rows)


def _print_table(df, title: str, highlight: str = "Ours"):
    try:
        import rich
        from rich.console import Console
        from rich.table import Table

        table = Table(title=title, box=rich.box.MINIMAL_DOUBLE_HEAD)
        for col in df.columns:
            table.add_column(str(col).title(),
                             justify="left" if df[col].dtype == object else "right")
        for _, row in df.iterrows():
            cells = [
                f"{v:.1f}" if isinstance(v, float) else str(v) for v in row
            ]
            table.add_row(
                *cells,
                style="green" if highlight in str(row.iloc[0]) else "white",
            )
        Console().print(table)
    except ImportError:
        print(title)
        print(df.to_string(float_format=lambda v: f"{v:.1f}"))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="summarize")
    parser.add_argument("--models-dir", type=str, default="models")
    parser.add_argument("--table", choices=["ovssc", "vool", "nyu", "all"],
                        default="all")
    args = parser.parse_args(argv)
    m = args.models_dir

    def maybe_load(mapping):
        out = {}
        for name, rel in mapping.items():
            path = os.path.join(m, rel)
            if os.path.exists(path):
                out[name] = _load(path)
        return out

    if args.table in ("ovssc", "all"):
        approaches = maybe_load({
            "Semantic Aware": "semaware/ovssc/ovssc_eval_stats.pkl",
            "SemAbs + [Chefer et al]": "chefer_et_al/ovssc/ovssc_eval_stats.pkl",
            "Ours": "ours/ovssc/ovssc_eval_stats.pkl",
        })
        if approaches:
            _print_table(summarize_ovssc(approaches), "OVSSC THOR")
    if args.table in ("vool", "all"):
        approaches = maybe_load({
            "Semantic Aware": "semaware/vool/vool_eval_stats.pkl",
            "ClipSpatial": "clipspatial/vool/vool_eval_stats.pkl",
            "SemAbs + [Chefer et al]": "chefer_et_al/vool/vool_eval_stats.pkl",
            "Ours": "ours/vool/vool_eval_stats.pkl",
        })
        if approaches:
            _print_table(summarize_vool(approaches), "FULL VOOL THOR")
    if args.table in ("nyu", "all"):
        approaches = maybe_load({
            "Ours (Supervised)":
                "ours/ovssc/ovssc_eval_stats_supervised_nyu_merged.pkl",
            "Ours (Zeroshot)": "ours/ovssc/ovssc_eval_stats_zs_nyu_merged.pkl",
        })
        if approaches:
            _print_table(summarize_nyu(approaches), "OVSSC NYU",
                         highlight="Zeroshot")


if __name__ == "__main__":
    main()
