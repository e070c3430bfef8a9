"""The device-resident OVSSC batches: a pool of distinct B-row batches in
the loader's layout, made on the device from the seed.

Each row holds ``parts`` patches: input points uniform over (and past) the
scene bounds with one saliency feature each, and for every patch its
query points, their 0/1 labels, the out-of-bounds mask the dataset gives
(queries outside the bounds) and an out-of-frustum mask drawn at
``frustum_drop``."""
from __future__ import annotations

from typing import Dict, List

import torch


def pool(seed: int, t: dict, c: dict, device) -> List[Dict[str, torch.Tensor]]:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + 1) % (2**63))
    b, p, n, m = t["batch_size"], c["num_patches"], c["num_input_pts"], c["num_output_pts"]
    lo = torch.tensor(c["scene_bounds"][0], device=device)
    hi = torch.tensor(c["scene_bounds"][1], device=device)
    span = t["point_spread"]
    out = []
    for _ in range(t["pool"]):
        def pts(*shape):
            u = torch.rand(*shape, 3, generator=g, device=device)
            return lo + (u * (1 + 2 * span) - span) * (hi - lo)

        q = pts(b, p, m)
        out.append({
            "input_xyz_pts": pts(b, n),
            "input_feature_pts": torch.randn(b, p, n, 1, generator=g, device=device),
            "output_xyz_pts": q,
            "output_label_pts": (torch.rand(b, p, m, generator=g, device=device) < 0.5
                                 ).to(torch.uint8),
            "out_of_bounds_pts": ((q < lo) | (q > hi)).any(-1),
            "out_of_frustum_pts_mask": torch.rand(b, p, m, generator=g, device=device)
            < t["frustum_drop"],
            "padding_mask": torch.zeros(b, p, dtype=torch.bool, device=device),
        })
    return out
