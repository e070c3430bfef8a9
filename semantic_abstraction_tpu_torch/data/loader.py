"""Batching + prefetching loader, numpy only.

A copy of ``semantic_abstraction_tpu/data/loader.py`` for the port, with
the same semantics: which samples form a batch, the ``_sample_pad`` flags of
wrap-padded duplicates, the static-shape padding of ragged eval samples and
the bounded in-flight window decide which rows a loss or a metric sees, so
they stay the JAX package's.

Replaces the reference's torch DataLoader(num_workers=8, persistent) +
DistributedSampler stack (reference: utils.py:506-520, eval.py:57-59).

- ``collate``: stacks numpy samples BATCH-MAJOR (string fields become
  lists-of-per-sample-values; the reference's torch collate transposes
  string lists patch-major, forcing ``np.array(...).T`` gymnastics at
  every use site — we keep batch-major and document it).
- ``ShardedSampler``: deterministic per-epoch shuffling + per-host
  sharding (the DistributedSampler equivalent for multi-host meshes).
- ``DataLoader``: a thread-pool prefetcher. HDF5 gzip decode and numpy
  subsampling release the GIL for the heavy parts; thread workers avoid
  fork+h5py pitfalls while overlapping host decode with device steps.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: List[dict]) -> Dict[str, object]:
    """Stack a list of sample dicts into one batch dict (batch-major)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


# Static-shape padding rules for batched/sharded evaluation. The reference
# sidesteps ragged eval samples (return_vis -> un-subsampled points,
# dataset.py:603,:1010) by forcing batch 1 per rank (eval.py:54-66); on TPU
# the batch axis is sharded over the mesh, so samples in a batch are padded
# to a common (bucketed) shape instead. Padded mask rows are True and the
# group axis is padding_mask'd, so losses/metrics ignore every padded
# element exactly like reference patch padding (dataset.py:1124-1130).
_PAD_VALUES = {
    "out_of_bounds_pts": True,
    "out_of_frustum_pts_mask": True,
    "padding_mask": True,
    "spatial_relation_id": 6,  # RELATIONS.index("[pad]")
}
_PAD_STRINGS = {
    "patch_labels": "",
    "spatial_relation_name": "[pad]",
    "target_obj_name": "",
    "reference_obj_name": "",
}
# keys whose axis-1 is the (raggedest) output-point axis, bucketed to bound
# XLA recompiles across batches
_POINT_AXIS_KEYS = (
    "output_xyz_pts", "output_label_pts", "out_of_bounds_pts",
    "out_of_frustum_pts_mask",
)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def collate_padded(samples: List[dict], point_bucket: int = 2048) -> Dict[str, object]:
    """Collate with per-key padding to the per-dimension max across the
    batch (point axes rounded up to ``point_bucket``)."""
    out = {}
    point_max = 0
    for k in _POINT_AXIS_KEYS:
        if k in samples[0] and samples[0][k].ndim >= 2:
            point_max = max(
                point_max, max(s[k].shape[1] for s in samples)
            )
    point_dim = _round_up(point_max, point_bucket) if point_max else 0
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            nd = vals[0].ndim
            target = [max(v.shape[d] for v in vals) for d in range(nd)]
            if k in _POINT_AXIS_KEYS and nd >= 2:
                target[1] = point_dim
            fill = _PAD_VALUES.get(k, 0)
            padded = []
            for v in vals:
                pads = [(0, t - s) for t, s in zip(target, v.shape)]
                if any(p[1] for p in pads):
                    v = np.pad(v, pads, constant_values=fill)
                padded.append(v)
            out[k] = np.stack(padded)
        elif isinstance(vals[0], list) and k in _PAD_STRINGS:
            width = max(len(v) for v in vals)
            out[k] = [
                list(v) + [_PAD_STRINGS[k]] * (width - len(v)) for v in vals
            ]
        else:
            out[k] = vals
    return out


class ShardedSampler:
    """Deterministic per-epoch shuffled index sharding
    (reference DistributedSampler semantics, utils.py:506-512)."""

    def __init__(self, num_samples: int, num_shards: int = 1, shard_id: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.num_samples = num_samples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        return self.indices_with_pad()[0]

    def indices_with_pad(self):
        """(indices, is_pad) for this shard; ``is_pad`` flags the cyclic
        wrap-pad duplicates appended to equalize shard sizes, so eval can
        NaN them out and sharded stats match a single-device run exactly
        (the torch DistributedSampler silently double-counts these)."""
        idx = np.arange(self.num_samples)
        if self.shuffle:
            # bounded like datasets.py's per-sample RNG — RandomState
            # rejects seeds >= 2**32, and date-style --seed values are big
            rng = np.random.RandomState((self.seed * 7919 + self.epoch)
                                        % (2**31))
            rng.shuffle(idx)
        is_pad = np.zeros(len(idx), bool)
        if self.drop_last:
            usable = (len(idx) // self.num_shards) * self.num_shards
            idx, is_pad = idx[:usable], is_pad[:usable]
        else:
            pad = (-len(idx)) % self.num_shards
            if pad and len(idx):  # cyclic tiling (np.resize of an EMPTY
                # array fabricates zeros — an empty dataset keeps empty
                # shards instead of inventing index 0)
                idx = np.concatenate([idx, np.resize(idx, pad)])
                is_pad = np.concatenate([is_pad, np.ones(pad, bool)])
        return (idx[self.shard_id :: self.num_shards],
                is_pad[self.shard_id :: self.num_shards])


class DataLoader:
    """Thread-prefetched batched iterator over a dataset."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4,
                 sampler: Optional[ShardedSampler] = None, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = False,
                 pad_to_full_batches: bool = False,
                 pad_static_shapes: bool = False, point_bucket: int = 2048):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)
        self.sampler = sampler or ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed
        )
        self.prefetch = prefetch
        self.drop_last = drop_last
        # wrap-pad the index list so every batch is FULL (required when the
        # batch axis is sharded over a device mesh — XLA shapes are static).
        # DistributedSampler pads the same way (reference utils.py:506-512);
        # unlike it, the duplicated samples are FLAGGED: each batch carries a
        # "_sample_pad" bool array so eval can NaN the duplicate rows and
        # sharded stats match single-device exactly.
        self.pad_to_full_batches = pad_to_full_batches
        # ragged samples (return_vis eval) padded to a common bucketed
        # shape so the batch axis can shard over a mesh (see collate_padded)
        self.pad_static_shapes = pad_static_shapes
        self.point_bucket = point_bucket

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler.indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[np.ndarray]:
        idx, sampler_pad = self.sampler.indices_with_pad()
        n_real = len(idx)
        if self.pad_to_full_batches and not self.drop_last:
            pad = (-n_real) % self.batch_size
            if pad and n_real:  # cyclic tiling: pad may exceed the count
                idx = np.concatenate([idx, np.resize(idx, pad)])
                sampler_pad = np.concatenate(
                    [sampler_pad, np.ones(pad, bool)]
                )
        nb = len(idx) // self.batch_size if self.drop_last else (
            (len(idx) + self.batch_size - 1) // self.batch_size
        )
        out = []
        for i in range(nb):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            # padding = loader-level wrap-pad OR the sampler's own
            # shard-equalizing duplicates
            out.append((idx[sl], sampler_pad[sl].copy()))
        return out

    def _load(self, b) -> dict:
        idxs, is_pad = b
        samples = [self.dataset[int(i)] for i in idxs]
        if self.pad_static_shapes:
            batch = collate_padded(samples, self.point_bucket)
        else:
            batch = collate(samples)
        if self.pad_to_full_batches or is_pad.any():
            # the sampler's own shard-equalizing duplicates must surface
            # even without loader-level wrap-padding, or eval would count
            # the duplicated scene twice
            batch["_sample_pad"] = is_pad
        return batch

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                yield self._load(b)
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        # Bounded in-flight WINDOW (num_workers running + prefetch done
        # but unconsumed), driven synchronously by the consumer: one new
        # submit per consumed batch. The earlier design submitted the
        # whole epoch upfront and forwarded through a producer thread —
        # workers ran arbitrarily far ahead (the completed futures pinned
        # every batch of the epoch in memory) and an early `break` left
        # the producer parked in q.put forever while the pool kept
        # decoding the rest of the epoch. Here a break/exception lands in
        # the finally: queued work is cancelled and at most num_workers
        # in-flight loads finish before the pool's threads exit.
        window = self.num_workers + max(1, self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        pending = deque()
        it = iter(batches)
        try:
            for b in it:
                pending.append(pool.submit(self._load, b))
                if len(pending) >= window:
                    break
            while pending:
                out = pending.popleft().result()  # worker errors re-raise
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield out
                del out  # release before blocking on the next result
        finally:
            while pending:
                pending.popleft().cancel()
            pool.shutdown(wait=False, cancel_futures=True)
