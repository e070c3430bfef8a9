"""Requests of the relevancy cells: one new uint8 RGB image a request and
the seed of its jitter draws, both from (run seed, request index)."""
from __future__ import annotations

import numpy as np

# a stream of seeds per purpose, so that no two draw from one another's
STREAM_IMAGE, STREAM_JITTER = 1, 2


def _seed_words(seed: int, stream: int, index: int):
    return [int(seed) % (2**64), stream, int(index)]


def image(seed: int, index: int, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 noise, a new image for every (seed, index)."""
    rng = np.random.default_rng(_seed_words(seed, STREAM_IMAGE, index))
    return rng.integers(0, 256, (height, width, 3), dtype=np.uint8)


def jitter_seed(seed: int, index: int) -> int:
    """The seed of request ``index``'s jitter generator (below 2**63)."""
    ss = np.random.SeedSequence(_seed_words(seed, STREAM_JITTER, index))
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def sample(seed: int, done: int, k: int) -> list:
    """``k`` of the ``done`` finished requests, drawn from the seed; the
    last request is always among them."""
    if done == 0:
        return []
    rng = np.random.default_rng(_seed_words(seed, 3, done))
    rest = rng.permutation(done - 1)[:max(k - 1, 0)].tolist()
    return sorted(set(rest + [done - 1]))
