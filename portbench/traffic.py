"""The one generator of training traffic, driven by a traffic file.

Token ids follow a Zipf law of the file's exponent over the vocabulary
(natural text's rank-frequency law, so the embedding's backward meets the
duplicate ids that text gives it), ranks mapped to ids by a permutation
drawn from the seed.  An ``mlm`` mix masks exactly ``mask_rate`` of each
row's positions (BERT's 15%), drawn from the seed.  Batch ``step`` depends
on ``(seed, step)`` only: the same seed gives the same batches, and every
seed the same shapes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *words])


class Traffic:
    def __init__(self, spec: dict, vocab: int, seed: int):
        tokens = spec["tokens"]
        if tokens["law"] != "zipf":
            raise ValueError(f"unknown token law {tokens['law']!r}")
        self.spec, self.seed = spec, seed
        self.batch_size, self.seq_len = spec["batch_size"], spec["seq_len"]
        weights = np.arange(1, vocab + 1, dtype=np.float64) ** -tokens["exponent"]
        self.cdf = np.cumsum(weights) / weights.sum()
        self.ids_of_rank = _rng(seed, 0xC0DE).permutation(vocab).astype(np.int32)
        self.mask_rate = spec.get("mask_rate")

    def batch(self, step: int) -> Tuple[np.ndarray, ...]:
        """``(ids,)`` int32 ``[b, s]``, or for a masked mix ``(ids, mask)``
        with the mask float32, 1.0 where the position is predicted."""
        rng = _rng(self.seed, 1, step)
        shape = (self.batch_size, self.seq_len)
        u = rng.random(shape)
        ranks = np.minimum(np.searchsorted(self.cdf, u, side="right"),
                           len(self.cdf) - 1)
        ids = self.ids_of_rank[ranks]
        if self.mask_rate is None:
            return (ids,)
        k = int(round(self.mask_rate * self.seq_len))
        order = np.argsort(rng.random(shape), axis=1)[:, :k]
        mask = np.zeros(shape, np.float32)
        np.put_along_axis(mask, order, 1.0, axis=1)
        return ids, mask
