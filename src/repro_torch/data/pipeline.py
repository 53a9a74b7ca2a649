"""Deterministic, elastically-shardable data pipeline.

Every batch is a pure function of (seed, step, dp_rank, dp_size): restarts
replay exactly, and an elastic resize (new dp_size) re-partitions the same
global token stream without skips or repeats — the fault-tolerance story
(DESIGN.md §4) depends on this determinism.

The synthetic LM stream is a mixture of Zipf-distributed tokens with
Markov bigram structure, so small-model training shows a real, monotonic
loss drop.

The port keeps its own copy of ``repro.data.pipeline`` (which needs only
numpy) and draws the same numbers in the same order, so every batch is
bit-identical to the reference's.  That includes the bigram table's
``min(v, 4096)`` rows, which every vocabulary above 4096 reaches through
``cur % 4096``.  One draw is the port's own: the Zipf token, which the
reference takes from ``Generator.zipf``, whose algorithm numpy changed in
2.1 (the same seed gives other tokens there).  ``_zipf`` draws it from
the generator's uniforms by the algorithm of numpy 2.0 and earlier, so a
batch is the same under every numpy, and the reference's under numpy
2.0.  Batches stay host numpy int64 arrays, as in the reference; the
caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator

import numpy as np

# the largest int64 as a double, numpy's bound on a Zipf draw
_RAND_INT_MAX = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float) -> int:
    """One Zipf(``a``) draw by numpy 2.0's ``random_zipf`` (a rejection
    loop on two uniform doubles a try), draw for draw what
    ``rng.zipf(a)`` gives under numpy 2.0 and earlier.  numpy 2.1 maps the
    first uniform onto (U_min, 1] in place of (0, 1], so its draws differ
    from these once they are large."""
    if not a > 1.0:
        raise ValueError("a <= 1")
    am1 = a - 1.0
    b = 2.0 ** am1
    while True:
        u = 1.0 - rng.random()
        v = rng.random()
        try:
            x = float(math.floor(u ** (-1.0 / am1)))
        except OverflowError:         # beyond any int64: rejected
            continue
        if x > _RAND_INT_MAX or x < 1.0:
            continue
        t = (1.0 + 1.0 / x) ** am1
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            return int(x)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random bigram successor table: next = table[cur, digit]
        self._succ = rng.integers(0, v, size=(min(v, 4096), 8),
                                  dtype=np.int64)

    def _sample_seq(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        v = cfg.vocab_size
        out = np.empty(cfg.seq_len, np.int64)
        cur = int(rng.integers(0, min(v, 4096)))
        for t in range(cfg.seq_len):
            if rng.random() < 0.75:       # predictable bigram transition
                cur = int(self._succ[cur % 4096, int(rng.integers(0, 8))])
            else:                          # zipf "noise" token
                cur = int(min(_zipf(rng, cfg.zipf_a), v - 1))
            out[t] = cur % v
        return out

    def _sample(self, step: int, i: int) -> np.ndarray:
        """Global sample ``i`` of ``step``: its own generator, so any
        shard reads it alike."""
        rng = np.random.default_rng((self.cfg.seed, step, i, 0x5DEECE66D))
        return self._sample_seq(rng)

    def global_batch_at(self, step: int) -> np.ndarray:
        """The full global batch for a step — identical regardless of the
        number of data shards reading it."""
        return np.stack([self._sample(step, i)
                         for i in range(self.cfg.global_batch)])

    def shard_at(self, step: int, dp_rank: int, dp_size: int) -> np.ndarray:
        cfg = self.cfg
        assert cfg.global_batch % dp_size == 0
        per = cfg.global_batch // dp_size
        return np.stack([self._sample(step, dp_rank * per + j)
                         for j in range(per)])


def make_batch_iterator(cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1,
                        start_step: int = 0) -> Iterator[Dict]:
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield {"tokens": ds.shard_at(step, dp_rank, dp_size)}
        step += 1
