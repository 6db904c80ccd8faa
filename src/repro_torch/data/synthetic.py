"""Deterministic synthetic corpus: a topic-conditioned Zipfian Markov
language.

Design goals:
  * fully deterministic from (seed, step, global_row) — a restarted or
    re-sharded job regenerates exactly the same global batch (elastic
    data parallelism without a persisted dataloader state);
  * learnable structure at several ranges so compression quality differences
    are measurable: local bigram structure (affine successor maps), a slowly
    mixing latent *topic* (long-range signal that deepens middle-layer
    information density — the U-shape the paper leans on), and a Zipfian
    unigram floor;
  * O(1) memory — no corpus on disk.

Generative process per token:
  with prob alpha:  t' = (a_j * t + c_j + topic * d) mod V,  j ~ U{0..branch-1}
  else:             t' ~ Zipf(V)
  topic flips to a fresh uniform draw with prob topic_flip per step.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4
    alpha: float = 0.85
    n_topics: int = 8
    topic_flip: float = 0.02
    zipf_s: float = 1.2


class SyntheticLM:
    """Vectorized generator. All randomness is counter-based: the stream for
    (step, row) is seeded independently, so sharding/elasticity never change
    the data."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        g = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branch
        # affine successor maps (odd multipliers -> bijections mod V)
        self.mult = (g.integers(1, V, size=B) | 1).astype(np.int64)
        self.add = g.integers(0, V, size=B).astype(np.int64)
        self.topic_shift = g.integers(0, V, size=cfg.n_topics).astype(np.int64)
        # zipf pmf over ranks, fixed permutation rank -> token id
        ranks = np.arange(1, V + 1, dtype=np.float64)
        pmf = ranks ** (-cfg.zipf_s)
        self.zipf_cdf = np.cumsum(pmf / pmf.sum())
        self.perm = g.permutation(V)

    def _zipf(self, rng: np.random.Generator, n: int) -> np.ndarray:
        u = rng.random(n)
        r = np.searchsorted(self.zipf_cdf, u)
        return self.perm[np.minimum(r, self.cfg.vocab_size - 1)]

    def sample_rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Generate tokens (len(rows), seq_len) for the given global rows of
        the given step. Deterministic in (seed, step, row)."""
        cfg = self.cfg
        n, S, V = len(rows), cfg.seq_len, cfg.vocab_size
        out = np.empty((n, S), dtype=np.int32)
        # one independent counter-based stream per row
        seeds = [np.random.SeedSequence(
            entropy=(cfg.seed, 0x5D7A, step, int(r))) for r in rows]
        rngs = [np.random.default_rng(s) for s in seeds]
        for i, rng in enumerate(rngs):
            t = int(self._zipf(rng, 1)[0])
            topic = int(rng.integers(cfg.n_topics))
            u_branch = rng.integers(0, cfg.branch, size=S)
            u_mix = rng.random(S)
            u_flip = rng.random(S)
            zipf_draws = self._zipf(rng, S)
            new_topics = rng.integers(0, cfg.n_topics, size=S)
            row = out[i]
            for s in range(S):
                if u_flip[s] < cfg.topic_flip:
                    topic = int(new_topics[s])
                if u_mix[s] < cfg.alpha:
                    j = u_branch[s]
                    t = int((self.mult[j] * t + self.add[j]
                             + self.topic_shift[topic]) % V)
                else:
                    t = int(zipf_draws[s])
                row[s] = t
        return out

    # -- entropy floor estimate (for experiment reporting) ------------------
    def entropy_floor(self, n_rows: int = 64, step: int = 10 ** 6) -> float:
        """Monte-Carlo estimate of the per-token conditional entropy (nats)
        of the generative process — the minimum achievable loss."""
        cfg = self.cfg
        # H = alpha*log(branch-ish) + (1-alpha)*H(zipf) + topic noise; do it
        # empirically via the known mixture:
        pmf = np.diff(np.concatenate([[0.0], self.zipf_cdf]))
        h_zipf = float(-(pmf * np.log(np.maximum(pmf, 1e-300))).sum())
        # successor branch: branch equally likely affine maps (distinct
        # targets w.h.p.) -> log(branch); mixture entropy approximation:
        a = cfg.alpha
        h = (a * np.log(cfg.branch) + (1 - a) * h_zipf
             + cfg.topic_flip * np.log(cfg.n_topics))
        return float(h)


class ShardedLoader:
    """Deterministic, elastic DP loader.

    Shard `shard_id`/`num_shards` of step s yields global rows
    [shard_id * B/num_shards, ...) — data depends only on (seed, step, row),
    so checkpoint-restart on a different DP size replays identically.
    """

    def __init__(self, cfg: DataConfig, shard_id: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0, \
            (cfg.global_batch, num_shards)
        self.cfg = cfg
        self.lm = SyntheticLM(cfg)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def rows_for(self, step: int) -> np.ndarray:
        lo = self.shard_id * self.local_batch
        return np.arange(lo, lo + self.local_batch)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        tokens = self.lm.sample_rows(step, self.rows_for(step))
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def calibration_batches(cfg: DataConfig, n_samples: int, batch_size: int,
                        calib_seed: int = 10_001):
    """The paper's calibration set: `n_samples` sequences (seed-disjoint
    from training steps via a huge step offset)."""
    lm = SyntheticLM(dataclasses.replace(cfg, seed=cfg.seed))
    out = []
    for i in range(0, n_samples, batch_size):
        rows = np.arange(i, min(i + batch_size, n_samples))
        out.append({"tokens": lm.sample_rows(calib_seed, rows)})
    return out
