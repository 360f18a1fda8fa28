"""Deterministic synthetic token pipeline (host-sharded, resumable): the
port's own numpy copy of the reference's ``repro/data/pipeline.py``, giving
bit-identical batches.

Production shape: each host owns a disjoint shard of the global batch
(``host_id``/``n_hosts``), batches are a pure function of (seed, step) so a
restart at step k reproduces the exact stream — the checkpoint only needs to
store the step counter.  The synthetic distribution is a Zipfian unigram
mixture with Markov bigram structure, enough for loss curves to be
meaningfully decreasing (used by the convergence tests and the train
example)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2


class SyntheticLM:
    """tokens[t+1] depends on tokens[t] through a fixed random permutation
    plus Zipf noise — learnable structure with a closed-form entropy gap."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.unigram = p / p.sum()

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) -> one host's batch."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xD0E5))
        B, S = self.host_batch, cfg.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab, size=B, p=self.unigram)
        noise = rng.random((B, S))
        fresh = rng.choice(cfg.vocab, size=(B, S), p=self.unigram)
        for t in range(1, S):
            follow = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t] < 0.75, follow, fresh[:, t])
        labels = np.concatenate(
            [toks[:, 1:], np.zeros((B, 1), np.int32)], axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {"tokens": toks, "labels": labels, "loss_mask": mask}

    def stream(self, start_step: int = 0,
               num_steps: Optional[int] = None) -> Iterator[Dict]:
        step = start_step
        while num_steps is None or step < start_step + num_steps:
            yield self.batch_at(step)
            step += 1
