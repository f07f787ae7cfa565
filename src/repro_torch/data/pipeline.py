"""Deterministic, resumable synthetic token pipeline.

Batch content is a pure function of ``(seed, step)``, so a restarted job
resumes mid-epoch by setting the step: no iterator state to checkpoint and
no skipped or duplicated batches.  The tokens are the reference package's
``data/pipeline.py`` stream byte for byte (the same numpy generator calls
in the same order), returned as an int32 tensor on the CPU.

The generator synthesizes structured sequences (Zipf-like unigrams and a
Markov chain over a small state machine), so a model's cross-entropy can
decrease during training, which uniform tokens would not allow.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_codebooks: int = 0           # musicgen-style multi-codebook streams


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed Markov transition table: each token prefers a small successor set
        self._succ = base.integers(0, v, (min(v, 4096), 4))

    def batch(self, step: int) -> dict:
        """Batch for a given step: a pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
        # Zipf-ish marginal via exponential rank sampling
        ranks = rng.exponential(scale=cfg.vocab_size / 8, size=shape)
        tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int64)
        # overlay Markov structure along the sequence axis
        m = self._succ.shape[0]
        pick = rng.integers(0, 4, shape)
        if cfg.n_codebooks:
            for q in range(cfg.n_codebooks):
                t = tokens[..., q]          # a view: writes land in tokens
                t[:, 1:] = np.where(rng.random((b, s - 1)) < 0.7,
                                    self._succ[t[:, :-1] % m, pick[:, 1:, q]] % cfg.vocab_size,
                                    t[:, 1:])
        else:
            tokens[:, 1:] = np.where(rng.random((b, s - 1)) < 0.7,
                                     self._succ[tokens[:, :-1] % m, pick[:, 1:]] % cfg.vocab_size,
                                     tokens[:, 1:])
        return {"tokens": torch.from_numpy(tokens.astype(np.int32))}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
