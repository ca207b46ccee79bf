"""Deterministic synthetic data pipeline.

Produces reproducible token streams (and stub modality embeddings) keyed by
(seed, step) — the same global batch regardless of mesh shape, so loss
curves are comparable across decompositions (paper Fig. 6 methodology: the
parallelization must not change statistical efficiency).

Two text generators:
  * ``zipf``: unigram Zipf draw (fast, for throughput tests)
  * ``markov``: a fixed random bigram chain — *learnable* structure so
    smoke/validation losses actually descend like Fig. 6's curves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"      # "markov" | "zipf"
    n_states: int = 64        # markov chain order-1 state count


class SyntheticText:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        k = min(cfg.n_states, v)
        # sparse-ish bigram transition over k "hub" tokens mixed with tail
        self._hubs = rng.choice(v, size=k, replace=False)
        self._trans = rng.dirichlet(np.ones(k) * 0.3, size=k)
        self._start = rng.dirichlet(np.ones(k))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step)
                                    % (2 ** 31 - 1))
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.kind == "zipf":
            toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
            toks = (toks % cfg.vocab_size).astype(np.int32)
        else:
            k = len(self._hubs)
            states = np.empty((B, S + 1), np.int32)
            states[:, 0] = rng.choice(k, size=B, p=self._start)
            u = rng.random_sample((B, S))
            cum = np.cumsum(self._trans, axis=1)
            for t in range(S):
                states[:, t + 1] = (
                    cum[states[:, t]] > u[:, t:t + 1]).argmax(axis=1)
            toks = self._hubs[states].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def stub_frames(step: int, batch: int, n_ctx: int, dim: int,
                seed: int = 7) -> np.ndarray:
    """Deterministic stand-in for the audio conv / vision ViT frontend
    (the assignment's one allowed stub)."""
    rng = np.random.RandomState((seed * 999_983 + step) % (2 ** 31 - 1))
    return rng.randn(batch, n_ctx, dim).astype(np.float32)


def make_batch(cfg_arch, step: int, data: SyntheticText,
               dtype=np.float32) -> Dict[str, np.ndarray]:
    """Full batch for an architecture (adds stub modality inputs)."""
    b = data.batch(step)
    if cfg_arch.arch_type == "vlm":
        ec = cfg_arch.encoder
        b["image_embeds"] = stub_frames(step, data.cfg.global_batch,
                                        ec.n_ctx, ec.input_dim).astype(dtype)
    if cfg_arch.arch_type == "audio":
        ec = cfg_arch.encoder
        b["frames"] = stub_frames(step, data.cfg.global_batch, ec.n_ctx,
                                  cfg_arch.d_model).astype(dtype)
    return b
