"""Overdecomposition (paper §4.2): the microbatch split (port of
``repro.core.overdecompose.split_batch``).

The paper splits each tensor group's batch shard into micro-shards whose
compute and communication interleave. The train step loops over them and
accumulates their gradients; on the one-device mesh there is no
communication to overlap, so the split changes only the working set.
"""
from __future__ import annotations

from typing import Dict

import torch


def split_batch(batch: Dict[str, torch.Tensor], n_shards: int, *,
                axes=None) -> Dict[str, torch.Tensor]:
    """Split every leaf of a batch dict along dim 0 into ``n_shards``:
    each leaf (B, ...) becomes (n_shards, B / n_shards, ...). A
    non-dividing shape is reported with the offending leaf and the global
    divisibility rule. ``axes`` (a ``mesh.MeshAxes``) is optional context
    used only to phrase that error in global-batch terms."""
    for name, x in batch.items():
        if not x.dim():
            raise ValueError(
                f"overdecompose={n_shards}: batch leaf {name!r} is a "
                f"scalar — every leaf needs a leading batch dim to split")
        if x.shape[0] % n_shards:
            hint = ""
            if axes is not None:
                bs = axes.batch_shards
                hint = (f" (global batch = {x.shape[0] * bs} over "
                        f"{bs} data×z batch shards; the global batch "
                        f"must be divisible by batch_shards × "
                        f"overdecompose = {bs * n_shards})")
            raise ValueError(
                f"overdecompose={n_shards}: per-shard batch {x.shape[0]} "
                f"of leaf {name!r} is not divisible by the "
                f"overdecomposition factor{hint}")
    return {name: x.reshape(n_shards, x.shape[0] // n_shards, *x.shape[1:])
            for name, x in batch.items()}
