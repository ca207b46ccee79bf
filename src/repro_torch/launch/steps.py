"""Model init and the paged serving step (port of the serving part of
``repro.launch.steps``).

PyTorch runs eagerly, so where the JAX package builds a jitted,
shard_map'ped step, ``make_paged_step`` only binds the configuration and
returns the step with the shapes of the caches it needs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mesh as M
from repro_torch.models import decoder as D
from repro_torch.models.base import ArchConfig


def resolve_device(device="cuda") -> torch.device:
    """The device the entry points run on: the card unless the caller asks
    for the CPU. Raises when a CUDA device is asked for and there is none.
    Float32 stays float32 on the card: TF32 is switched off for matrix
    products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def init_model(cfg: ArchConfig, axes: Optional[M.MeshAxes] = None,
               seed: int = 0, *, device="cuda",
               dtype=torch.float32) -> D.Decoder:
    """Random weights from ``seed``, drawn on ``device`` from the JAX
    package's distributions (N(0, 1/k) projections, N(0, 0.02^2)
    embedding, unit norms). The values differ from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return D.Decoder(cfg, axes or M.MeshAxes(), gen=gen, dtype=dtype)


def make_paged_step(cfg: ArchConfig, axes: M.MeshAxes, *,
                    dtype=torch.float32):
    """``build(n_pages, page_size)`` returns ``(step, cache_specs)``:
    step(model, tokens, pools, positions, q_len, table) -> (logits, pools),
    the continuous-batching step over the paged KV cache, and the (shape,
    dtype) of the pools it reads and writes. The engine runs the same step
    at two row widths: T = chunk while prefill work is pending, T = 1 for
    pure decode."""
    def build(n_pages: int, page_size: int):
        return D.paged_step, D.decoder_paged_cache_specs(
            cfg, axes, n_pages, page_size, dtype=dtype)
    return build


def zeros_caches(cache_specs, device="cuda"):
    """Zero-filled caches from a {name: (shape, dtype)} spec."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_specs.items()}
