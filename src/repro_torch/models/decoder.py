"""Decoder-only LM, paged serving path (port of ``repro.models.decoder``).

The JAX package scans over layers stacked (n_periods, ...); here the
layers are an ``nn.ModuleList`` and the scan is a Python loop. Parameter
names follow the JAX tree with the stacking undone: ``embed``,
``layers.<i>.norm1.g``, ``layers.<i>.mixer.wq``, ..., ``final_norm.g``
(``convert.params_from_jax`` maps one onto the other).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.layers import attention as A
from repro_torch.layers.mlp import MLP
from repro_torch.models.base import ArchConfig


class RMSNorm(nn.Module):
    """A feature-sharded RMSNorm over the residual stream (K3)."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.axes, self.full_dim = axes, cfg.d_model
        self.g = nn.Parameter(PP.norm_param_init(cfg.d_model, axes,
                                                 device=device, dtype=dtype),
                              requires_grad=False)

    def forward(self, h, *, plain: bool = False):
        return PP.rms_norm(h, self.g, self.axes, self.full_dim, plain=plain)


class Block(nn.Module):
    """Pre-norm attention + MLP block (``_block_apply``, attn + mlp)."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        dev = gen.device
        self.norm1 = RMSNorm(cfg, axes, device=dev, dtype=dtype)
        self.mixer = A.Attention(cfg, axes, gen=gen, dtype=dtype)
        self.norm2 = RMSNorm(cfg, axes, device=dev, dtype=dtype)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, axes, gen=gen, dtype=dtype)

    def forward(self, h, *, positions, cache, paged, plain: bool = False):
        h = h + self.mixer(self.norm1(h, plain=plain), positions=positions,
                           cache=cache, paged=paged, plain=plain)
        return h + self.ffn(self.norm2(h, plain=plain))


class Decoder(nn.Module):
    """``decoder_init``'s dense text path: embedding, blocks, final norm;
    the LM head is the tied embedding."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.cfg, self.axes = cfg, axes
        self.embed = nn.Parameter(PP.embedding_init(
            gen, cfg.padded_vocab, cfg.d_model, axes, dtype=dtype),
            requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, axes, gen=gen, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, axes, device=gen.device, dtype=dtype)

    def hidden(self, tokens, *, positions, pools, paged,
               plain: bool = False):
        """``decoder_hidden`` in mode "paged": (R, T) tokens -> (R, T, d/x)
        final-normed hidden states; writes each layer's K/V into
        ``pools`` (see :func:`decoder_paged_cache_specs`)."""
        h = PP.embedding_lookup(tokens, self.embed, self.axes)
        for i, blk in enumerate(self.layers):
            cache = {"k": pools["k"][i], "v": pools["v"][i]}
            h = blk(h, positions=positions, cache=cache, paged=paged,
                    plain=plain)
        return self.final_norm(h, plain=plain)

    def lm_logits(self, h):
        """(..., d/x) -> (..., V/y) logits through the tied embedding."""
        return PP.tied_lm_logits(h, self.embed, self.axes)


def decoder_paged_cache_specs(cfg: ArchConfig, axes: M.MeshAxes,
                              n_pages: int, page_size: int, *,
                              dtype=torch.float32):
    """(shape, dtype) of the paged serving cache: one K and one V page
    pool per attention layer, stacked over layers, (n_layers, n_pages,
    page_size, kv heads, head_dim).

    Paged serving gates to text decoders whose mixers are all softmax
    attention, as in the JAX package."""
    bad = sorted({m for m in cfg.mixers() if m != "attn"})
    if bad or cfg.arch_type in ("vlm", "audio"):
        what = (f"mixer(s) {bad}" if bad
                else f"arch_type {cfg.arch_type!r}")
        raise NotImplementedError(
            f"{cfg.name}: paged continuous-batching serving supports text "
            f"decoders with softmax-attention mixers only (got {what})")
    spec = A.paged_attn_cache_spec(cfg, axes, n_pages, page_size,
                                   dtype=dtype)
    return {name: ((cfg.n_layers, *shape), dt)
            for name, (shape, dt) in spec.items()}


def paged_step(model: Decoder, tokens, pools, positions, q_len, table, *,
               plain: bool = False):
    """One continuous-batching serving step over the paged KV cache.

    tokens (R, T): slot r's rows 0..q_len[r]-1 carry its prefill chunk (or
    single decode token) at global ``positions`` (R, T); rows past
    q_len[r] are padding (idle slots have q_len 0). ``table`` (R,
    max_pages) int32 holds the slots' physical page ids. Returns the
    per-slot next-token logits from the last *valid* row, (R, 1, V/y),
    and ``pools``, updated in place.

    The kernels run on CUDA tensors and the plain versions on CPU ones;
    ``plain=True`` runs the plain versions on any device."""
    paged = {"table": table, "q_len": q_len}
    h = model.hidden(tokens, positions=positions, pools=pools, paged=paged,
                     plain=plain)
    idx = torch.clamp(q_len.long() - 1, 0, tokens.shape[1] - 1)
    hl = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))
    return model.lm_logits(hl), pools
