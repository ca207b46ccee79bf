"""Decoder-only LM, training and paged serving paths (port of
``repro.models.decoder``).

The JAX package scans over layers stacked (n_periods, ...); here the
layers are an ``nn.ModuleList`` and the scan is a Python loop. Parameter
names follow the JAX tree with the stacking undone: ``embed``,
``layers.<i>.norm1.g``, ``layers.<i>.mixer.wq``, ..., ``final_norm.g``
(``convert`` maps one onto the other).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
                                                 device=device, dtype=dtype))

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

    def forward(self, h, *, positions, mode: str, cache=None, paged=None,
                plain: bool = False):
        h = h + self.mixer(self.norm1(h, plain=plain), positions=positions,
                           mode=mode, cache=cache, paged=paged, plain=plain)
        return h + self.ffn(self.norm2(h, plain=plain), plain=plain)


class Decoder(nn.Module):
    """``decoder_init``'s dense text path: embedding, blocks, final norm;
    the LM head is the tied embedding."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.cfg, self.axes = cfg, axes
        self.embed = nn.Parameter(PP.embedding_init(
            gen, cfg.padded_vocab, cfg.d_model, axes, dtype=dtype))
        self.layers = nn.ModuleList(
            Block(cfg, axes, gen=gen, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, axes, device=gen.device, dtype=dtype)

    def hidden(self, tokens, *, mode: str = "train", positions=None,
               pools=None, paged=None, remat: bool = True,
               remat_policy: str = "full", plain: bool = False):
        """``decoder_hidden``: (B, T) tokens -> (B, T, d/x) final-normed
        hidden states.

        ``mode="train"``: positions default to 0..T-1; with ``remat``
        each block is rematerialized in the backward
        (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of policy
        "full"). ``mode="paged"``: writes each layer's K/V into ``pools``
        (see :func:`decoder_paged_cache_specs`)."""
        if mode == "train" and remat and remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {remat_policy!r} is not ported to PyTorch "
                f"yet (only 'full'): it waits for the ROADMAP.md §1 item "
                f"'training on the multi-rank mesh'")
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=tokens.device).expand(B, T)
        h = PP.embedding_lookup(tokens, self.embed, self.axes)
        for i, blk in enumerate(self.layers):
            kw = dict(positions=positions, mode=mode, paged=paged,
                      plain=plain)
            if mode == "paged":
                kw["cache"] = {"k": pools["k"][i], "v": pools["v"][i]}
            if mode == "train" and remat:
                h = checkpoint(blk, h, use_reentrant=False, **kw)
            else:
                h = blk(h, **kw)
        return self.final_norm(h, plain=plain)


def lm_logits(model: Decoder, h, *, plain: bool = False):
    """(..., d/x) -> (..., V/y) logits through the tied embedding."""
    return PP.tied_lm_logits(h, model.embed, model.axes, plain=plain)


def lm_loss(model: Decoder, tokens, labels, *, image_embeds=None,
            remat: bool = True, xent_chunks: int = 1,
            remat_policy: str = "full", mtp_weight: float = 0.0,
            pstream=None, plain: bool = False):
    """Mean cross-entropy over the *global* batch. Returns (loss, metrics)
    with metrics {"xent", "aux"}; a dense decoder has no aux loss."""
    for what, on, item in (
            ("image_embeds", image_embeds is not None,
             "other mixers and architectures"),
            ("the MTP loss (mtp_weight > 0)", mtp_weight > 0.0,
             "MoE and the expert axis"),
            ("ZeRO-3 parameter streaming (pstream)", pstream is not None,
             "rest of the training stack")):
        if on:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet: it waits for the "
                f"ROADMAP.md §1 item '{item}'")
    cfg, axes = model.cfg, model.axes
    h = model.hidden(tokens, mode="train", remat=remat,
                     remat_policy=remat_policy, plain=plain)
    B, T = labels.shape

    def chunk_loss(hc, lc):
        logits = lm_logits(model, hc, plain=plain)
        return torch.sum(PP.vocab_parallel_xent(logits, lc, axes,
                                                cfg.vocab_size))

    if xent_chunks > 1 and T % xent_chunks == 0:
        hs = h.reshape(B, xent_chunks, T // xent_chunks, -1)
        ls = labels.reshape(B, xent_chunks, T // xent_chunks)
        total = 0.0
        for i in range(xent_chunks):
            total = total + chunk_loss(hs[:, i], ls[:, i])
    else:
        total = chunk_loss(h, labels)

    token_axes = ("data", "z")
    total = PP.ar_bwd_identity(total, axes, token_axes)
    loss = total / (B * T * axes.batch_shards)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    aux_mean = PP.ar_bwd_identity(aux, axes, token_axes) / axes.batch_shards
    return loss + aux_mean, {"xent": loss, "aux": aux_mean}


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


@torch.inference_mode()
def paged_step(model: Decoder, tokens, pools, positions, q_len, table, *,
               plain: bool = False):
    """One continuous-batching serving step over the paged KV cache, under
    inference mode (the parameters are trainable; serving records no
    graph).

    tokens (R, T): slot r's rows 0..q_len[r]-1 carry its prefill chunk (or
    single decode token) at global ``positions`` (R, T); rows past
    q_len[r] are padding (idle slots have q_len 0). ``table`` (R,
    max_pages) int32 holds the slots' physical page ids. Returns the
    per-slot next-token logits from the last *valid* row, (R, 1, V/y),
    and ``pools``, updated in place.

    The kernels run on CUDA tensors and the plain versions on CPU ones;
    ``plain=True`` runs the plain versions on any device."""
    paged = {"table": table, "q_len": q_len}
    h = model.hidden(tokens, mode="paged", positions=positions, pools=pools,
                     paged=paged, plain=plain)
    idx = torch.clamp(q_len.long() - 1, 0, tokens.shape[1] - 1)
    hl = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))
    return lm_logits(model, hl, plain=plain), pools
