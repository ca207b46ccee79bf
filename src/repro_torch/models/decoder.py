"""Decoder-only LM: the training path, paged serving and fixed-batch
serving (port of ``repro.models.decoder``).

The JAX package scans over layers stacked (n_periods, ...) per segment
position; here the layers are an ``nn.ModuleList`` and the scan is a Python
loop. Each layer's (mixer, ffn) kind comes from ``cfg.layer_kinds()``:
softmax attention, MLA or Mamba, and the MLP (gated or not) or MoE, whose
aux loss the blocks carry through the layers into ``lm_loss``, as the
reference's scan carries it; the residual norms are RMSNorm or
LayerNorm, as ``cfg.norm`` says. Parameter names follow the JAX tree
with the stacking undone: ``embed``, ``layers.<i>.norm1.g`` (and a
LayerNorm's ``.b``), ``layers.<i>.mixer.wq``, ..., ``final_norm.g``,
``lm_head`` when the head is untied, and DeepSeek-V3's multi-token
prediction module ``mtp.*`` where ``cfg.mtp_depth`` > 0 (``convert``
maps one onto the other). On a mesh every module is built at this
rank's local shapes (``partition.LEAF_SPECS``), and the serving
functions run this rank's batch shard: their logits are (R_local, 1,
V/y).

Under ZeRO-3 (``Decoder(..., shard=...)`` or :meth:`Decoder.shard_`) the
module tree keeps only the parameters' shapes and dtypes (meta tensors);
:attr:`Decoder.shards` holds this rank's 1/g_data shard of each, and the
training forward runs every block on working copies gathered from them
(``torch.func.functional_call``) as the train step's
``gradsync.ParamStreamer`` says.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core.overlap import OverlapConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as A
from repro_torch.layers.mamba import Mamba, mamba_state_spec
from repro_torch.layers.mlp import MLP
from repro_torch.layers.moe import MoE
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


class LayerNorm(nn.Module):
    """A feature-sharded LayerNorm over the residual stream (gain ``g``,
    bias ``b``; PyTorch ops, as the reference's is jnp)."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.axes, self.full_dim = axes, cfg.d_model
        self.g = nn.Parameter(PP.norm_param_init(cfg.d_model, axes,
                                                 device=device, dtype=dtype))
        self.b = nn.Parameter(PP.norm_param_init(cfg.d_model, axes,
                                                 device=device, dtype=dtype,
                                                 value=0.0))

    def forward(self, h, *, plain: bool = False):
        return PP.layer_norm(h, self.g, self.b, self.axes, self.full_dim)


def make_norm(cfg: ArchConfig, axes: M.MeshAxes, *, device,
              dtype=torch.float32) -> nn.Module:
    """The residual norm ``cfg.norm`` names (``_norm_init``/``_apply_norm``
    of the reference)."""
    cls = LayerNorm if cfg.norm == "layernorm" else RMSNorm
    return cls(cfg, axes, device=device, dtype=dtype)


class Block(nn.Module):
    """Pre-norm mixer + FFN block (``_block_apply``): the mixer is softmax
    attention, MLA or Mamba and the FFN the MLP or MoE, as ``kinds`` =
    (mixer, ffn) says. Returns (h, aux), aux the MoE layer's aux loss (0
    for an MLP)."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, kinds, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        mixer, ffn = kinds
        dev = gen.device
        self.kind, self.ffn_kind = mixer, ffn
        self.norm1 = make_norm(cfg, axes, device=dev, dtype=dtype)
        if mixer == "attn":
            self.mixer = A.Attention(cfg, axes, gen=gen, dtype=dtype)
        elif mixer == "mla":
            self.mixer = A.MLA(cfg, axes, gen=gen, dtype=dtype)
        elif mixer == "mamba":
            self.mixer = Mamba(cfg, axes, gen=gen, dtype=dtype)
        else:
            raise NotImplementedError(
                f"{cfg.name}: mixer {mixer!r} is not ported to PyTorch yet: "
                f"it waits for the ROADMAP.md §1 item 'other mixers and "
                f"architectures'")
        self.norm2 = make_norm(cfg, axes, device=dev, dtype=dtype)
        if ffn == "moe":
            self.ffn = MoE(cfg, axes, gen=gen, dtype=dtype)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, axes, gen=gen, act=cfg.act,
                           gated=cfg.gated_mlp, dtype=dtype)

    def forward(self, h, *, positions, mode: str, cache=None, paged=None,
                plain: bool = False):
        hn = self.norm1(h, plain=plain)
        if self.kind == "mamba":
            # seq-sharded decode changes only the attention cache's layout:
            # the recurrent state takes its plain step (the reference's
            # ``sub_mode``)
            sub = "decode" if mode.startswith("decode") else mode
            o = self.mixer(hn, mode=sub, state=cache, plain=plain)
        else:
            o = self.mixer(hn, positions=positions, mode=mode, cache=cache,
                           paged=paged, plain=plain)
        h = h + o
        hn = self.norm2(h, plain=plain)
        if self.ffn_kind == "moe":
            o, aux = self.ffn(hn, plain=plain)
        else:
            o = self.ffn(hn, plain=plain)
            aux = h.new_zeros((), dtype=torch.float32)
        return h + o, aux


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction module of depth 1
    (``decoder_init``'s ``mtp``): the final hidden state of token t and the
    embedding of token t+1, each normed (``norm_h``, ``norm_e``), each
    through a normal tp layer (``w_comb_h``, ``w_comb_e``), summed, GELU
    (tanh) and a transposed layer (``w_comb_o``; the reference's
    paper-layout stand-in for DeepSeek's concat linear), then one extra
    ``block`` of the last layer's mixer with a dense MLP. The shared head
    predicts token t+2 from its output (:func:`lm_loss`)."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        dev, d = gen.device, cfg.d_model
        self.norm_h = make_norm(cfg, axes, device=dev, dtype=dtype)
        self.norm_e = make_norm(cfg, axes, device=dev, dtype=dtype)

        def lin(in_shard, out_shard):
            return nn.Parameter(PP.tp_linear_init(
                gen, d, d, axes, in_shard, out_shard, dtype=dtype))
        self.w_comb_h, self.w_comb_e = lin("x", "y"), lin("x", "y")
        self.w_comb_o = lin("y", "x")
        self.block = Block(cfg, axes, (cfg.mixers()[-1], "mlp"), gen=gen,
                           dtype=dtype)
        self.axes = axes

    def forward(self, h, emb, positions, *, plain: bool = False):
        """h (B, T, d/x), the next tokens' embeddings emb (B, T, d/x) at
        ``positions`` (B, T) -> the extra block's output (B, T, d/x)."""
        axes = self.axes
        u = (PP.tp_matmul(self.norm_h(h, plain=plain), self.w_comb_h, axes,
                          "x", "y", plain=plain)
             + PP.tp_matmul(self.norm_e(emb, plain=plain), self.w_comb_e,
                            axes, "x", "y", plain=plain))
        hm = PP.tp_matmul(torch.nn.functional.gelu(u, approximate="tanh"),
                          self.w_comb_o, axes, "y", "x", plain=plain)
        return self.block(hm, positions=positions, mode="train",
                          plain=plain)[0]


class Decoder(nn.Module):
    """``decoder_init``'s text path: embedding, blocks, final norm, and the
    LM head: the tied embedding, or an untied ``lm_head`` (d, V) drawn
    from N(0, 0.02^2); with ``cfg.mtp_depth`` > 0 the :class:`MTP` module.

    ``shard`` (ZeRO-3): as soon as each part is drawn (the embedding, a
    layer, the final norm, the head), its parameters are replaced by
    :meth:`shard_`, so the whole model is never on the device at once;
    the shards are those of sharding the model drawn whole."""

    def __init__(self, cfg: ArchConfig, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32, shard=None):
        super().__init__()
        cfg.validate_axes(axes)
        self.cfg, self.axes = cfg, axes
        self.shards = None
        self.embed = nn.Parameter(PP.embedding_init(
            gen, cfg.padded_vocab, cfg.d_model, axes, dtype=dtype))
        self.shard_(shard, "embed")
        self.layers = nn.ModuleList()
        for i, kinds in enumerate(cfg.layer_kinds()):
            self.layers.append(Block(cfg, axes, kinds, gen=gen, dtype=dtype))
            self.shard_(shard, f"layers.{i}")
        self.final_norm = make_norm(cfg, axes, device=gen.device,
                                    dtype=dtype)
        self.shard_(shard, "final_norm")
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(PP.tp_linear_init(
                gen, cfg.d_model, cfg.padded_vocab, axes, scale=0.02,
                dtype=dtype))
            self.shard_(shard, "lm_head")
        if cfg.mtp_depth > 0:
            self.mtp = MTP(cfg, axes, gen=gen, dtype=dtype)
            self.shard_(shard, "mtp")

    @torch.no_grad()
    def shard_(self, shard, prefix: str = "") -> "Decoder":
        """ZeRO-3: each parameter under ``prefix`` ("": all) moves to
        :attr:`shards` as ``shard(its tensor)`` (a trainable parameter,
        e.g. ``gradsync.shard_tensor``'s) and is replaced in the module
        tree by a meta tensor of its shape and dtype. :attr:`shards`
        keeps ``named_parameters``' order. A no-op when ``shard`` is
        None."""
        if shard is None:
            return self
        shards = self.shards or {}
        for name, p in list(self.named_parameters()):
            if p.is_meta or not (prefix in ("", name)
                                 or name.startswith(prefix + ".")):
                continue
            shards[name] = nn.Parameter(shard(p))
            owner, _, leaf = name.rpartition(".")
            self.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                torch.empty_like(p, device="meta"), requires_grad=False)
        self.shards = {n: shards[n] for n, _ in self.named_parameters()
                       if n in shards}
        return self

    @property
    def device(self) -> torch.device:
        """Where the parameters (under ZeRO-3 their shards) live."""
        if self.shards:
            return next(iter(self.shards.values())).device
        return self.embed.device

    def hidden(self, tokens, *, mode: str = "train", positions=None,
               pools=None, paged=None, remat: bool = True,
               remat_policy: str = "full", plain: bool = False,
               pstream=None, resident=None, return_aux: bool = False):
        """``decoder_hidden``: (B, T) tokens -> (B, T, d/x) final-normed
        hidden states; with ``return_aux`` also the sum of the MoE
        layers' aux losses (fp32, 0 without MoE).

        ``mode="train"``: positions default to 0..T-1, or on a seq axis
        of size p to this rank's stripe j * p + r (the batch was striped
        with ``steps.stripe_batch``), so RoPE and the causal mask key off
        global positions; with ``remat`` each block is rematerialized in
        the backward
        (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of policy
        "full"). ``mode="paged"``: writes each layer's K/V into ``pools``
        (see :func:`decoder_paged_cache_specs`). ``mode="prefill"``,
        ``"decode"`` and ``"decode_seqshard"``: ``pools`` is the list of
        per-layer caches of :func:`decoder_cache_specs`, updated in
        place.

        ``pstream`` (a ``gradsync.ParamStreamer``; training under ZeRO-3):
        the blocks run on working copies of their parameters, gathered
        from :attr:`shards` per layer as the streamer says; ``resident``
        holds the parameters gathered once a microbatch (its
        ``resident``)."""
        if mode == "train" and remat and remat_policy not in ("full",
                                                              "dots"):
            raise ValueError(f"remat_policy {remat_policy!r}: 'full' or "
                             f"'dots'")
        axes = self.axes
        if axes.gseq > 1 and mode != "train":
            raise NotImplementedError(
                f"seq (context) parallelism is a training-path feature: the "
                f"{mode!r} path keeps its KV cache whole per batch shard, so "
                f"a seq axis of g_seq={axes.gseq} has nothing to shard "
                f"(ROADMAP residual 'seq-parallel serving'). Serve on a mesh "
                f"with g_seq == 1, e.g. pass a 4-tuple --mesh d,x,y,z.")
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=tokens.device)
            if mode == "train" and axes.gseq > 1:
                positions = positions * axes.gseq + M.axis_index(axes, "seq")
            positions = positions.expand(B, T)
        if pstream is not None and mode != "train":
            raise ValueError("ZeRO-3 parameter streaming is a training-path "
                             "feature")
        streamed = [i for i, blk in enumerate(self.layers)
                    if pstream is not None and pstream.streamed(
                        f"layers.{i}.{next(blk.named_parameters())[0]}")]
        posted = {}
        if streamed and pstream.prefetch:
            posted[streamed[0]] = pstream.post(self._layer_shards(
                streamed[0]))
        embed = self.embed if resident is None else resident["embed"]
        h = PP.embedding_lookup(tokens, embed, self.axes)
        remat = mode == "train" and remat
        aux = None
        for i, blk in enumerate(self.layers):
            kw = dict(positions=positions, mode=mode, paged=paged,
                      plain=plain)
            if mode == "paged":
                kw["cache"] = {"k": pools["k"][i], "v": pools["v"][i]}
            elif mode in ("prefill", "decode", "decode_seqshard"):
                kw["cache"] = pools[i]
            if pstream is None:
                fn, args = blk, (h,)
            else:
                fn, args = self._zero3_block(i, h, kw, pstream, resident,
                                             streamed, posted)
                kw = {}
            if remat and remat_policy == "dots":
                tape = ops.K1Tape()
                h, a = checkpoint(fn, *args, use_reentrant=False,
                                  context_fn=lambda t=tape: (t.record(),
                                                             t.replay()),
                                  **kw)
            elif remat:
                h, a = checkpoint(fn, *args, use_reentrant=False, **kw)
            else:
                h, a = fn(*args, **kw)
            if blk.ffn_kind == "moe":
                aux = a if aux is None else aux + a
        if resident is None:
            h = self.final_norm(h, plain=plain)
        else:
            h = functional_call(
                self.final_norm,
                {n: resident[f"final_norm.{n}"]
                 for n, _ in self.final_norm.named_parameters()},
                (h,), {"plain": plain})
        if not return_aux:
            return h
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h, aux

    def _layer_shards(self, i: int):
        return {n: s for n, s in self.shards.items()
                if n.startswith(f"layers.{i}.")}

    def _zero3_block(self, i, h, kw, pstream, resident, streamed, posted):
        """(fn, args) of layer i under ZeRO-3: the block run on its
        gathered weights. A streamed layer gathers inside ``fn`` (so
        remat's recompute asks again); with prefetch, the next streamed
        layer's exchanges are posted first. A resident layer takes its
        weights from ``resident`` as inputs."""
        blk = self.layers[i]
        names = [(short, f"layers.{i}.{short}")
                 for short, _ in blk.named_parameters()]
        if i not in streamed:
            def run(h, *ws, _blk=blk, _names=names, _kw=kw):
                return functional_call(
                    _blk, {s: w for (s, _), w in zip(_names, ws)}, (h,),
                    _kw)
            return run, (h, *(resident[f] for _, f in names))
        pending = posted.pop(i, {})
        k = streamed.index(i)
        if pstream.prefetch and k + 1 < len(streamed):
            posted[streamed[k + 1]] = pstream.post(self._layer_shards(
                streamed[k + 1]))
        shards = [self.shards[f] for _, f in names]
        fetches = [pstream.fetcher(s, pending.get(f))
                   for (_, f), s in zip(names, shards)]

        def run(h, *sh, _blk=blk, _names=names, _kw=kw):
            ws = {s: pstream.gather(x, f, fe)
                  for (s, f), x, fe in zip(_names, sh, fetches)}
            return functional_call(_blk, ws, (h,), _kw)
        return run, (h, *shards)


@contextlib.contextmanager
def overlap_bound(model: nn.Module, overlap: OverlapConfig):
    """Every module of ``model`` sees its axes with ``overlap`` (``axes.
    with_overlap``) while the block runs, and its own axes after: the
    steps bind the schedule this way, as the JAX steps bind it on the axes
    their layers are traced with. Remat's recompute runs inside the
    step's backward, so it sees the same schedule."""
    mods = [m for m in model.modules()
            if isinstance(getattr(m, "axes", None), M.MeshAxes)]
    saved = [m.axes for m in mods]
    for m in mods:
        m.axes = m.axes.with_overlap(overlap)
    try:
        yield
    finally:
        for m, axes in zip(mods, saved):
            m.axes = axes


def lm_logits(model: Decoder, h, *, plain: bool = False, weights=None):
    """(..., d/x) -> (..., V/y) logits through the tied embedding or the
    untied head (under ZeRO-3 their working copies in ``weights``)."""
    if model.cfg.tie_embeddings:
        w = model.embed if weights is None else weights["embed"]
        return PP.tied_lm_logits(h, w, model.axes, plain=plain)
    w = model.lm_head if weights is None else weights["lm_head"]
    return PP.tp_matmul(h, w, model.axes, "x", "y", plain=plain)


def lm_loss(model: Decoder, tokens, labels, *, image_embeds=None,
            remat: bool = True, xent_chunks: int = 1,
            remat_policy: str = "full", mtp_weight: float = 0.0,
            pstream=None, plain: bool = False):
    """Mean cross-entropy over the *global* batch plus the MoE layers' aux
    loss, averaged over the token shards as the reference does. Returns
    (loss, metrics) with metrics {"xent", "aux"}; a dense decoder's aux
    is 0.

    With ``pstream`` (ZeRO-3; ``model.shards`` hold the parameters) the
    parameters that do not stream (embedding, final norm, an untied head,
    a one-period segment's layers) are gathered once here, outside remat,
    the tied embedding's one copy feeding both the lookup and the head;
    the layers stream through :meth:`Decoder.hidden`.

    ``mtp_weight`` > 0 on a model with an :class:`MTP` module (and T > 2)
    adds ``mtp_weight`` times the reference's MTP loss, the mean
    cross-entropy of predicting token t+2, and metrics["mtp"]."""
    if image_embeds is not None:
        raise NotImplementedError(
            "image_embeds is not ported to PyTorch yet: it waits for the "
            "ROADMAP.md §1 item 'other mixers and architectures'")
    cfg, axes = model.cfg, model.axes
    resident = (None if pstream is None
                else pstream.resident(model.shards))
    h, aux = model.hidden(tokens, mode="train", remat=remat,
                          remat_policy=remat_policy, plain=plain,
                          pstream=pstream, resident=resident,
                          return_aux=True)
    B, T = labels.shape

    def chunk_loss(hc, lc):
        logits = lm_logits(model, hc, plain=plain, weights=resident)
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

    # the token grid is sharded over the batch axes and seq: the mean
    # reduces over both (with seq unmapped, the batch reductions alone)
    total = PP.ar_bwd_identity(total, axes, axes.token_axes())
    loss = total / (B * T * axes.token_shards)
    aux_mean = (PP.ar_bwd_identity(aux, axes, axes.token_axes())
                / axes.token_shards)
    out, metrics = loss + aux_mean, {"xent": loss, "aux": aux_mean}
    if mtp_weight > 0.0 and hasattr(model, "mtp") and T > 2:
        metrics["mtp"] = _mtp_loss(model, h, tokens, labels, resident, plain)
        out = out + mtp_weight * metrics["mtp"]
    return out, metrics


def _mtp_loss(model: Decoder, h, tokens, labels, resident, plain):
    """The reference's MTP term of ``lm_loss``: predict token t+2 from
    (h_t, emb(token t+1)) through :class:`MTP` and the shared head, the
    cross-entropy's sum psum'd over the batch axes and divided by the
    global count of predictions. Under ZeRO-3 the module, the embedding
    and the head run on their gathered copies in ``resident``."""
    axes = model.axes
    if axes.gseq != 1:
        raise ValueError("MTP needs contiguous token shifts (no seq "
                         "sharding)")
    embed = model.embed if resident is None else resident["embed"]
    emb = PP.embedding_lookup(tokens[:, 1:-1], embed, axes)
    Bm, Tm = emb.shape[:2]
    pos = torch.arange(Tm, dtype=torch.int32,
                       device=tokens.device).expand(Bm, Tm)
    args = (h[:, :-2], emb, pos)
    if resident is None:
        hm = model.mtp(*args, plain=plain)
    else:
        hm = functional_call(
            model.mtp, {n: resident[f"mtp.{n}"]
                        for n, _ in model.mtp.named_parameters()},
            args, {"plain": plain})
    logits = lm_logits(model, hm, plain=plain, weights=resident)
    total = torch.sum(PP.vocab_parallel_xent(logits, labels[:, 1:-1], axes,
                                             model.cfg.vocab_size))
    total = PP.ar_bwd_identity(total, axes, axes.batch_axes())
    return total / (Bm * Tm * axes.batch_shards)


def decoder_paged_cache_specs(cfg: ArchConfig, axes: M.MeshAxes,
                              n_pages: int, page_size: int, *,
                              dtype=torch.float32):
    """(shape, dtype) of this rank's paged serving cache for a global pool
    of ``n_pages``: one K and one V page pool per attention layer, stacked
    over layers, (n_layers, n_pages / (g_data g_z), page_size, local kv
    heads, head_dim).

    Paged serving gates to text decoders whose mixers are all softmax
    attention, as in the JAX package."""
    bad = sorted({m for m in cfg.mixers() if m != "attn"})
    if bad or cfg.arch_type in ("vlm", "audio"):
        what = (f"mixer(s) {bad}" if bad
                else f"arch_type {cfg.arch_type!r}")
        raise NotImplementedError(
            f"{cfg.name}: paged continuous-batching serving supports text "
            f"decoders with softmax-attention mixers only (got {what}). Use "
            f"the fixed-batch path instead: python -m "
            f"repro_torch.launch.serve --mode fixed --arch {cfg.name}")
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
    q_len[r] are padding (idle slots have q_len 0). ``table`` (R, n)
    int32 holds the slots' physical page ids, n at least the pages that
    hold their valid rows' keys. Returns the per-slot next-token logits
    from the last *valid* row, (R, 1, V/y), and ``pools``, updated in
    place.

    The kernels run on CUDA tensors and the plain versions on CPU ones;
    ``plain=True`` runs the plain versions on any device."""
    paged = {"table": table, "q_len": q_len}
    h = model.hidden(tokens, mode="paged", positions=positions, pools=pools,
                     paged=paged, plain=plain)
    idx = torch.clamp(q_len.long() - 1, 0, tokens.shape[1] - 1)
    hl = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))
    return lm_logits(model, hl, plain=plain), pools


# ---------------------------------------------------------------------- #
# fixed-batch serving: dense caches, prefill, decode step
# ---------------------------------------------------------------------- #

def decoder_cache_specs(cfg: ArchConfig, axes: M.MeshAxes, batch: int,
                        seq: int, *, dtype=torch.float32,
                        seqshard: bool = False):
    """(shape, dtype) of this rank's fixed-batch decode cache for a global
    ``batch``, one dict per layer (the JAX tree stacks them (n_periods,
    ...) per segment position; ``convert.caches_from_jax`` maps one onto
    the other): an attention layer's dense K and V (batch / (g_data g_z),
    S, local kv heads, head_dim), S = ``seq`` rounded up to a multiple of
    ``attention.DENSE_PAGE``; an MLA layer's latent cache {"ckv",
    "k_rope"} (``attention.mla_cache_spec``); a Mamba layer's conv and
    scan states. ``seqshard``: the K/V's sequence dim shards over data
    and every rank holds the whole batch (the Mamba states replicated
    over data), as the reference lays out ``long_500k``."""
    out = []
    for mixer in cfg.mixers():
        if mixer == "attn":
            out.append(A.attn_cache_spec(cfg, axes, batch, seq, dtype=dtype,
                                         seqshard=seqshard))
        elif mixer == "mla":
            if seqshard:
                raise ValueError("MLA long-context seqshard unsupported")
            out.append(A.mla_cache_spec(cfg, axes, batch, seq, dtype=dtype))
        elif mixer == "mamba":
            out.append(mamba_state_spec(cfg, axes, batch, dtype=dtype,
                                        seqshard=seqshard))
        else:
            raise NotImplementedError(
                f"{cfg.name}: mixer {mixer!r} is not ported to PyTorch yet: "
                f"it waits for the ROADMAP.md §1 item 'other mixers and "
                f"architectures'")
    return out


@torch.inference_mode()
def prefill(model: Decoder, tokens, caches, *, plain: bool = False):
    """Fill the caches from prompts tokens (B, T) at positions 0..T-1;
    returns (the last row's logits (B, 1, V/y), caches), the caches
    updated in place."""
    h = model.hidden(tokens, mode="prefill", pools=caches, plain=plain)
    return lm_logits(model, h[:, -1:], plain=plain), caches


@torch.inference_mode()
def decode_step(model: Decoder, tokens, caches, pos, *,
                seqshard: bool = False, plain: bool = False):
    """One serving step: tokens (B, 1) at absolute position ``pos`` (the
    same for every sequence, an int or a 0-d tensor). Returns (logits (B,
    1, V/y), caches), the caches updated in place. ``seqshard``: the
    attention caches' sequence dim is sharded over data (mode
    ``"decode_seqshard"``)."""
    B = tokens.shape[0]
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=tokens.device).expand(B, 1)
    mode = "decode_seqshard" if seqshard else "decode"
    h = model.hidden(tokens, mode=mode, positions=positions,
                     pools=caches, plain=plain)
    return lm_logits(model, h, plain=plain), caches
