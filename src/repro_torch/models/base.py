"""Architecture configuration (the port's copy of ``repro.models.base``).

Only the fields and methods the ported slices read are kept: dense
all-attention decoders, DeepSeek's MLA decoders with MoE FFNs, and
Jamba's hybrid Mamba/attention decoder with its experts, with RMSNorm or
LayerNorm, a gated or ungated MLP of SiLU, GELU or squared ReLU, and a
tied or untied LM head. ``comm_layers`` and ``tp_constraints`` describe a
configuration to the analytical model (``core/comm_model.py``) as the JAX
``ArchConfig``'s do, for the mixers and FFNs the port builds;
``__post_init__`` rejects what the slices cannot run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.comm_model import Constraints, LayerShape


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3
    score_fn: str = "softmax"        # "softmax" | "sigmoid" (dsv3)
    routed_scale: float = 1.0
    first_dense: int = 0             # leading dense layers
    period: int = 1                  # MoE every `period` layers (jamba: 2)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                   # "dense", "moe" or "hybrid" are ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    tie_embeddings: bool = False
    max_seq: int = 131072
    mla: Optional[MLACfg] = None
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    mixer_pattern: Tuple[str, ...] = ()   # per-layer mixer kinds (or period)
    ffn_pattern: Tuple[str, ...] = ()     # explicit per-layer ffn kinds
    mtp_depth: int = 0               # deepseek-v3 multi-token prediction
    source: str = ""                 # citation

    def __post_init__(self):
        unsupported = []
        if self.arch_type not in ("dense", "moe", "hybrid"):
            unsupported.append(f"arch_type {self.arch_type!r}")
        if self.norm not in ("rmsnorm", "layernorm"):
            unsupported.append(f"norm {self.norm!r}")
        if self.act not in ("silu", "gelu", "squared_relu"):
            unsupported.append(f"act {self.act!r}")
        if unsupported:
            raise NotImplementedError(
                f"{self.name}: the PyTorch port serves dense, MoE and hybrid "
                f"decoders with RMSNorm or LayerNorm and a SiLU, GELU or "
                f"squared-ReLU MLP only (got {', '.join(unsupported)}); "
                f"they wait for the ROADMAP.md §1 item 'dense config "
                f"variants'")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 512 multiple, as in the JAX package (the
        embedding rows past ``vocab_size`` are initialised and take part
        in the serving argmax)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def dt_rank(self) -> int:
        """The Mamba mixer's dt rank (``mamba.dt_rank`` or ceil(d / 16))."""
        return self.mamba.dt_rank or -(-self.d_model // 16)

    def mixers(self) -> Tuple[str, ...]:
        """Per-layer mixer kind, length n_layers."""
        if self.mixer_pattern:
            p = self.mixer_pattern
            if self.n_layers % len(p):
                raise ValueError("mixer_pattern must divide n_layers")
            return tuple(p) * (self.n_layers // len(p))
        if self.mla is not None:
            return ("mla",) * self.n_layers
        return ("attn",) * self.n_layers

    def ffns(self) -> Tuple[str, ...]:
        """Per-layer FFN kind ('mlp' | 'moe'), length n_layers."""
        if self.ffn_pattern:
            p = self.ffn_pattern
            if self.n_layers % len(p):
                raise ValueError("ffn_pattern must divide n_layers")
            return tuple(p) * (self.n_layers // len(p))
        out = []
        for i in range(self.n_layers):
            if (self.moe is not None and i >= self.moe.first_dense
                    and (i - self.moe.first_dense) % self.moe.period == 0):
                out.append("moe")
            else:
                out.append("mlp")
        return tuple(out)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.mixers(), self.ffns()))

    def axes_ok(self, axes) -> Optional[str]:
        """Why this config cannot run on ``axes`` (None if it can): the
        JAX ``axes_ok``'s checks, in its words. x must divide d_model, y
        the query heads, and y and the KV heads must divide one another
        (the duplicated-KV layout takes G_y a multiple of them; MLA has no
        KV heads to lay out); MoE experts shard over y, and over (y,
        expert) on an expert axis, which needs an MoE architecture.
        Context parallelism needs softmax attention everywhere (a
        recurrent mixer mixes across the whole sequence and would see only
        the local shard) and a ``max_seq`` that the seq axis divides."""
        if self.d_model % axes.gx:
            return f"d_model {self.d_model} % gx {axes.gx}"
        if self.n_heads % axes.gy:
            return f"heads {self.n_heads} % gy {axes.gy}"
        if (self.mla is None and self.n_kv_heads % axes.gy
                and axes.gy % self.n_kv_heads):
            return f"kv heads {self.n_kv_heads} vs gy {axes.gy}"
        if self.moe and self.moe.n_experts % axes.gy:
            return f"experts {self.moe.n_experts} % gy {axes.gy}"
        if axes.gseq > 1:
            if set(self.mixers()) != {"attn"}:
                return (f"seq axis (g_seq={axes.gseq}) needs all-attention "
                        f"mixers, got {sorted(set(self.mixers()))}")
            if self.max_seq % axes.gseq:
                return f"max_seq {self.max_seq} % g_seq {axes.gseq}"
        if axes.gexpert > 1:
            if self.moe is None:
                return (f"expert axis (g_expert={axes.gexpert}) needs an "
                        f"MoE architecture")
            if self.moe.n_experts % (axes.gy * axes.gexpert):
                return (f"experts {self.moe.n_experts} % gy*g_expert "
                        f"{axes.gy * axes.gexpert}")
        return None

    def validate_axes(self, axes) -> None:
        err = self.axes_ok(axes)
        if err is not None:
            raise ValueError(f"{self.name}: {err}")

    def scan_period(self) -> int:
        """Smallest repeating period of layer kinds (for stacked scan)."""
        kinds = self.layer_kinds()
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            if kinds == kinds[:p] * (self.n_layers // p):
                return p
        return self.n_layers

    def segments(self) -> Tuple[Tuple[Tuple[Tuple[str, str], ...], int], ...]:
        """The JAX package's greedy segmentation of layer_kinds() into
        (period_kinds, n_periods) runs; its parameter tree is stacked this
        way (``segments/seg{s}/pos{i}/...``, (n_periods, ...) leaves)."""
        kinds = self.layer_kinds()
        n = len(kinds)
        segs = []
        i = 0
        while i < n:
            best = (1, 1)
            for p in range(1, min(8, n - i) + 1):
                pat = kinds[i:i + p]
                r = 1
                while kinds[i + r * p: i + (r + 1) * p] == pat:
                    r += 1
                if (p * r > best[0] * best[1]
                        or (p * r == best[0] * best[1] and p < best[0])):
                    best = (p, r)
            p, r = best
            segs.append((kinds[i:i + p], r))
            i += p * r
        return tuple(segs)

    def layer_slots(self) -> Tuple[Tuple[int, int, int], ...]:
        """(segment s, position i, period p) of each layer: layer l is
        entry p of the stacked leaves under ``segments/seg{s}/pos{i}``."""
        out = []
        for s, (kinds, n_periods) in enumerate(self.segments()):
            for p in range(n_periods):
                out.extend((s, i, p) for i in range(len(kinds)))
        return tuple(out)

    def param_count(self) -> int:
        """Parameter count of the unpadded model, as the JAX
        ``param_count`` computes it (attention, Mamba, MLP and MoE
        layers)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        total = v * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.layer_kinds():
            if mixer == "attn":
                total += d * (self.n_heads + 2 * self.n_kv_heads) * hd
                total += self.n_heads * hd * d
            elif mixer == "mla":
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                total += d * (m.q_lora_rank or 0)
                total += (m.q_lora_rank or d) * self.n_heads * qk
                total += d * (m.kv_lora_rank + m.qk_rope_dim)
                total += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_dim + m.v_dim)
                total += self.n_heads * m.v_dim * d
            elif mixer == "mamba":
                di = self.mamba.expand * d
                dtr = self.dt_rank
                total += d * 2 * di + di * (dtr + 2 * self.mamba.d_state)
                total += dtr * di + di * d
            if ffn == "mlp":
                total += (self._mlp_mult + 1) * d * self.d_ff
            elif ffn == "moe":
                mc = self.moe
                per = (self._mlp_mult + 1) * d * mc.d_expert
                total += (mc.n_experts * per + mc.n_shared * per
                          + d * mc.n_experts)
        return total

    @property
    def _mlp_mult(self) -> int:
        """Input projections of an MLP: gate and up, or up alone."""
        return 2 if self.gated_mlp else 1

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only), as the JAX
        ``active_param_count``."""
        if self.moe is None:
            return self.param_count()
        mc = self.moe
        per = (self._mlp_mult + 1) * self.d_model * mc.d_expert
        n_moe = sum(1 for f in self.ffns() if f == "moe")
        return self.param_count() - n_moe * (mc.n_experts - mc.top_k) * per

    def comm_layers(self) -> Tuple[LayerShape, ...]:
        """LayerShapes for the communication model (paper §5), as the JAX
        ``comm_layers`` gives them for attention (its ``kv_ring_width``
        prices the seq axis's KV circulation), MLA (its q and output
        projections), Mamba, the MLP and MoE: the activated expert width
        (top_k + shared experts), its bank sharded over the expert axis
        (``expert``) and the dispatch and combine all-to-all priced on the
        up projection (``a2a_width``, capacity slots x d a token)."""
        d = self.d_model
        hd = self.head_dim_
        out = []
        for mixer, ffn in self.layer_kinds():
            if mixer == "mla":
                m = self.mla
                out.append(LayerShape(
                    d, self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)))
                out.append(LayerShape(self.n_heads * m.v_dim, d,
                                      transposed=True))
            elif mixer == "attn":
                out.append(LayerShape(
                    d, (self.n_heads + 2 * self.n_kv_heads) * hd,
                    kv_ring_width=2 * self.n_kv_heads * hd))
                out.append(LayerShape(self.n_heads * hd, d,
                                      transposed=True))
            elif mixer == "mamba":
                di = self.mamba.expand * d
                out.append(LayerShape(d, 2 * di))
                out.append(LayerShape(di, d, transposed=True))
            else:
                raise NotImplementedError(
                    f"{self.name}: comm_layers of mixer {mixer!r} is not "
                    f"ported to PyTorch yet: it waits for the ROADMAP.md "
                    f"§1 item 'other mixers and architectures'")
            if ffn == "mlp":
                out.append(LayerShape(d, self._mlp_mult * self.d_ff))
                out.append(LayerShape(self.d_ff, d, transposed=True))
            elif ffn == "moe":
                mc = self.moe
                fa = mc.top_k * mc.d_expert + mc.n_shared * mc.d_expert
                out.append(LayerShape(
                    d, self._mlp_mult * fa, expert=True,
                    a2a_width=mc.capacity_factor * mc.top_k * d))
                out.append(LayerShape(fa, d, transposed=True, expert=True))
        return tuple(out)

    def tp_constraints(self, global_batch: int) -> Constraints:
        """The JAX ``tp_constraints``: x divides d_model and d_ff, y the
        query heads (the KV heads may be duplicated over y) and the
        experts."""
        divs = [self.d_model, self.d_ff or self.d_model]
        y_divs = [self.n_heads]
        if self.moe:
            y_divs.append(self.moe.n_experts)
        return Constraints(global_batch=global_batch,
                           x_divides=tuple(divs),
                           y_divides=tuple(y_divs))

    def reduced(self) -> "ArchConfig":
        """The JAX package's smoke variant: d_model <= 256, at most 4
        heads, one period of layer kinds (2 layers for a dense decoder or
        DeepSeek, 8 for Jamba), <= 4 experts, MLA's latent 64 and head
        widths 48 (q/k) and 32 (v)."""
        n_layers = max(2, self.scan_period())
        if n_layers > 8:
            n_layers = 2
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kw = dict(
            name=self.name + "-smoke", n_layers=n_layers, d_model=d,
            n_heads=heads, n_kv_heads=min(self.n_kv_heads, heads),
            head_dim=d // heads, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512), max_seq=512)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_expert=128, n_shared=min(self.moe.n_shared, 1),
                first_dense=min(self.moe.first_dense, 1)
                if n_layers > 1 else 0)
        if self.mla:
            kw["mla"] = MLACfg(kv_lora_rank=64, q_lora_rank=(
                32 if self.mla.q_lora_rank else 0), qk_nope_dim=32,
                qk_rope_dim=16, v_dim=32)
            kw["head_dim"] = 0
        if self.mixer_pattern:
            kw["mixer_pattern"] = tuple(
                m for m, _ in self.layer_kinds())[:n_layers]
        if self.sliding_window:
            kw["sliding_window"] = 64
        return dataclasses.replace(self, **kw)
