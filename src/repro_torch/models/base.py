"""Architecture configuration (the port's copy of ``repro.models.base``).

Only the fields and methods the ported serving slice reads are kept: the
dense, all-attention, RMSNorm, gated-SiLU, tied-embedding decoder. The
communication-model fields and methods of the JAX ``ArchConfig`` are not
carried over; ``__post_init__`` rejects what the slice cannot run.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                   # only "dense" is ported
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
    source: str = ""                 # citation

    def __post_init__(self):
        unsupported = []
        if self.arch_type != "dense":
            unsupported.append(f"arch_type {self.arch_type!r}")
        if self.norm != "rmsnorm":
            unsupported.append(f"norm {self.norm!r}")
        if self.act != "silu" or not self.gated_mlp:
            unsupported.append("an MLP other than gated SiLU")
        if not self.tie_embeddings:
            unsupported.append("an untied LM head")
        if unsupported:
            raise NotImplementedError(
                f"{self.name}: the PyTorch port serves dense decoders with "
                f"RMSNorm, gated SiLU and tied embeddings only (got "
                f"{', '.join(unsupported)}); they wait for the ROADMAP.md §1 "
                f"item 'dense config variants'")
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

    def mixers(self) -> Tuple[str, ...]:
        return ("attn",) * self.n_layers

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        return tuple((m, "mlp") for m in self.mixers())

    def segments(self) -> Tuple[Tuple[Tuple[Tuple[str, str], ...], int], ...]:
        """The JAX package's (period_kinds, n_periods) runs. A dense
        decoder is one segment of period 1, which is how its parameter
        tree is stacked (``segments/seg0/pos0/...``)."""
        return ((self.layer_kinds()[:1], self.n_layers),)

    def reduced(self) -> "ArchConfig":
        """The JAX package's 2-layer, d_model <= 256 smoke variant."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kw = dict(
            name=self.name + "-smoke", n_layers=2, d_model=d,
            n_heads=heads, n_kv_heads=min(self.n_kv_heads, heads),
            head_dim=d // heads, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512))
        if self.sliding_window:
            kw["sliding_window"] = 64
        return dataclasses.replace(self, **kw)
