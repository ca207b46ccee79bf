"""OverlapConfig: the comm/compute-overlap knobs for the 4D primitives.

The paper's first key strategy is to "aggressively overlap expensive
collective operations with computation". Two mechanisms implement it here:

  * overdecomposition (paper §4.2, core/overdecompose.py) — overlap
    *between* batch micro-shards, and
  * ring-decomposed collective matmuls (core/collective_matmul.py) —
    overlap *inside* each layer: the z-axis weight all-gather / gradient
    reduce-scatter is decomposed into ``lax.ppermute`` ring steps whose
    per-chunk GEMMs interleave with the permutes, so the weight traffic
    hides under the layer's own compute. The same treatment applies to
    the x/y *activation* all-reduces of every tensor-parallel matmul
    (``all_reduce`` below): each all-reduce becomes a reduce-scatter ring
    whose hops consume the producing GEMM's output chunk by chunk,
    followed by an all-gather ring (AxoNN-style, arXiv:2110.13005).

An :class:`OverlapConfig` instance rides on :class:`repro.core.mesh.
MeshAxes` (``axes.with_overlap(cfg)``) so every ``tp_*`` primitive sees it
without threading an extra argument through the layer stack. It is a
frozen (hashable) dataclass: it participates in ``custom_vjp`` nondiff
args and jit static args unchanged.

``cache_weight_gather`` subsumes the old module-global
``parallel.CACHE_WEIGHT_GATHER`` trace-time flag: cache the z-gathered
weight from the forward pass instead of re-gathering in the backward pass
(trades one AG_z per layer for holding the full (k_local, n_local) weight
across the residual).

Knob units and degeneracy guarantees (DESIGN.md §Overlapped schedule):

  * ``z_chunks`` / ``ar_chunks`` — sub-rings per block (dimensionless
    counts; non-dividing values round down to the largest divisor).
  * ``OverlapConfig()`` (all off) ⇒ the blocking collective schedule of
    core/parallel.py, bit for bit — and in ``comm_model.layer_time`` an
    all-off config with ``alpha = 0`` reduces the exposed-communication
    term exactly to the volume model.
  * The ring knobs never change wire volume, only exposure; only
    ``cache_weight_gather`` changes volume (drops one AG_z per layer),
    and ``comm_model.layer_volume(overlap=...)`` models exactly that.
  * How much ring traffic actually hides is the *measured*
    ``HardwareParams.overlap_efficiency`` (core/calibrate.py's overlap
    probe; 0.8 is the uncalibrated guess).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Per-primitive on/off switches + ring chunking for collective matmuls.

    matmul / batched_matmul / tied_logits: use the ring-decomposed
    (overlapped) z-axis schedule inside ``tp_matmul`` /
    ``tp_batched_matmul`` / ``tied_lm_logits``. Off (default) keeps the
    blocking all-gather / reduce-scatter schedule.

    all_reduce: ring-decompose the x/y *activation* all-reduces of the
    same three primitives (fwd partial-output reduce, bwd dX reduce, tied
    dh reduce) into reduce-scatter + all-gather ``ppermute`` phases; where
    the reduced tensor's producing GEMM is materialized in the same
    schedule, its output is produced per chunk, just in time for each
    reduce-scatter hop (``collective_matmul.ar_matmul*``). The scalar
    psums of the feature-sharded norms and the vocab-parallel softmax
    stay blocking (latency-bound, nothing to pipeline).

    z_chunks: how many independent ring pipelines the z-axis collective of
    one matmul is split into. 1 = one ring whose steps already interleave
    one GEMM per hop; c > 1 splits each per-device weight block into ``c``
    sub-blocks with their own (smaller) rings, giving the scheduler
    finer-grained permute/GEMM pairs to overlap. Must divide the per-device
    block's gathered dimension.

    ar_chunks: same knob for the activation all-reduce rings (sub-rings
    per scattered block; the largest divisor <= ar_chunks is used).

    cache_weight_gather: keep the z-gathered weight from the forward as a
    residual instead of re-gathering it in the backward (EXPERIMENTS.md
    §Perf).

    ring_attention: circulate per-hop KV blocks over the ``seq`` mesh
    axis as ``ppermute`` ring steps (layers/attention.py ``seq_attn``),
    with hop i+1's permute issued before hop i's partial-attention
    compute so the exchange hides under attention math. Off keeps the
    blocking schedule (one KV all-gather over ``seq``). Inert when the
    seq axis is unmapped (g_seq = 1: both paths reduce to the plain
    ``attn_core`` call, bit for bit).

    embed_gather: ring-decompose the embedding table's z-axis all-gather
    (``parallel.embedding_lookup``) into ``ppermute`` hops —
    ``mesh.ring_all_gather`` is bitwise the blocking gather, so this
    only changes exposure, never values.

    expert_a2a: ring-decompose the MoE dispatch/combine all-to-all over
    the ``expert`` mesh axis into pairwise ``ppermute`` exchanges
    interleaved with the per-source expert GEMMs
    (``collective_matmul.ring_a2a_expert``), so the token exchange hides
    under expert compute. Off keeps the blocking ``lax.all_to_all``
    schedule. Inert when the expert axis is unmapped (g_expert = 1: both
    paths reduce to the within-y dispatch, bit for bit).
    """

    matmul: bool = False
    batched_matmul: bool = False
    tied_logits: bool = False
    all_reduce: bool = False
    z_chunks: int = 1
    ar_chunks: int = 1
    cache_weight_gather: bool = False
    ring_attention: bool = False
    embed_gather: bool = False
    expert_a2a: bool = False

    def __post_init__(self):
        if self.z_chunks < 1:
            raise ValueError(f"z_chunks must be >= 1, got {self.z_chunks}")
        if self.ar_chunks < 1:
            raise ValueError(f"ar_chunks must be >= 1, got {self.ar_chunks}")

    @property
    def any_enabled(self) -> bool:
        return (self.matmul or self.batched_matmul or self.tied_logits
                or self.all_reduce or self.ring_attention
                or self.embed_gather or self.expert_a2a)

    @classmethod
    def all_on(cls, *, z_chunks: int = 1, ar_chunks: int = 1,
               cache_weight_gather: bool = False) -> "OverlapConfig":
        return cls(matmul=True, batched_matmul=True, tied_logits=True,
                   all_reduce=True, z_chunks=z_chunks, ar_chunks=ar_chunks,
                   cache_weight_gather=cache_weight_gather,
                   ring_attention=True, embed_gather=True,
                   expert_a2a=True)
