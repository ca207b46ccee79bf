"""Analytic communication model (paper §5, generalized to 4D).

The supplied text models the per-GPU, per-iteration all-reduce volume of its
2D tensor-parallel algorithm (Eqs. 1-4) and derives decomposition rules
(max ``G_data``; for transformers ``G_c = sqrt(3 G_tensor)``, Eq. 7). The 4D
algorithm adds the depth axis ``G_z``; its extra collectives are the weight
all-gather (forward) and the weight-gradient reduce-scatter (backward) over
``z``, whose volumes are *batch-independent* — the 4D trade: pay
``O(params)`` weight traffic to cut ``O(batch)`` activation traffic by
``1/G_z``.

All volumes are *elements sent+received per device per iteration* (multiply
by dtype bytes for bytes), mirroring the paper. Collectives are assumed
bandwidth-optimal (Patarasuk & Yuan): ``V_AR = 2 (p-1)/p * buf``,
``V_AG = V_RS = (p-1)/p * buf_full``.

Beyond the paper's volume-only ranking, the α-β *time* model
(:class:`HardwareParams`, :func:`predict_step_time`) prices each
collective as ``steps * α + bytes / bw`` (all-reduces at 2(p-1) ring
hops, gathers/scatters at p-1) and — when an
:class:`~repro.core.overlap.OverlapConfig` enables the ring-decomposed
collective matmuls — hides the z-axis weight traffic (``matmul``) and
then the x/y activation all-reduce traffic (``all_reduce``) under the
layer's own GEMM time, charging only the *exposed* remainder.

Units: volumes in *elements sent+received per device per iteration*;
times in seconds; α in seconds/hop; ``link_bw`` in bytes/s; ``flops``
in FLOP/s; ``bytes_per_elem`` in wire bytes per element; the
``overlap_efficiency`` / ``cross_step_efficiency`` knobs are fractions
in [0, 1].

Degeneracy guarantees (pinned by tests/test_overlap.py,
tests/test_gradsync.py, tests/test_zero3.py and tests/test_calibrate.py):

  * α = 0 (γ is 0 by default) and overlap disabled ⇒ the
    exposed-communication term equals ``model_volume * bytes_per_elem /
    bw`` exactly — the volume model is the degenerate point of the time
    model (the shared :func:`layer_geometry` keeps the two in lockstep);
  * ``GradSyncConfig.cross_step = False`` ⇒ :func:`dp_sync_time` is
    exactly the PR-3 exposed model;
  * the :class:`HardwareParams` defaults (``z_claims_first=True``,
    ``cross_step_efficiency=1.0``) ⇒ the pre-calibration model bitwise —
    an uncalibrated run is unchanged. ``core/calibrate.py`` fits
    measured replacements (``--calib`` on the CLIs);
  * ``g_seq = 1`` ⇒ the 4-factor model bitwise, and ``g_expert = 1`` ⇒
    the 5-factor model bitwise (tests/test_properties.py,
    tests/test_expert_parallel.py): every new factor at its identity
    value reproduces the previous model term for term.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.overlap import OverlapConfig


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One contraction layer: Y[m,n] = X[m,k] @ W[k,n].

    ``transposed`` layers store W with the x/y roles swapped (paper §4.1),
    which swaps G_x and G_y in the volume formulas (paper Table 1).
    ``count`` multiplies the layer (e.g. repeated blocks).
    ``moe_factor`` scales the *weight* terms only (routed experts hold
    ``E`` times the parameters but each token activates ``top_k``; the
    activation all-reduces see ``top_k/E``-scaled token counts folded in by
    the caller via separate LayerShape entries).
    """

    k: int
    n: int
    transposed: bool = False
    count: int = 1
    tokens_scale: float = 1.0  # fraction of batch tokens that hit this layer
    # elements per token of the KV block this layer's output feeds into
    # the context-parallel ring (2 * n_kv_heads * head_dim on the QKV
    # projection, 0 elsewhere): with g_seq > 1 the ring circulates
    # m_local * kv_ring_width / g_y elements per hop, fwd and bwd
    kv_ring_width: float = 0.0
    # expert-parallel markers: ``expert`` marks a routed-expert-bank
    # layer (its weights shard over g_expert, so the z/DP weight buffers
    # divide by it and its gradients need no expert-axis sync);
    # ``a2a_width`` (set once per MoE block, on the up-projection) is
    # the elements per token the capacity-based dispatch moves across
    # the expert axis each direction (capacity_factor * top_k * d) —
    # with g_expert > 1 the block pays 4 all_to_all passes of
    # m_local * a2a_width / (g_x * g_y) elements (dispatch + combine,
    # fwd + bwd)
    expert: bool = False
    a2a_width: float = 0.0


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """``g_seq`` (context parallelism, a 5th factor of the same device
    budget) defaults to 1 so every 4-factor caller is unchanged; it
    joins ``g`` but NOT ``g_tensor`` — the seq axis shards activations
    by token, not weights, so the min_tensor memory floor and the
    paper's G_tensor-based closed forms see only x*y*z.

    ``g_expert`` (expert parallelism, a 6th factor) likewise defaults
    to 1 so every 5-factor caller reduces bitwise to today's model: it
    shards the routed-expert bank of MoE layers AND the batch (dense
    layers see it as a second data axis), and tokens cross it via the
    capacity-based dispatch/combine all-to-all. Like ``g_seq`` it joins
    ``g`` but not ``g_tensor`` — dense weights replicate over it."""

    g_data: int
    g_x: int
    g_y: int
    g_z: int
    g_seq: int = 1
    g_expert: int = 1

    @property
    def g(self) -> int:
        return (self.g_data * self.g_x * self.g_y * self.g_z * self.g_seq
                * self.g_expert)

    @property
    def g_tensor(self) -> int:
        return self.g_x * self.g_y * self.g_z


def allreduce_volume(p: int, buf: float) -> float:
    """Lower-bound all-reduce volume per participant (Eq. 1)."""
    return 0.0 if p <= 1 else 2.0 * (p - 1) / p * buf


def gather_or_scatter_volume(p: int, full_buf: float) -> float:
    """All-gather / reduce-scatter volume per participant."""
    return 0.0 if p <= 1 else (p - 1) / p * full_buf


def ring_exchange_volume(p: int, buf: float) -> float:
    """Ring-attention KV circulation volume per participant: p-1
    ppermute hops each forwarding a *full* per-rank block of ``buf``
    elements (no 1/p reduction — every rank must see every block), so
    the class is strictly more expensive per element than AG/RS."""
    return 0.0 if p <= 1 else (p - 1) * buf


def all_to_all_volume(p: int, buf: float) -> float:
    """All-to-all volume per participant: each rank keeps its own 1/p
    block and exchanges the other (p-1)/p of its ``buf``-element
    dispatch buffer — the MoE expert dispatch/combine geometry. Same
    wire bytes whether spelled as one ``lax.all_to_all`` or the
    ring-decomposed pairwise ppermute schedule (each block travels
    exactly once either way)."""
    return 0.0 if p <= 1 else (p - 1) / p * buf


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """Shared per-layer geometry of the volume and time models.

    One source of truth for the axis-role swap, the local token count and
    every collective's buffer size, consumed by both :func:`layer_volume`
    and :func:`layer_time` — factored out so the α=0/no-overlap
    degeneracy of the time model to the volume model cannot drift
    (tests/test_overlap.py pins it).

    ``gx``/``gy`` are the contraction/output axis sizes with the
    transposed-layer role swap applied; buffers are in elements, with the
    :func:`allreduce_volume` / :func:`gather_or_scatter_volume`
    conventions.
    """

    gx: int
    gy: int
    m_local: float         # tokens hitting this layer, per (data x z x seq
                           # x expert)
    ar_fwd_buf: float      # fwd partial-output all-reduce over gx (Eq. 2)
    ar_bwd_buf: float      # bwd dX all-reduce over gy (Eq. 3)
    w_full_per_xy: float   # z-collective buffer: full weight per x*y shard
    n_gathers: int         # AG_z count (1 when the bwd re-gather is cached)
    dp_buf: float          # DP gradient buffer per device (w / (x*y*z))
    seq_buf: float         # per-hop KV ring block (elements per seq-rank)
    a2a_buf: float = 0.0   # expert dispatch buffer per rank (elements)


def layer_geometry(ls: LayerShape, tokens: int, d: Decomposition,
                   overlap: Optional[OverlapConfig] = None) -> LayerGeometry:
    gx, gy = (d.g_x, d.g_y) if not ls.transposed else (d.g_y, d.g_x)
    m_local = (tokens * ls.tokens_scale
               / (d.g_data * d.g_z * d.g_seq * d.g_expert))
    cached = bool(overlap and overlap.cache_weight_gather)
    w_full_per_xy = ls.k * ls.n / (d.g_x * d.g_y)
    if ls.expert:
        # the routed-expert bank co-shards over g_expert: every weight
        # buffer (and hence the z collectives and DP sync riding on it)
        # shrinks by 1/g_expert
        w_full_per_xy /= d.g_expert
    return LayerGeometry(
        gx=gx, gy=gy, m_local=m_local,
        ar_fwd_buf=m_local * ls.n / gy,
        ar_bwd_buf=m_local * ls.k / gx,
        w_full_per_xy=w_full_per_xy,
        n_gathers=1 if cached else 2,
        dp_buf=w_full_per_xy / d.g_z,
        # KV heads shard over the layer's output axis (gy for the
        # untransposed QKV projection); the ring forwards this per hop
        seq_buf=m_local * ls.kv_ring_width / gy,
        # per-rank dispatch buffer of the expert all-to-all: capacity
        # slots for every expert of this y row — capacity_factor *
        # top_k * m_local tokens of d/(gx*gy)-wide… folded into
        # a2a_width = capacity_factor * top_k * d by the caller
        a2a_buf=m_local * ls.a2a_width / (d.g_x * d.g_y))


def dp_sync_volume(p: int, buf: float,
                   gradsync: Optional[GradSyncConfig] = None,
                   microbatches: int = 1) -> float:
    """Per-device DP param/gradient-sync volume (elements) for one
    layer's weight buffer ``buf``.

    Blocking (no gradsync): one bandwidth-optimal all-reduce. Bucketed /
    ZeRO-1 (core/gradsync.py): one reduce-scatter per streamed
    microbatch plus one all-gather (updated params under ``zero``,
    gradients otherwise — same size). With ``stream`` off — or one
    microbatch — this is RS + AG == exactly the all-reduce volume (the
    Patarasuk-Yuan decomposition), so the bucketed path's volume
    degenerates to the blocking one at the no-overlap point.

    ZeRO-3 (``zero3``): every microbatch's forward all-gathers each
    layer's params just-in-time and its backward re-gathers them (remat)
    and reduce-scatters the gradient via the gather's transpose — per
    microbatch: 2 AG + 1 RS, or 1 AG + 1 RS with ``prefetch`` (the
    forward's working copy is retained for the backward). There is no
    trailing param rebroadcast (the update writes shards). At one
    microbatch with prefetch this is again AG + RS == the all-reduce
    volume — ZeRO-3's volume floor is the blocking one."""
    if p <= 1:
        return 0.0
    if gradsync is None or not gradsync.enabled:
        return allreduce_volume(p, buf)
    if gradsync.zero3:
        per_mb = (2 if gradsync.prefetch else 3)  # AG [+AG regather] + RS
        return microbatches * per_mb * gather_or_scatter_volume(p, buf)
    n = microbatches if gradsync.stream else 1
    return (n + 1) * gather_or_scatter_volume(p, buf)


def layer_volume(ls: LayerShape, tokens: int, d: Decomposition, *,
                 overlap: Optional[OverlapConfig] = None,
                 include_data_parallel: bool = True,
                 gradsync: Optional[GradSyncConfig] = None,
                 microbatches: int = 1) -> float:
    """Per-GPU per-iteration volume (elements) for one layer, fwd+bwd.

    ``tokens`` is the *global* batch in tokens (B*S). Paper Eqs. 2-4 are the
    ``g_z = 1`` specialization of this function.

    ``overlap.cache_weight_gather`` drops the backward re-gather of the
    weight (one AG_z per layer). The ring decompositions themselves move
    the same bytes as the blocking collectives, so the other overlap knobs
    do not change *volume* — only :func:`predict_step_time` sees them.
    ``gradsync``/``microbatches`` switch the DP term to the bucketed
    schedule of :func:`dp_sync_volume` (streamed reduce-scatters *do*
    change volume: one RS per microbatch).
    """
    g = layer_geometry(ls, tokens, d, overlap)
    # fwd all-reduce of partial outputs over the contraction axis (Eq. 2)
    v_fp = allreduce_volume(g.gx, g.ar_fwd_buf)
    # bwd all-reduce of dX over the output axis (Eq. 3)
    v_bp = allreduce_volume(g.gy, g.ar_bwd_buf)
    # z-axis weight collectives (4D): AG fwd (+AG bwd if not cached) + RS bwd
    v_z = (g.n_gathers + 1) * gather_or_scatter_volume(d.g_z,
                                                       g.w_full_per_xy)
    # context-parallel KV ring (5th axis): the attention circulates each
    # seq-rank's KV block around the ring in the forward and its
    # gradients back in the backward — 2 ring_exchange passes
    v_seq = 2.0 * ring_exchange_volume(d.g_seq, g.seq_buf)
    # expert-parallel token exchange (6th axis): dispatch + combine
    # all-to-all in the forward, mirrored in the backward — 4 passes of
    # the per-rank dispatch buffer
    v_ex = 4.0 * all_to_all_volume(d.g_expert, g.a2a_buf)
    # data-parallel gradient sync (the text measures it as 1e-3 of the
    # tensor terms but we keep it for completeness); weight grads are
    # additionally summed over seq (params replicate across it) and —
    # for dense layers — over expert (the expert bank itself is sharded
    # over g_expert, so its grads need no expert-axis sync)
    v_dp = 0.0
    if include_data_parallel:
        v_dp = dp_sync_volume(d.g_data, g.dp_buf, gradsync, microbatches)
        v_dp += allreduce_volume(d.g_seq, g.dp_buf)
        if not ls.expert:
            v_dp += allreduce_volume(d.g_expert, g.dp_buf)
    return ls.count * (v_fp + v_bp + v_z + v_seq + v_ex + v_dp)


def model_volume(layers: Sequence[LayerShape], tokens: int, d: Decomposition,
                 **kw) -> float:
    return sum(layer_volume(ls, tokens, d, **kw) for ls in layers)


def model_flops_per_token(cfg, mode: str = "train") -> float:
    """Model FLOPs one token costs: ``2 * N_active`` per forward pass
    (one multiply + one add per active parameter), tripled for training
    (forward + the two backward GEMMs per forward GEMM). MoE counts only
    the routed top-k + shared experts (``cfg.active_param_count``).

    Single source for both ``roofline.model_flops_per_device`` (HLO
    useful-flop ratio) and the telemetry MFU
    (``launch/telemetry.Telemetry``); tests/test_telemetry.py
    cross-checks the two against a hand-counted config."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    n = float(cfg.active_param_count())
    return (6.0 if mode == "train" else 2.0) * n


# ---------------------------------------------------------------------- #
# Closed forms from the paper (for tests / sanity checks)
# ---------------------------------------------------------------------- #

def transformer_layers(hidden: int, n_layers: int = 1,
                       ffn_mult: int = 4) -> List[LayerShape]:
    """Paper Table 1: the four FC layers of a transformer block."""
    h = hidden
    return [
        LayerShape(h, 3 * h, transposed=False, count=n_layers),
        LayerShape(h, h, transposed=True, count=n_layers),
        LayerShape(h, ffn_mult * h, transposed=False, count=n_layers),
        LayerShape(ffn_mult * h, h, transposed=True, count=n_layers),
    ]


def paper_transformer_volume(tokens: int, hidden: int, g: int,
                             g_x: int, g_y: int) -> float:
    """Eq. 6: V = 8*B*H/G * ((G_c - 1) + 3*(G_r - 1)).

    Here paper's (G_r, G_c) == our (g_x, g_y); paper's B is tokens.
    """
    return 8.0 * tokens * hidden / g * ((g_y - 1) + 3 * (g_x - 1))


def paper_optimal_gc(g_tensor: int) -> float:
    """Eq. 7: G_c = sqrt(3 * G_tensor)."""
    return math.sqrt(3.0 * g_tensor)


# ---------------------------------------------------------------------- #
# α-β (latency + bandwidth) overlap-aware time model
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class HardwareParams:
    """Link/compute constants for the step-time predictor.

    Units — ``alpha``: seconds per ring hop (link latency);
    ``gamma``: seconds per collective *call* (launch/dispatch overhead,
    LogGP's ``o``; hop-count-independent — on CPU backends it dominates
    α, on ring interconnects α dominates); ``link_bw``: bytes/s of
    per-device injection bandwidth; ``flops``: FLOP/s achievable matmul
    rate; ``bytes_per_elem``: wire bytes per model element (2.0 = bf16);
    ``overlap_efficiency``: the fraction of a layer's GEMM time the
    scheduler can actually use to hide ring traffic (1.0 = perfect
    latency hiding; real schedulers lose some to chunk-boundary
    bubbles).

    ``z_claims_first`` orders the overlap-window claims in
    :func:`layer_time`: True (default, the PR-2 assumption) lets the
    z-axis weight rings hide before the x/y activation all-reduce
    rings; False swaps the order. ``cross_step_efficiency`` scales the
    cross-step window of :func:`dp_sync_time` (1.0 = the terminal
    collectives hide fully, the PR-4 model).

    Defaults are *guessed* TPU v5e constants (launch/roofline.py uses
    the same ones); ``core/calibrate.py`` fits measured replacements
    from the live backend and the ``--calib`` CLI flags load them. The
    defaults are the uncalibrated degenerate point: every new field's
    default reproduces the pre-calibration model bitwise.
    """

    alpha: float = 1e-6
    gamma: float = 0.0
    link_bw: float = 50e9
    flops: float = 197e12
    bytes_per_elem: float = 2.0
    overlap_efficiency: float = 0.8
    z_claims_first: bool = True
    cross_step_efficiency: float = 1.0
    # HBM bandwidth (bytes/s), read ONLY by the serving-capacity model
    # (:func:`serve_capacity` — decode is memory-bound on the KV-cache
    # read, not FLOP-bound). No training-path prediction touches it, so
    # its default keeps every pre-serving result bitwise (the degeneracy
    # discipline of this docstring). v5e HBM ≈ 819 GB/s.
    mem_bw: float = 819e9


TPU_V5E = HardwareParams()


def collective_time(kind: str, p: int, buf: float,
                    hw: HardwareParams) -> float:
    """α-β time of one bandwidth-optimal (ring) collective.

    ``buf`` is in elements: the reduced buffer for ``all_reduce``, the
    full gathered buffer for ``all_gather``/``reduce_scatter`` — the same
    conventions as the volume functions above, which supply the byte
    term; the α term charges one hop per ring step (AR = 2(p-1) steps,
    AG/RS = p-1), the γ term one launch per collective call."""
    if p <= 1:
        return 0.0
    if kind == "all_reduce":
        vol, steps = allreduce_volume(p, buf), 2 * (p - 1)
    elif kind in ("all_gather", "reduce_scatter"):
        vol, steps = gather_or_scatter_volume(p, buf), p - 1
    elif kind == "ring_exchange":
        # seq-axis KV circulation: p-1 ppermute hops of a FULL per-rank
        # block (no 1/p factor) — β-heavier per element than AG/RS at
        # the same hop count, which is why it has its own α-β-γ class
        # in core/calibrate.py rather than reusing the gather fit
        vol, steps = ring_exchange_volume(p, buf), p - 1
    elif kind == "all_to_all":
        # expert dispatch/combine: (p-1)/p of the buffer crosses the
        # wire (each rank keeps its own block), in p-1 pairwise
        # exchanges under the ring decomposition — AG/RS wire geometry,
        # but its own fitted class (the pairwise pattern stresses
        # links differently than a hop chain; core/calibrate.py)
        vol, steps = all_to_all_volume(p, buf), p - 1
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return (hw.gamma + hw.alpha * steps
            + vol * hw.bytes_per_elem / hw.link_bw)


@dataclasses.dataclass(frozen=True)
class StepTime:
    """Predicted per-device step time, decomposed.

    ``hidden_comm`` is communication that rides under compute (the ring-
    decomposed z collectives when overlap is on); only ``exposed_comm``
    adds wall-clock time."""

    compute: float
    exposed_comm: float
    hidden_comm: float

    @property
    def total(self) -> float:
        return self.compute + self.exposed_comm

    def __add__(self, o: "StepTime") -> "StepTime":
        return StepTime(self.compute + o.compute,
                        self.exposed_comm + o.exposed_comm,
                        self.hidden_comm + o.hidden_comm)


ZERO_TIME = StepTime(0.0, 0.0, 0.0)


def dp_sync_time(p: int, buf: float,
                 gradsync: Optional[GradSyncConfig],
                 microbatches: int, hw: HardwareParams
                 ) -> Tuple[float, float]:
    """(total, hideable) α-β time of one layer's DP param/gradient sync.

    Blocking: one all-reduce, nothing hideable (it runs after the whole
    microbatch loop). Bucketed/ZeRO-1: each streamed microbatch pays one
    reduce-scatter pass of ``ceil(buf·bytes / bucket_bytes)`` ring
    buckets — the bucket count is the α-latency knob: smaller buckets
    mean finer overlap grain but more ring launches — plus the final
    all-gather. The RS passes of the first ``microbatches - 1``
    microbatches are *hideable*: each rides under the next microbatch's
    backward (the last RS and the all-gather have no later compute in
    the step to hide behind). Only ring mode is hideable — the blocking
    psum_scatter is a synchronizing collective.

    ZeRO-3 (``zero3``): ``dp_sync_volume``'s per-microbatch AG/RS passes
    stream *per layer* through the scan, so every pass except the step's
    first param gather (nothing earlier to ride under) and the last
    gradient RS (nothing later) is hideable under the layer compute
    window.

    ``cross_step`` widens the window across the step boundary: the
    terminal collectives — the ZeRO-1 param all-gather / ZeRO-3 leading
    param gather (they hide under the NEXT step's first-microbatch
    forward) and the last RS pass (it hides under the optimizer math) —
    become hideable too. With ``cross_step`` off this function is
    exactly the PR-3 exposed model, and with α = 0 and nothing hideable
    (one microbatch, or ``stream`` off) the total reduces exactly to
    ``dp_sync_volume · bytes / bw`` — degeneracies
    tests/test_gradsync.py and tests/test_zero3.py pin."""
    if p <= 1:
        return 0.0, 0.0
    if gradsync is None or not gradsync.enabled:
        return collective_time("all_reduce", p, buf, hw), 0.0
    n_buckets = max(1, math.ceil(buf * hw.bytes_per_elem
                                 / max(gradsync.bucket_bytes, 1)))
    t_pass = ((hw.gamma + hw.alpha * (p - 1)) * n_buckets
              + gather_or_scatter_volume(p, buf)
              * hw.bytes_per_elem / hw.link_bw)
    if gradsync.zero3:
        per_mb = 2 if gradsync.prefetch else 3
        total = microbatches * per_mb * t_pass
        hideable = 0.0
        if gradsync.ring:
            # all per-layer streams ride the scan except the leading
            # param gather and the trailing gradient reduce-scatter
            hideable = total - 2 * t_pass
            if gradsync.cross_step:
                # spelled so efficiency 1.0 gives `total` bitwise (the
                # pre-calibration model) and 0.0 the cross_step=False one
                hideable = total - ((1.0 - hw.cross_step_efficiency)
                                    * 2 * t_pass)
        return total, hideable
    n = microbatches if gradsync.stream else 1
    total = (n + 1) * t_pass  # n RS passes + the AG rebroadcast
    hideable = (n - 1) * t_pass if (gradsync.ring and gradsync.stream
                                    and microbatches > 1) else 0.0
    if gradsync.cross_step and gradsync.ring:
        # cross-step window: the param/gradient all-gather hides under
        # the next step's first-microbatch forward, the last RS pass
        # under the optimizer math — scaled by the *measured* fraction
        # of that window (calibrate.cross_step_probe; 1.0 uncalibrated)
        hideable = hideable + hw.cross_step_efficiency * 2 * t_pass
    return total, hideable


def layer_time(ls: LayerShape, tokens: int, d: Decomposition,
               hw: HardwareParams = TPU_V5E, *,
               overlap: Optional[OverlapConfig] = None,
               include_data_parallel: bool = True,
               gradsync: Optional[GradSyncConfig] = None,
               microbatches: int = 1) -> StepTime:
    """Overlap-aware α-β time of one layer, fwd+bwd (cf. layer_volume).

    Compute: 3 GEMMs (fwd Y, bwd dX, bwd dW) of 2·m·k·n/(gx·gy) flops
    each. The activation all-reduces are priced as 2(p-1)-hop rings
    (Eqs. 2-3 buffers); with ``overlap.all_reduce`` their ring
    decomposition hides under whatever part of the
    ``overlap_efficiency``-scaled compute window the z weight rings
    (``overlap.matmul``) left over — the z collectives hide first by
    default, since their rings pipeline against the very GEMM that
    consumes/produces the weight (``hw.z_claims_first=False``, set when
    ``calibrate.overlap_probe`` measures the opposite, swaps the claim
    order). With ``gradsync`` streaming (core/gradsync.py) the DP
    reduce-scatter rings claim whatever window is left after z and the
    activation ARs (:func:`dp_sync_time`: the last microbatch's RS and
    the param all-gather stay exposed). Blocking mode keeps every
    collective fully exposed (overdecomposition overlaps them *across*
    batch shards; that is a step-level effect the dry-run measures, not
    modeled here)."""
    g = layer_geometry(ls, tokens, d, overlap)
    t_compute = 6.0 * g.m_local * ls.k * ls.n / (g.gx * g.gy) / hw.flops
    # activation all-reduces (Eqs. 2-3): 2(p-1) α-β ring steps each
    t_act = (collective_time("all_reduce", g.gx, g.ar_fwd_buf, hw)
             + collective_time("all_reduce", g.gy, g.ar_bwd_buf, hw))
    # z-axis weight collectives (AG fwd [+AG bwd] + RS bwd)
    t_z = (g.n_gathers
           * collective_time("all_gather", d.g_z, g.w_full_per_xy, hw)
           + collective_time("reduce_scatter", d.g_z, g.w_full_per_xy, hw))
    # seq-axis KV ring (fwd + bwd circulation) and the seq grad
    # all-reduce; the latter is a step-end psum like blocking DP —
    # never hideable here
    t_seq = 2.0 * collective_time("ring_exchange", d.g_seq, g.seq_buf, hw)
    t_seq_grad = (collective_time("all_reduce", d.g_seq, g.dp_buf, hw)
                  if include_data_parallel else 0.0)
    # expert-axis token exchange (dispatch + combine, fwd + bwd) and
    # the dense-layer grad all-reduce over expert (the expert bank is
    # sharded over the axis; dense params replicate and sync like a
    # second DP pass — step-end, never hideable)
    t_ex = (4.0 * collective_time("all_to_all", d.g_expert, g.a2a_buf, hw)
            if ls.a2a_width > 0 else 0.0)
    t_ex_grad = (collective_time("all_reduce", d.g_expert, g.dp_buf, hw)
                 if include_data_parallel and not ls.expert else 0.0)
    t_dp = dp_hideable = 0.0
    if include_data_parallel:
        t_dp, dp_hideable = dp_sync_time(d.g_data, g.dp_buf, gradsync,
                                         microbatches, hw)
    window = hw.overlap_efficiency * t_compute
    want_z = overlap is not None and overlap.matmul and d.g_z > 1
    want_ar = overlap is not None and overlap.all_reduce
    # hop i+1's KV permute issues before hop i's partial attention
    # (layers/attention.py seq_attn), so the ring rides the attention
    # compute itself — it claims the window after z and the activation
    # ARs (claim order z -> AR -> seq -> expert a2a -> DP, the same
    # measured-window discipline as the rest)
    want_seq = (overlap is not None and overlap.ring_attention
                and d.g_seq > 1 and ls.kv_ring_width > 0)
    # the ring-decomposed a2a's pairwise exchanges interleave with the
    # per-source expert GEMMs (collective_matmul.ring_a2a_expert), so
    # it hides in whatever window the earlier claims left
    want_ex = (overlap is not None and overlap.expert_a2a
               and d.g_expert > 1 and ls.a2a_width > 0)
    # window claim order: z weight rings first by default (they pipeline
    # against the very GEMM that consumes/produces the weight);
    # hw.z_claims_first=False swaps it — calibrate.overlap_probe measures
    # which ring actually hides better on the live backend
    if hw.z_claims_first:
        hidden_z = min(t_z, window) if want_z else 0.0
        hidden_ar = min(t_act, window - hidden_z) if want_ar else 0.0
    else:
        hidden_ar = min(t_act, window) if want_ar else 0.0
        hidden_z = min(t_z, window - hidden_ar) if want_z else 0.0
    hidden_seq = (min(t_seq, max(window - hidden_z - hidden_ar, 0.0))
                  if want_seq else 0.0)
    hidden_ex = (min(t_ex, max(window - hidden_z - hidden_ar - hidden_seq,
                               0.0))
                 if want_ex else 0.0)
    hidden_dp = min(dp_hideable,
                    max(window - hidden_z - hidden_ar - hidden_seq
                        - hidden_ex, 0.0))
    hidden = hidden_z + hidden_ar + hidden_seq + hidden_ex + hidden_dp
    exposed = (t_act + t_z + t_seq + t_seq_grad + t_ex + t_ex_grad + t_dp
               - hidden)
    return StepTime(ls.count * t_compute, ls.count * exposed,
                    ls.count * hidden)


def predict_step_time(layers: Sequence[LayerShape], tokens: int,
                      d: Decomposition, hw: HardwareParams = TPU_V5E, *,
                      overlap: Optional[OverlapConfig] = None,
                      include_data_parallel: bool = True,
                      gradsync: Optional[GradSyncConfig] = None,
                      microbatches: int = 1) -> StepTime:
    """Per-device per-iteration predicted time for a layer list (§5's
    analytical model, upgraded from volume to overlap-aware α-β time).

    With ``overlap=None`` (or all knobs off) and ``hw.alpha == 0`` the
    exposed-communication term equals
    ``model_volume(...) * hw.bytes_per_elem / hw.link_bw`` exactly —
    including the bucketed DP path of ``gradsync``, whose streamed
    microbatch reduce-scatters only become *hidden* when there is a
    later microbatch backward to ride under (``microbatches > 1`` with
    ``stream``/``ring`` on; :func:`dp_sync_time`), the ZeRO-3
    param-shard streams (per-layer gather/RS rides the scan; only the
    terminal passes stay exposed), and the ``cross_step`` window that
    hides exactly those terminal passes across the step boundary.
    """
    out = ZERO_TIME
    for ls in layers:
        out = out + layer_time(ls, tokens, d, hw, overlap=overlap,
                               include_data_parallel=include_data_parallel,
                               gradsync=gradsync, microbatches=microbatches)
    return out


# ---------------------------------------------------------------------- #
# Serving capacity (decode-time) model
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ServeCapacity:
    """Predicted steady-state continuous-batching decode capacity.

    ``step`` is one decode iteration over every layer (forward-only α-β
    time, KV reads included in compute); ``kv_time`` is the HBM time of
    the paged KV-cache reads alone (the memory-bound decode term);
    ``tokens_per_s`` = batch / step.total (each iteration emits one
    token per active slot); ``step_latency_ms`` is the per-token decode
    latency a request observes."""

    step: StepTime
    kv_time: float
    batch: int
    context: int

    @property
    def tokens_per_s(self) -> float:
        return self.batch / max(self.step.total, 1e-30)

    @property
    def step_latency_ms(self) -> float:
        return self.step.total * 1e3


def serve_layer_time(ls: LayerShape, batch: int, d: Decomposition,
                     hw: HardwareParams = TPU_V5E, *, context: int,
                     overlap: Optional[OverlapConfig] = None
                     ) -> Tuple[StepTime, float]:
    """Forward-only α-β time of one layer for a decode iteration of
    ``batch`` single-token rows against ``context`` cached tokens.

    Reuses :func:`layer_geometry` with tokens = batch (m_local = the
    shard's active slots), so the same calibrated α/β/γ constants price
    the collectives. Differences from :func:`layer_time`, all decode
    facts: ONE GEMM (2·m·k·n flops, no backward); one fwd partial-output
    all-reduce over gx (γ-dominated at decode sizes — the buffer is a
    few KB, so the launch overhead IS the cost, which is why calibrated
    γ matters more here than anywhere in training); one z weight
    all-gather (batch-independent — the price of co-sharding weights
    over z at tiny m); and a KV-read term ``m_local · context ·
    kv_ring_width / g_y`` elements from HBM at ``hw.mem_bw`` on layers
    that carry KV (``kv_ring_width > 0``, the QKV projection). The
    overlap window claims z rings then activation ARs, scaled by the
    same measured ``overlap_efficiency``."""
    g = layer_geometry(ls, batch, d, overlap)
    t_compute = 2.0 * g.m_local * ls.k * ls.n / (g.gx * g.gy) / hw.flops
    t_kv = (g.m_local * context * ls.kv_ring_width / g.gy
            * hw.bytes_per_elem / hw.mem_bw)
    t_act = collective_time("all_reduce", g.gx, g.ar_fwd_buf, hw)
    t_z = collective_time("all_gather", d.g_z, g.w_full_per_xy, hw)
    window = hw.overlap_efficiency * (t_compute + t_kv)
    want_z = overlap is not None and overlap.matmul and d.g_z > 1
    want_ar = overlap is not None and overlap.all_reduce
    if hw.z_claims_first:
        hidden_z = min(t_z, window) if want_z else 0.0
        hidden_ar = min(t_act, window - hidden_z) if want_ar else 0.0
    else:
        hidden_ar = min(t_act, window) if want_ar else 0.0
        hidden_z = min(t_z, window - hidden_ar) if want_z else 0.0
    hidden = hidden_z + hidden_ar
    exposed = t_act + t_z - hidden
    return (StepTime(ls.count * (t_compute + t_kv), ls.count * exposed,
                     ls.count * hidden),
            ls.count * t_kv)


def serve_capacity(layers: Sequence[LayerShape], batch: int,
                   d: Decomposition, hw: HardwareParams = TPU_V5E, *,
                   context: int,
                   overlap: Optional[OverlapConfig] = None
                   ) -> ServeCapacity:
    """Predict continuous-batching decode capacity for a mesh: the
    serving analogue of :func:`predict_step_time` (docs/serving.md).

    ``layers`` is the arch's ``comm_layers()`` list, ``batch`` the
    engine's active slot count (tokens per decode iteration), ``context``
    the mean cached tokens per slot (prompt + half the generation is the
    steady-state average). Throughput ranks meshes — validated against
    the measured open-loop benchmark via Spearman rank correlation
    (EXPERIMENTS.md §Serving), exactly how the training model was
    validated in fig5_measured."""
    step, kv = ZERO_TIME, 0.0
    for ls in layers:
        st, k = serve_layer_time(ls, batch, d, hw, context=context,
                                 overlap=overlap)
        step, kv = step + st, kv + k
    return ServeCapacity(step=step, kv_time=kv, batch=batch,
                         context=context)


# ---------------------------------------------------------------------- #
# Decomposition optimizer
# ---------------------------------------------------------------------- #

def _divisors(n: int) -> List[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Divisibility / memory constraints for a real model."""

    global_batch: int = 0          # g_data * g_z must divide it (0 = skip)
    max_x: int = 0                 # e.g. d_model shard limit (0 = unbounded)
    max_y: int = 0                 # e.g. num_kv_heads (0 = unbounded)
    min_tensor: int = 1            # memory floor: params must fit
    x_divides: Tuple[int, ...] = ()  # dims that g_x must divide
    y_divides: Tuple[int, ...] = ()
    z_divides: Tuple[int, ...] = ()
    # context parallelism: largest g_seq the search may use (1, the
    # default, keeps the 4-factor enumeration byte-identical) and the
    # dims g_seq must divide (the sequence length)
    max_seq: int = 1
    seq_divides: Tuple[int, ...] = ()
    # expert parallelism: largest g_expert the search may use (1, the
    # default, keeps the 5-factor enumeration byte-identical) and the
    # dims g_expert must divide (the routed expert count)
    max_expert: int = 1
    expert_divides: Tuple[int, ...] = ()


def enumerate_decompositions(g: int, c: Constraints = Constraints()
                             ) -> Iterable[Decomposition]:
    for g_data in _divisors(g):
        rem = g // g_data
        for g_x in _divisors(rem):
            rem2 = rem // g_x
            for g_z in _divisors(rem2):
                rem3 = rem2 // g_z
                for g_seq in _divisors(rem3):
                    if g_seq > max(c.max_seq, 1):
                        continue
                    rem4 = rem3 // g_seq
                    for g_expert in _divisors(rem4):
                        if g_expert > max(c.max_expert, 1):
                            continue
                        g_y = rem4 // g_expert
                        d = Decomposition(g_data, g_x, g_y, g_z, g_seq,
                                          g_expert)
                        if d.g_tensor < c.min_tensor:
                            continue
                        # the batch shards over data x z x expert
                        if c.global_batch and c.global_batch % (
                                g_data * g_z * g_expert):
                            continue
                        if c.max_x and g_x > c.max_x:
                            continue
                        if c.max_y and g_y > c.max_y:
                            continue
                        if any(dim % g_x for dim in c.x_divides):
                            continue
                        if any(dim % g_y for dim in c.y_divides):
                            continue
                        if any(dim % g_z for dim in c.z_divides):
                            continue
                        if any(dim % g_seq for dim in c.seq_divides):
                            continue
                        if any(dim % g_expert for dim in c.expert_divides):
                            continue
                        yield d


def optimize_decomposition(layers: Sequence[LayerShape], tokens: int, g: int,
                           constraints: Constraints = Constraints(),
                           top_k: int = 1, *, objective: str = "volume",
                           hw: Optional[HardwareParams] = None, **kw
                           ) -> List[Tuple[Decomposition, float]]:
    """Exhaustively rank decompositions (paper §5.2 does this analytically
    for transformers; we do it for arbitrary layer lists, which is what
    the paper's 'general model' promises).

    ``objective='volume'`` scores by modeled per-device element volume
    (the paper's Eq. 5 criterion); ``objective='time'`` by the α-β
    overlap-aware :func:`predict_step_time` total — which additionally
    sees latency (penalizing needlessly deep rings) and the overlap knobs
    (``overlap=OverlapConfig(...)`` in ``kw`` hides z traffic under
    compute, making z-heavier decompositions cheaper than volume alone
    suggests)."""
    if objective == "time":
        hw = hw or TPU_V5E

        def score(d):
            return predict_step_time(layers, tokens, d, hw, **kw).total
    elif objective == "volume":
        if hw is not None:
            raise ValueError("hw is only meaningful with objective='time' "
                             "(the volume model has no hardware terms)")

        def score(d):
            return model_volume(layers, tokens, d, **kw)
    else:
        raise ValueError(f"unknown objective {objective!r}")
    scored = [(d, score(d)) for d in enumerate_decompositions(g, constraints)]
    if not scored:
        raise ValueError(f"no feasible decomposition of {g} devices under "
                         f"{constraints}")
    scored.sort(key=lambda t: (t[1], t[0].g_tensor))
    return scored[:top_k]


def megatron_decomposition(g: int, g_tensor: int) -> Decomposition:
    """The text's observation: G_c = G_tensor (1D TP) == Megatron-LM.
    (G_c is our g_y: column-parallel QKV, row-parallel projections.)"""
    return Decomposition(g // g_tensor, 1, g_tensor, 1)


def cai3d_decomposition(g: int, g_tensor: int) -> Optional[Decomposition]:
    """Colossal-AI-3D: symmetric cube over the tensor group."""
    cube = round(g_tensor ** (1 / 3))
    if cube ** 3 != g_tensor:
        return None
    return Decomposition(g // g_tensor, cube, cube, cube)
