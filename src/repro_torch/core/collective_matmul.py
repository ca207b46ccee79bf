"""Ring-decomposed collective matmuls: the overlapped z-axis schedule and
the decomposed x/y activation all-reduces (port of
``repro.core.collective_matmul``'s dense half).

The blocking schedule of ``core/parallel.py`` gathers a weight over z and
then runs one GEMM, or runs one GEMM and then reduce-scatters its output.
Here each of those collectives is a ring of hops (``mesh.Hop``), and each
hop's block feeds a GEMM of its own (kernel K1, ``ops.matmul``, on views
of the operands): a hop is posted before the GEMM on the block in hand is
queued, so the block crosses gloo while the card runs that GEMM.

Ring convention (``mesh.ring_perm``): send right, so after ``s`` hops rank
``i`` holds the block that rank ``(i - s) mod p`` started with. Four
patterns:

  * place      - the gathered dim is the GEMM's output dim:
                 ``out[..., slot_j] = mm(block_j)``
  * accumulate - the gathered dim is the GEMM's contraction dim:
                 ``out = sum_j mm(lhs[..., seg_j], block_j)``
  * reduce-scatter - the scattered dim is the GEMM's output dim: the
                 partial sum for block j rides the ring and each rank adds
                 its GEMM's slice as it passes (``recv + g``)
  * all-reduce - the activation all-reduce of a tp matmul: a
                 reduce-scatter ring fed slice by slice by the GEMM, cast,
                 then an all-gather ring; p == 2 is one exchange (``y +
                 recv``, bitwise the psum), and a reduced dim that does
                 not split over p falls back to the blocking psum.

``chunks > 1`` splits each rank's block into that many sub-rings
(``OverlapConfig.z_chunks`` / ``ar_chunks``), rounded down to a divisor by
:func:`effective_chunks`. Partials are fp32 (K1's ``out_dtype``) and are
summed in the reference's order, so a ring matches the blocking schedule
within fp32 reassociation; the place ring and the gathers are pure data
movement. ``p == 1`` is the plain GEMM.

With tracing on (``core/trace.py``) the rings open the reference's scopes:
``ring_ag[name]/hop{s}`` around each step of the place and accumulate
rings, ``ring_rs[name]/hop{s}`` and ``ring_rs[name]/local`` in the
reduce-scatter ring, ``ring_ar[name]/exchange`` and ``ring_ar[name]``,
and ``gemm/chunk{q}`` around each hop's GEMM. A hop's send belongs to the
scope it is made in (``mesh.Hop``). The dX and dW rings of
``core/parallel.py``'s backwards are these drivers, so they open the same
scopes on autograd's thread. The batched (per-expert) rings
and ``ring_a2a_expert`` wait for the MoE layers (ROADMAP.md §1 item 'MoE
and the expert axis').
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import mesh as M
from repro_torch.core import trace
from repro_torch.kernels import ops


def effective_chunks(width: int, chunks: int) -> int:
    """Largest c <= chunks dividing width (so odd shards never error)."""
    c = max(1, min(chunks, width))
    while width % c:
        c -= 1
    return c


def _gemm(a, b, *, out_dtype=None, plain: bool = False):
    """(..., k) @ (k, n) -> (..., n) through K1, b possibly a view."""
    out = ops.matmul(a.reshape(-1, a.shape[-1]), b, out_dtype=out_dtype,
                     plain=plain)
    return out.reshape(*a.shape[:-1], b.shape[-1])


# ---------------------------------------------------------------------- #
# generic drivers
# ---------------------------------------------------------------------- #

def ring_place(block, axes: M.MeshAxes, name, mm: Callable, *, gdim: int,
               chunks: int = 1):
    """``concat_j mm(block_of_rank_j)`` along the output's last dim: rank
    j's block lands at slot j, its pieces in slice order within the slot
    (the layout of gathering the blocks and then running one GEMM)."""
    p, _ = M.flat_ring_axis(axes, name)
    if p == 1:
        return mm(block)
    idx = M.flat_ring_index(axes, name)
    gdim %= block.dim()
    chunks = effective_chunks(block.shape[gdim], chunks)
    m = block.shape[gdim] // chunks
    curs = [(block.narrow(gdim, q * m, m), None) for q in range(chunks)]
    out = None
    for s in range(p):
        with trace.scope("ring_ag", name, f"hop{s}"):
            j = (idx - s) % p
            hops = ([M.Hop(c, axes, name, host=h) for c, h in curs]
                    if s < p - 1 else [])
            for q, (cur, _) in enumerate(curs):
                with trace.scope("gemm", None, f"chunk{q}"):
                    y = mm(cur)
                if out is None:
                    w = y.shape[-1]
                    out = y.new_empty((*y.shape[:-1], p * chunks * w))
                out[..., (j * chunks + q) * w:(j * chunks + q + 1) * w] = y
            curs = [(h.wait(), h.recv) for h in hops]
    return out


def ring_accumulate(lhs, block, axes: M.MeshAxes, name, mm: Callable, *,
                    gdim: int, ldim: int = -1, chunks: int = 1):
    """``sum_j mm(lhs_seg_j, block_of_rank_j)``, the gathered dim the
    contraction: rank j's piece q contracts with ``lhs``'s segment ``(j
    chunks + q)`` of ``ldim``. ``mm`` returns fp32; the partials are
    summed in hop order."""
    p, _ = M.flat_ring_axis(axes, name)
    if p == 1:
        return mm(lhs, block)
    idx = M.flat_ring_index(axes, name)
    gdim %= block.dim()
    ldim %= lhs.dim()
    chunks = effective_chunks(block.shape[gdim], chunks)
    m = block.shape[gdim] // chunks
    m_l = lhs.shape[ldim] // (p * chunks)
    curs = [(block.narrow(gdim, q * m, m), None) for q in range(chunks)]
    acc = None
    for s in range(p):
        with trace.scope("ring_ag", name, f"hop{s}"):
            j = (idx - s) % p
            hops = ([M.Hop(c, axes, name, host=h) for c, h in curs]
                    if s < p - 1 else [])
            for q, (cur, _) in enumerate(curs):
                seg = lhs.narrow(ldim, (j * chunks + q) * m_l, m_l)
                with trace.scope("gemm", None, f"chunk{q}"):
                    y = mm(seg, cur)
                acc = y if acc is None else acc + y
            curs = [(h.wait(), h.recv) for h in hops]
    return acc


def ring_reduce_scatter_mm(axes: M.MeshAxes, name, mm: Callable, *,
                           block_w: int, chunks: int = 1):
    """``psum_scatter(full contribution, name, dim=-1)`` where the full
    contribution never exists: ``mm(start, width)`` -> fp32 (..., width)
    is this rank's GEMM for that slice of the scattered dim, computed as
    the partial for its block passes through (p GEMMs and p - 1 hops per
    sub-ring). The next slice's GEMM is queued before the hop is waited
    for."""
    p, _ = M.flat_ring_axis(axes, name)
    if p == 1:
        return mm(0, block_w)
    idx = M.flat_ring_index(axes, name)
    chunks = effective_chunks(block_w, chunks)
    m = block_w // chunks
    outs = []
    for q in range(chunks):
        def start(s):      # the slice that leaves this rank at step s
            return ((idx - s) % p) * block_w + q * m
        with trace.scope("ring_rs", name, "hop0"):
            with trace.scope("gemm", None, f"chunk{q}"):
                part = mm(start(1), m)
        for s in range(1, p):
            # hop s - 1 carries the partial made so far while the GEMM of
            # the next slice (the rank's own, "local", after the last hop)
            # is queued
            last = s == p - 1
            with trace.scope("ring_rs", name, f"hop{s - 1}"):
                hop = M.Hop(part, axes, name)
            with trace.scope("ring_rs", name, "local" if last
                             else f"hop{s}"):
                with trace.scope("gemm", None, f"chunk{q}"):
                    g = mm(start(s + 1 if not last else 0), m)
                part = hop.wait() + g
        outs.append(part)
    return outs[0] if chunks == 1 else torch.cat(outs, dim=-1)


def ring_all_reduce_mm(axes: M.MeshAxes, name, mm: Callable, *, out_w: int,
                       dtype, chunks: int = 1):
    """``psum(full GEMM output, name)`` with the output made slice by
    slice for a reduce-scatter ring, cast to ``dtype`` and rebuilt by an
    all-gather ring. p == 2 is one full-width GEMM and one exchange
    (bitwise the blocking psum); a ring that does not split ``out_w``
    falls back to the blocking psum."""
    p, _ = M.flat_ring_axis(axes, name)
    if p == 1:
        return mm(0, out_w).to(dtype)
    if p == 2:
        with trace.scope("ring_ar", name, "exchange"):
            y = mm(0, out_w).to(dtype)
            return y + M.ppermute_ring(y, axes, name)
    if out_w % p:
        return M.psum(mm(0, out_w).to(dtype), axes, name)
    with trace.scope("ring_ar", name):
        scat = ring_reduce_scatter_mm(axes, name, mm, block_w=out_w // p,
                                      chunks=chunks).to(dtype)
        return M.ring_all_gather(scat, axes, name, dim=-1)


# ---------------------------------------------------------------------- #
# the dense primitives (called from core/parallel.py)
# ---------------------------------------------------------------------- #

def ag_matmul(x, w, axes: M.MeshAxes, name, *, chunks: int = 1,
              plain: bool = False):
    """``x @ AG_name(w, dim=1)`` (tp_matmul's forward): x (..., k), w (k,
    n_loc) -> (..., p n_loc) in x's dtype."""
    return ring_place(w, axes, name, lambda wb: _gemm(x, wb, plain=plain),
                      gdim=1, chunks=chunks)


def accum_matmul_dx(dy, w, axes: M.MeshAxes, name, *, chunks: int = 1,
                    plain: bool = False):
    """``dy @ AG_name(w, dim=1)^T`` (tp_matmul's dX) without the gathered
    weight: fp32 (..., k)."""
    def mm(seg, wb):
        return _gemm(seg, wb.t(), out_dtype=torch.float32, plain=plain)
    return ring_accumulate(dy, w, axes, name, mm, gdim=1, chunks=chunks)


def rs_matmul_dw(x2d, dy2d, axes: M.MeshAxes, name, *, block_w: int,
                 chunks: int = 1, plain: bool = False):
    """``RS_name(x^T @ dy, dim=1)`` (tp_matmul's dW): x2d (T, k), dy2d (T,
    n_use) -> fp32 (k, block_w), each block's GEMM reading a column slice
    of dy."""
    def mm(start, width):
        return ops.matmul(x2d.t(), dy2d.narrow(1, start, width),
                          out_dtype=torch.float32, plain=plain)
    return ring_reduce_scatter_mm(axes, name, mm, block_w=block_w,
                                  chunks=chunks)


def accum_matmul_tied(h, table, axes: M.MeshAxes, name, *, chunks: int = 1,
                      plain: bool = False):
    """The tied head's forward ``h @ AG_name(table, dim=1)^T``, the
    gathered (d) dim the contraction: h (..., d/x), table (V/y, d_loc) ->
    fp32 (..., V/y)."""
    def mm(seg, tb):
        return _gemm(seg, tb.t(), out_dtype=torch.float32, plain=plain)
    return ring_accumulate(h, table, axes, name, mm, gdim=1, chunks=chunks)


def ag_matmul_tied_dh(dlogits, table, axes: M.MeshAxes, name, *,
                      chunks: int = 1, plain: bool = False):
    """The tied head's dh ``dlogits @ AG_name(table, dim=1)``, the gathered
    dim the output: fp32 (..., d/x)."""
    def mm(tb):
        return _gemm(dlogits, tb, out_dtype=torch.float32, plain=plain)
    return ring_place(table, axes, name, mm, gdim=1, chunks=chunks)


def rs_matmul_tied_dt(dl2d, h2d, axes: M.MeshAxes, name, *, block_w: int,
                      chunks: int = 1, plain: bool = False):
    """The tied head's dtable ``RS_name(dlogits^T @ h, dim=1)``: dl2d (T,
    V/y), h2d (T, d/x) -> fp32 (V/y, block_w)."""
    def mm(start, width):
        return ops.matmul(dl2d.t(), h2d.narrow(1, start, width),
                          out_dtype=torch.float32, plain=plain)
    return ring_reduce_scatter_mm(axes, name, mm, block_w=block_w,
                                  chunks=chunks)


def ar_matmul(x, w, axes: M.MeshAxes, name, *, chunks: int = 1,
              plain: bool = False):
    """``psum_name(x @ w)`` with the activation all-reduce decomposed: x
    (..., c), w (c, n) -> (..., n) in x's dtype, each output slice made
    for its reduce-scatter hop."""
    def mm(start, width):
        return _gemm(x, w.narrow(1, start, width), out_dtype=torch.float32,
                     plain=plain)
    return ring_all_reduce_mm(axes, name, mm, out_w=w.shape[1],
                              dtype=x.dtype, chunks=chunks)


def ar_matmul_t(x, w, axes: M.MeshAxes, name, *, chunks: int = 1,
                plain: bool = False):
    """``psum_name(x @ w^T)``, the reduced dim indexing w's rows (tp_matmul's
    dX against the gathered weight; the tied head's forward): x (..., c),
    w (n, c) -> (..., n) in x's dtype."""
    def mm(start, width):
        return _gemm(x, w.narrow(0, start, width).t(),
                     out_dtype=torch.float32, plain=plain)
    return ring_all_reduce_mm(axes, name, mm, out_w=w.shape[0],
                              dtype=x.dtype, chunks=chunks)
