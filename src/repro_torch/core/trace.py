"""Named-scope trace attribution for the port's collective schedules (port
of ``repro.core.trace``).

Every ring schedule of the port (the z weight rings and x/y activation
all-reduce rings of ``core/collective_matmul.py``, the ring helpers of
``core/mesh.py``, the data-parallel bucket rings and ZeRO-3 gathers of
``core/gradsync.py``, the seq ring of ``layers/attention.py``, the
embedding's z gather) is a chain of anonymous gloo sends. A profile of a
step cannot say which schedule a hop belongs to unless the code names it.

:func:`scope` names it: a context manager or decorator that enters
``torch.profiler.record_function(name)`` (a range in a
``torch.profiler.profile`` trace, the counterpart of the reference's
``jax.named_scope`` plus ``TraceAnnotation``) and pushes the name on this
thread's stack, whose innermost name :func:`current` returns
(``launch/roofline.record_collectives`` tags each collective with it).
The stack is per thread: autograd runs a CUDA backward on a thread of its
own, where the backward rings open their scopes. The names are the
reference's, the ``comm_model`` collective classes:

    ring_ag[z]/hop2          z weight all-gather ring, hop 2
    ring_rs[z]/hop0          z weight-grad reduce-scatter ring
    ring_ar[x]/exchange      x activation all-reduce (p=2 fast path)
    dp_rs/bucket3            DP gradient bucket 3's reduce-scatter
    zero3_ag[data]/leaf7     ZeRO-3 just-in-time gather of leaf 7
    ring_exchange[seq]/hop1  ring-attention KV circulation, hop 1
    embed_gather[z]          embedding-table z gather

**Nothing when disabled** (the default): :func:`scope` returns one shared
no-op object, which enters no range, allocates nothing and reads no
clock, so the port's outputs are bit for bit those with tracing on.
Enable with :func:`enable` or ``REPRO_TRACE=1`` in the environment;
``train.py --profile-steps`` enables it before the first step. The
decorator form binds at decoration time, as in the reference; the sites
of this package use the ``with`` form.
"""
from __future__ import annotations

import functools
import os
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

AxisLike = Union[None, str, Sequence[str]]

_ENABLED = os.environ.get("REPRO_TRACE", "").strip() not in ("", "0")
# this thread's open scopes, outermost first (``_LOCAL.stack``)
_LOCAL = threading.local()


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn scope emission on (or back off), for scopes opened after the
    call."""
    global _ENABLED
    _ENABLED = bool(on)


def _axis_str(axis: AxisLike) -> str:
    if axis is None:
        return ""
    if isinstance(axis, (tuple, list)):
        return "+".join(str(a) for a in axis)
    return str(axis)


def label(kind: str, axis: AxisLike = None, detail: Optional[str] = None
          ) -> str:
    """``kind[axis]/detail`` — the scope naming convention
    (docs/telemetry.md). ``axis`` may be a mesh axis name or a tuple of
    names (flattened rings render as ``a+b``); both parts optional."""
    name = kind
    s = _axis_str(axis)
    if s:
        name += f"[{s}]"
    if detail:
        name += f"/{detail}"
    return name


def current() -> Optional[str]:
    """The innermost scope open on this thread, or None."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def snapshot() -> Tuple[str, ...]:
    """This thread's open scopes, outermost first."""
    return tuple(getattr(_LOCAL, "stack", None) or ())


class restored:
    """Run a block under the scopes ``snap`` (:func:`snapshot`) in place of
    this thread's own, with no profiler range: work posted later on behalf
    of an earlier scope (a ring hop that gloo posts when it is waited for)
    is attributed to the scope it was made in."""

    __slots__ = ("snap", "_saved")

    def __init__(self, snap: Tuple[str, ...]):
        self.snap, self._saved = snap, None

    def __enter__(self):
        self._saved = getattr(_LOCAL, "stack", None)
        _LOCAL.stack = list(self.snap)

    def __exit__(self, *exc):
        _LOCAL.stack = self._saved
        return False


class _NullScope:
    """Shared no-op: nothing enters ``record_function``, so a run under
    it is bit for bit the uninstrumented one."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


_NULL = _NullScope()


class _Scope:
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self.name)
        return self.name

    def __exit__(self, *exc):
        _LOCAL.stack.pop()
        rng, self._range = self._range, None
        return rng.__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Scope(self.name):
                return fn(*args, **kwargs)
        return wrapped


def scope(kind: str, axis: AxisLike = None, detail: Optional[str] = None):
    """Context manager / decorator naming everything run inside it
    ``label(kind, axis, detail)``. A shared no-op when disabled."""
    if not _ENABLED:
        return _NULL
    return _Scope(label(kind, axis, detail))
