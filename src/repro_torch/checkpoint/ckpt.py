"""Checkpointing: the reference's ``.npz`` format (port of
``repro.checkpoint.ckpt``), read and written in both directions.

A checkpoint holds the JAX package's trees, global and layer-stacked,
keyed by JAX path: ``params/segments/seg0/pos0/mixer/wq``,
``opt_state/opt/<path>/m`` (``v``, ``master``), ``opt_state/step`` (an
int32 0-d array). ``convert.params_to_jax`` / ``opt_state_to_jax`` build
those trees from a rank's blocks, ``convert.load_params_from_jax`` /
``opt_state_from_jax`` take a rank's blocks back out of them, so a file
from either package restores in the other, on any mesh.

The ``__meta__`` member is the reference's JSON: ``step``, ``keys``,
``specs`` (``str(PartitionSpec)`` of every parameter leaf, the same
strings as the reference's), ``extra`` and the per-leaf crc32
``checksums``. Its ``treedef`` cannot be JAX's (the port has no ``jax``)
and nothing reads it: the port writes ``"repro_torch: nested dicts,
keys in 'keys'"`` there.

Robustness (the properties the elastic recovery loop leans on):

* **Atomic writes.** ``save`` serializes to a temp file in the target
  directory, fsyncs, then ``os.replace``s onto the final path — a crash
  mid-save leaves the previous checkpoint intact, never a half-written
  one. A stray ``*.tmp-*`` file is the only possible debris.
* **Per-leaf checksums.** Every leaf's crc32 is recorded in the meta
  block at save time and re-verified on restore, on top of the zip
  container's own member CRCs. Corruption errors are raised as
  :class:`CheckpointError` naming the offending leaf, never a raw
  deserialization traceback.
* **verify()** walks every leaf of a checkpoint without materializing
  the trees, so the recovery loop can vet a file before trusting it.

Checkpoints written by older versions (no ``checksums`` in meta) still
restore; only the extra verification layer is skipped.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

TREEDEF = "repro_torch: nested dicts, keys in 'keys'"


class CheckpointError(RuntimeError):
    """A checkpoint file is truncated, corrupt, or fails verification."""


def _flatten(tree) -> Dict[str, Any]:
    """A tree of nested dicts (keys in sorted order at each level, as JAX
    flattens them) -> {"a/b/c": leaf}."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv for kk, vv in _flatten(v).items()})
        else:
            flat[str(k)] = v
    return flat


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def spec_str(spec) -> str:
    """``str(jax.sharding.PartitionSpec(*spec))`` without JAX: a spec is a
    tuple of None, axis names and tuples of names."""
    return "PartitionSpec" + repr(tuple(spec))


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _resolve(path: str) -> str:
    # np.savez appends .npz to bare string paths; mirror that on the read
    # side so save/restore stay symmetric for extensionless callers.
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def _open(path: str):
    path = _resolve(path)
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
    except (zipfile.BadZipFile, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} is unreadable (truncated or corrupt "
            f"container): {type(e).__name__}: {e}") from e
    return data, meta


def _read_leaf(data, meta: dict, key: str) -> np.ndarray:
    """Read one member, converting container-level corruption into a
    CheckpointError that names the leaf, and re-checking our own crc."""
    try:
        arr = data[key]
    except KeyError:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError,
            EOFError) as e:
        raise CheckpointError(
            f"checkpoint leaf {key!r} is corrupt: "
            f"{type(e).__name__}: {e}") from e
    want = meta.get("checksums", {}).get(key)
    if want is not None:
        got = _crc(arr)
        if got != int(want):
            raise CheckpointError(
                f"checkpoint leaf {key!r} failed checksum verification "
                f"(recorded {int(want):#010x}, recomputed {got:#010x})")
    return arr


def save(path: str, params, opt_state=None, *, step: int = 0,
         pspecs=None, extra: Optional[dict] = None) -> None:
    """Write ``params`` (and ``opt_state``), nested dicts of numpy arrays
    keyed as the JAX trees, to ``path`` (``.npz`` appended if missing).
    ``pspecs``: the params' PartitionSpecs as tuples, nested alike
    (``convert.jax_specs``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    flat = _flatten(tree)
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    meta = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "treedef": TREEDEF,
        "specs": ({k: spec_str(v) for k, v in _flatten(
            {"params": pspecs}).items()} if pspecs is not None else {}),
        "extra": extra or {},
        "checksums": {k: _crc(v) for k, v in arrays.items()},
    }
    # temp file in the same directory (os.replace must not cross
    # filesystems), atomic rename onto the final path
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, __meta__=json.dumps(meta), **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str, like, *, root: str = "params") -> Tuple[Any, int]:
    """Restore the subtree saved under ``root`` into the structure of
    ``like`` (nested dicts whose leaves have ``.shape`` and ``.dtype``:
    arrays, or ``convert.Struct``s)."""
    data, meta = _open(path)
    out = {}
    for key_, leaf in _flatten(like).items():
        key = root + "/" + key_
        arr = _read_leaf(data, meta, key)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {leaf.shape}")
        out[key_] = arr.astype(leaf.dtype)
    return _unflatten(out), int(meta["step"])


def verify(path: str) -> dict:
    """Read every leaf of a checkpoint and check all checksums.

    Returns ``{"step": int, "leaves": int, "checksummed": bool}``.
    Raises :class:`CheckpointError` naming the first bad leaf (or the
    container) if anything is truncated or corrupt — the recovery loop
    calls this before trusting a checkpoint for restore.
    """
    data, meta = _open(path)
    keys = meta.get("keys") or [k for k in getattr(data, "files", [])
                                if k != "__meta__"]
    for key in keys:
        _read_leaf(data, meta, key)
    return {"step": int(meta.get("step", 0)), "leaves": len(keys),
            "checksummed": bool(meta.get("checksums"))}


# ---------------------------------------------------------------------- #
# ZeRO-sharded optimizer state (core/gradsync.py)
# ---------------------------------------------------------------------- #
#
# The on-disk format for the data-axis-sharded AdamW state is the
# REPLICATED per-leaf layout (m/v/master with the param's global shape):
# shard boundaries depend on the bucket plan, which depends on G_data, so
# persisting raw shards would pin the checkpoint to one mesh. The gather
# and scatter converters are ``launch.steps.make_gradsync_tools``' (with
# ``convert``'s to the global JAX trees) — built against whatever mesh is
# current on each side, which is exactly what lets a run saved at one
# g_data resume at another.

def save_sharded(path: str, params, sharded_state, gather_fn: Callable, *,
                 step: int = 0, pspecs=None, extra: Optional[dict] = None,
                 write: bool = True) -> None:
    """Save params + a ZeRO-sharded opt state via its ``gather`` tool
    (sharded state -> the global replicated-layout tree). ``gather_fn``
    runs collectives, so every rank calls this; only the ranks with
    ``write`` (one: rank 0) write."""
    full = gather_fn(sharded_state)
    if write:
        save(path, params, full, step=step, pspecs=pspecs,
             extra=dict(extra or {}, zero=True))


def restore_sharded(path: str, like_params, like_full_state,
                    scatter_fn: Callable) -> Tuple[Any, Any, int]:
    """Restore (params, sharded opt state, step); ``like_full_state`` is
    a template of the replicated state layout and ``scatter_fn`` the
    restoring mesh's scatter tool (global replicated tree -> this rank's
    shards) — its bucket plan may come from a different g_data than the
    saving run's."""
    params, step = restore(path, like_params)
    full, _ = restore(path, like_full_state, root="opt_state")
    return params, scatter_fn(full), step
