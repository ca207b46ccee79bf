"""Carry a JAX parameter tree over to the port, and name the port's
parameters by their JAX paths.

``params_from_jax`` takes the tree of ``repro.launch.steps.init_model``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.decoder.Decoder` holding the same values, with
trainable parameters. The JAX tree stacks the layers of each segment
position along a leading (n_periods, ...) axis under
``segments/seg{s}/pos{i}/...``; the port keeps one module per layer under
the same leaf names (``layers.<l>.mixer.wq``, ``layers.<l>.norm1.g``, ...),
layer l being entry p of position i of segment s (``cfg.layer_slots()``).
The two frameworks draw different random numbers from the same seed, so
the tests carry weights across this way.

``jax_path`` maps a port parameter's name to the path of the JAX leaf it
comes from (``layers.3.mixer.wq`` -> ``segments/seg0/pos0/mixer/wq`` for a
period-1 decoder, ``segments/seg0/pos3/mixer/wq`` for Jamba; MLA's
``cq_norm`` is the reference's ``q_norm``, ``partition.JAX_LEAF_NAMES``).
The train step decides weight decay on these paths, as the JAX
``adamw._no_decay`` does, and the tests compare gradients leaf by leaf
through them.
``caches_from_jax`` maps the JAX fixed-batch caches onto the port's
per-layer ones.

The other direction, for checkpoints in the reference's format
(``checkpoint/ckpt.py``): ``params_to_jax`` and ``opt_state_to_jax`` gather
each of this rank's blocks over its spec's axes and stack the layers into
the global JAX leaves (numpy, keyed by JAX path); ``load_params_from_jax``
and ``opt_state_from_jax`` take a rank's blocks back out of such trees with
``params_from_jax``'s slicing, on any mesh. ``jax_specs`` and
``jax_structs`` give the JAX tree's PartitionSpecs and global shapes. A
bfloat16 parameter crosses as float32 (numpy has no bfloat16; the widening
is exact). On a mesh, both keep one rank's block of each global JAX
leaf: a parameter's by its PartitionSpec (``partition.param_spec``; the
Mamba layer's per-channel leaves over y), a cache's by the JAX cache spec
(batch over (data, z), KV heads and Mamba channels over y; with
``seqshard`` the K/V's positions over data and the Mamba states
replicated over data), first-name-major over each tuple of axes.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.core import mesh as M
from repro_torch.core.partition import JAX_LEAF_NAMES, param_spec
from repro_torch.layers.attention import CACHE_SPEC, DENSE_PAGE, \
    MLA_CACHE_SPEC, SEQ_CACHE_SPEC
from repro_torch.layers.mamba import SEQ_STATE_SPECS, STATE_SPECS
from repro_torch.models.base import ArchConfig
from repro_torch.models.decoder import Decoder


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _slot(name: str, cfg: ArchConfig):
    """(segment, position, period) of layer ``name.split('.')[1]``."""
    return cfg.layer_slots()[int(name.split(".")[1])]


def jax_path(name: str, cfg: ArchConfig) -> str:
    """The JAX tree path of the port parameter ``name``; a layer's leaf
    maps to the stacked leaf's path (``cfg`` places the layer in its
    segment)."""
    parts = name.split(".")
    if parts[0] == "layers":
        s, i, _ = _slot(name, cfg)
        parts = ["segments", f"seg{s}", f"pos{i}", *parts[2:]]
    parts[-1] = JAX_LEAF_NAMES.get(parts[-1], parts[-1])
    return "/".join(parts)


def jax_paths(model: Decoder) -> Dict[str, str]:
    """Port parameter name -> JAX path, for every parameter of ``model``."""
    return {n: jax_path(n, model.cfg) for n, _ in model.named_parameters()}


def _flat_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A nested JAX-path tree's leaves keyed "a/b/c"."""
    return {k.replace(".", "/"): v for k, v in _flatten(tree).items()}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _block(flat: Dict[str, Any], name: str, cfg: ArchConfig,
           axes: M.MeshAxes, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of the port parameter ``name`` from the global
    JAX leaves ``flat`` (keyed "a/b/c"), as a CPU tensor view."""
    leaf = np.asarray(flat[jax_path(name, cfg)])
    if name.startswith("layers."):
        leaf = leaf[_slot(name, cfg)[2]]
    with warnings.catch_warnings():
        # a read-only array (np.load's): the block is only read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.ascontiguousarray(leaf))
    return M.shard(t, axes, param_spec(name), rank)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig, device,
                    axes: M.MeshAxes = M.MeshAxes(), rank: int = 0
                    ) -> Decoder:
    """A Decoder on ``device`` (a torch device or its name) for the mesh
    ``axes`` with rank ``rank``'s blocks of the weights of the JAX tree
    ``tree`` (numpy leaves, global). Every leaf of the tree is used, each
    stacked entry by exactly one layer."""
    dev = torch.device(device)
    flat = _flatten(tree)
    state = {}
    used = set()
    dtype = torch.from_numpy(np.zeros(0, np.asarray(tree["embed"]).dtype)
                             ).dtype
    model = Decoder(cfg, axes, gen=torch.Generator(device=dev), dtype=dtype)
    slash = _flat_tree(tree)
    for name, _ in model.named_parameters():
        path = jax_path(name, cfg).replace("/", ".")
        used.add((path, _slot(name, cfg)[2] if name.startswith("layers.")
                  else None))
        state[name] = _block(slash, name, cfg, axes, rank).clone(
            memory_format=torch.contiguous_format)
    want = {(k, p) for k, v in flat.items() if k.startswith("segments.")
            for p in range(np.shape(v)[0])}
    want |= {(k, None) for k in flat if not k.startswith("segments.")}
    if used != want:
        raise ValueError(f"{cfg.name}: JAX leaves unused "
                         f"{sorted(map(str, want - used))[:8]}, missing "
                         f"{sorted(map(str, used - want))[:8]}")
    model.load_state_dict(state, strict=True)
    return model


# each fixed-batch cache leaf's spec, as the layers lay the caches out,
# without and with ``seqshard``
CACHE_SPECS = {False: {"k": CACHE_SPEC, "v": CACHE_SPEC,
                       "ckv": MLA_CACHE_SPEC, "k_rope": MLA_CACHE_SPEC,
                       **STATE_SPECS},
               True: {"k": SEQ_CACHE_SPEC, "v": SEQ_CACHE_SPEC,
                      **SEQ_STATE_SPECS}}


def caches_from_jax(caches: Dict[str, Any], cfg: ArchConfig, device="cpu",
                    axes: M.MeshAxes = M.MeshAxes(), rank: int = 0, *,
                    seqshard: bool = False
                    ) -> List[Dict[str, torch.Tensor]]:
    """Rank ``rank``'s per-layer fixed-batch caches from the JAX ones
    (global numpy leaves stacked (n_periods, ...) under ``seg{s}/pos{i}``).
    The JAX dense K/V caches hold exactly ``seq`` rows; the port's are
    padded with zeros to a multiple of ``attention.DENSE_PAGE`` (times
    g_data under ``seqshard``, before the positions are sharded), as
    ``attention.attn_cache_spec`` sizes them. An MLA layer's latent cache
    {"ckv", "k_rope"} keeps its ``seq`` rows."""
    specs = CACHE_SPECS[seqshard]
    unit = DENSE_PAGE * (axes.dp if seqshard else 1)
    out = []
    for s, i, p in cfg.layer_slots():
        layer = {}
        for k, v in caches[f"seg{s}"][f"pos{i}"].items():
            t = torch.tensor(np.asarray(v)[p])
            if k in ("k", "v"):
                t = F.pad(t, (0, 0, 0, 0, 0, -t.shape[1] % unit))
            layer[k] = M.shard(t, axes, specs[k], rank).contiguous().to(
                device)
        out.append(layer)
    return out


# ---------------------------------------------------------------------- #
# the port's state as the reference's global trees (checkpoints)
# ---------------------------------------------------------------------- #

def _global(v: torch.Tensor, axes: M.MeshAxes, spec) -> torch.Tensor:
    """The global tensor of this rank's block ``v`` under ``spec``: one
    all-gather over each sharded dim's axes (first-name-major, the
    inverse of ``mesh.shard``). Every rank of the mesh calls it."""
    for i, axis in enumerate(spec):
        if axes.size(axis) > 1:
            v = M.all_gather(v, axes, axis, dim=i)
    return v


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _stacked_tree(model: Decoder, items, keep: bool):
    """{JAX path (+ "/" + key where one is given): global leaf} of
    ``items``, (parameter name, key or None, this rank's block) triples in
    any order, each block converted as it comes; the layers of a stacked
    leaf stacked in period order. None unless ``keep``."""
    cfg, axes = model.cfg, model.axes
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    flat: Dict[str, Any] = {}
    for name, key, block in items:
        full = _global(block, axes, param_spec(name))
        if not keep:
            continue
        path = jax_path(name, cfg) + ("" if key is None else f"/{key}")
        if name.startswith("layers."):
            layers.setdefault(path, {})[_slot(name, cfg)[2]] = \
                _to_numpy(full)
        else:
            flat[path] = _to_numpy(full)
    if not keep:
        return None
    for path, by_period in layers.items():
        flat[path] = np.stack([by_period[p] for p in sorted(by_period)])
    return flat


def params_to_jax(model: Decoder, *, keep: bool = True, blocks=None):
    """The model's parameters as the JAX tree of ``repro.launch.steps.
    init_model`` (global, layer-stacked numpy leaves): each rank's blocks
    gathered over their spec's axes. ``blocks``: (name, this rank's
    block) pairs in place of the model's parameters (under ZeRO-3 each
    gathered from its shard as it is reached). Every rank of the mesh
    calls it; with ``keep`` False this rank returns None (only the writer
    keeps the arrays)."""
    pairs = model.named_parameters() if blocks is None else blocks
    flat = _stacked_tree(model, ((n, None, b) for n, b in pairs), keep)
    return None if flat is None else _nest(flat)


def opt_state_to_jax(state, model: Decoder, *, keep: bool = True):
    """The replicated-layout AdamW state of ``adamw.init_state`` ({"opt":
    {name: {"m", "v", "master"}}, "step"}, this rank's blocks; "opt" may
    also be an iterable of (name, {"m", "v", "master"}) pairs in any
    order, such as ``gradsync.iter_full_state``'s, each converted as it
    comes) as the reference's ``init_state`` tree: {"opt": the params'
    tree with each leaf a {"m", "v", "master"} dict, "step": int32 0-d},
    global and stacked. Collective, as :func:`params_to_jax`."""
    opt = state["opt"]
    pairs = opt.items() if isinstance(opt, dict) else opt
    flat = _stacked_tree(model, ((n, k, st[k]) for n, st in pairs
                                 for k in ("m", "v", "master")), keep)
    if not keep:
        return None
    return {"opt": _nest(flat),
            "step": np.asarray(int(state["step"]), np.int32)}


def param_blocks_from_jax(model: Decoder, tree: Dict[str, Any],
                          rank: int = None):
    """(name, rank ``rank``'s (default: this process's) block of it) for
    each of the model's parameters, from the JAX tree's global leaves: CPU
    views, one at a time."""
    rank = M.process_rank() if rank is None else rank
    flat = _flat_tree(tree)
    for name, _ in model.named_parameters():
        yield name, _block(flat, name, model.cfg, model.axes, rank)


@torch.no_grad()
def load_params_from_jax(model: Decoder, tree: Dict[str, Any],
                         rank: int = None) -> None:
    """Copy rank ``rank``'s (default: this process's) blocks of the JAX
    tree's global leaves into the model's parameters, in place."""
    params = dict(model.named_parameters())
    for name, block in param_blocks_from_jax(model, tree, rank):
        params[name].copy_(block)


def opt_state_from_jax(tree: Dict[str, Any], model: Decoder,
                       rank: int = None, *, device=None):
    """The inverse of :func:`opt_state_to_jax` on rank ``rank`` (default:
    this process's): {"opt": {name: {"m", "v", "master"}}, "step": int},
    fp32 blocks on ``device`` (default: the model's)."""
    rank = M.process_rank() if rank is None else rank
    flat = _flat_tree_opt(tree["opt"])
    dev = model.device if device is None else torch.device(device)
    opt = {}
    for name, _ in model.named_parameters():
        opt[name] = {k: _block(flat[k], name, model.cfg, model.axes, rank
                               ).to(dev, torch.float32, copy=True)
                     for k in ("m", "v", "master")}
    return {"opt": opt, "step": int(np.asarray(tree["step"]))}


def _flat_tree_opt(opt: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{"m" | "v" | "master": {JAX path: leaf}} of an ``opt`` tree whose
    leaves are {"m", "v", "master"} dicts."""
    out: Dict[str, Dict[str, Any]] = {"m": {}, "v": {}, "master": {}}
    for path, v in _flat_tree(opt).items():
        head, k = path.rsplit("/", 1)
        out[k][head] = v
    return out


def jax_specs(model: Decoder) -> Dict[str, Any]:
    """The JAX tree's PartitionSpec of each leaf as a tuple (a stacked
    leaf's starts with None for the layer dim), nested by path."""
    flat = {}
    for name, _ in model.named_parameters():
        stacked = name.startswith("layers.")
        flat[jax_path(name, model.cfg)] = ((None,) if stacked else ()) \
            + tuple(param_spec(name))
    return _nest(flat)


def jax_structs(model: Decoder) -> Dict[str, Any]:
    """Each JAX leaf's global shape and dtype (a :class:`Struct`; float32,
    the dtype the port writes), nested by path: the template
    ``ckpt.restore`` reads a checkpoint into."""
    cfg, axes = model.cfg, model.axes
    flat, periods = {}, {}
    for name, p in model.named_parameters():
        spec = param_spec(name)
        shape = tuple(s * axes.size(a) for s, a in zip(p.shape, spec))
        path = jax_path(name, cfg)
        if name.startswith("layers."):
            periods[path] = periods.get(path, 0) + 1
        flat[path] = (shape, np.dtype(np.float32))
    return _nest({path: Struct((periods[path],) + shape if path in periods
                               else shape, dt)
                  for path, (shape, dt) in flat.items()})


def jax_opt_structs(model: Decoder) -> Dict[str, Any]:
    """The template of the reference's AdamW state tree: {"opt": each
    leaf's m, v and master as :func:`jax_structs`, "step": int32 0-d}."""
    def opt(tree):
        return {k: opt(v) if isinstance(v, dict) else
                {"m": v, "v": v, "master": v} for k, v in tree.items()}
    return {"opt": opt(jax_structs(model)), "step": Struct((), np.int32)}


class Struct(tuple):
    """A leaf template: ``.shape`` and ``.dtype`` (numpy)."""

    def __new__(cls, shape, dtype):
        return super().__new__(cls, (tuple(shape), np.dtype(dtype)))

    @property
    def shape(self):
        return self[0]

    @property
    def dtype(self):
        return self[1]
