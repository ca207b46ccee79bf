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
period-1 decoder, ``segments/seg0/pos3/mixer/wq`` for Jamba). The train
step decides weight decay on these paths, as the JAX ``adamw._no_decay``
does, and the tests compare gradients leaf by leaf through them.
``caches_from_jax`` maps the JAX fixed-batch caches onto the port's
per-layer ones. On a mesh, both keep one rank's block of each global JAX
leaf: a parameter's by its PartitionSpec (``partition.param_spec``; the
Mamba layer's per-channel leaves over y), a cache's by the JAX cache spec
(batch over (data, z), KV heads and Mamba channels over y; with
``seqshard`` the K/V's positions over data and the Mamba states
replicated over data), first-name-major over each tuple of axes.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.core import mesh as M
from repro_torch.core.partition import param_spec
from repro_torch.layers.attention import CACHE_SPEC, DENSE_PAGE, \
    SEQ_CACHE_SPEC
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
    return "/".join(parts)


def jax_paths(model: Decoder) -> Dict[str, str]:
    """Port parameter name -> JAX path, for every parameter of ``model``."""
    return {n: jax_path(n, model.cfg) for n, _ in model.named_parameters()}


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
    for name, _ in model.named_parameters():
        path = jax_path(name, cfg).replace("/", ".")
        leaf = np.asarray(flat[path])
        if name.startswith("layers."):
            p = _slot(name, cfg)[2]
            leaf = leaf[p]
            used.add((path, p))
        else:
            used.add((path, None))
        state[name] = M.shard(torch.tensor(leaf), axes, param_spec(name),
                              rank).contiguous()
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
CACHE_SPECS = {False: {"k": CACHE_SPEC, "v": CACHE_SPEC, **STATE_SPECS},
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
    ``attention.attn_cache_spec`` sizes them."""
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
