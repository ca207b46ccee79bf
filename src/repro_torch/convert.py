"""Carry a JAX parameter tree over to the port, and name the port's
parameters by their JAX paths.

``params_from_jax`` takes the tree of ``repro.launch.steps.init_model``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.decoder.Decoder` holding the same values, with
trainable parameters. The JAX tree stacks each segment's layers along a
leading (n_periods, ...) axis under ``segments/seg0/pos0/...``; the port
keeps one module per layer under the same leaf names
(``layers.<i>.mixer.wq``, ``layers.<i>.norm1.g``, ...). The two frameworks
draw different random numbers from the same seed, so the tests carry
weights across this way.

``jax_path`` maps a port parameter's name to the path of the JAX leaf it
comes from (``layers.3.mixer.wq`` -> ``segments/seg0/pos0/mixer/wq``,
layer 3 of the stack). The train step decides weight decay on these
paths, as the JAX ``adamw._no_decay`` does, and the tests compare
gradients leaf by leaf through them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import mesh as M
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


def jax_path(name: str) -> str:
    """The JAX tree path of the port parameter ``name``; layer i of a
    stacked leaf maps to the stacked leaf's path."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["segments", "seg0", "pos0", *parts[2:]]
    return "/".join(parts)


def jax_paths(model: Decoder) -> Dict[str, str]:
    """Port parameter name -> JAX path, for every parameter of ``model``."""
    return {n: jax_path(n) for n, _ in model.named_parameters()}


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device) -> Decoder:
    """A Decoder on ``device`` (a torch device or its name) with the
    weights of the JAX tree ``tree`` (numpy leaves)."""
    segs = cfg.segments()
    if len(segs) != 1 or len(segs[0][0]) != 1:
        raise NotImplementedError(
            f"{cfg.name}: only single-segment, period-1 decoders convert")
    dev = torch.device(device)
    state = {"embed": tree["embed"], "final_norm.g": tree["final_norm"]["g"]}
    stacked = _flatten(tree["segments"]["seg0"]["pos0"])
    for i in range(cfg.n_layers):
        for name, leaf in stacked.items():
            state[f"layers.{i}.{name}"] = np.asarray(leaf)[i]
    state = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    model = Decoder(cfg, M.MeshAxes(), gen=torch.Generator(device=dev),
                    dtype=state["embed"].dtype)
    model.load_state_dict(state, strict=True)
    return model
