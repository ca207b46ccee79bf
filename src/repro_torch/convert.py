"""Carry a JAX parameter tree over to the port.

``params_from_jax`` takes the tree of ``repro.launch.steps.init_model``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.decoder.Decoder` holding the same values. The
JAX tree stacks each segment's layers along a leading (n_periods, ...)
axis under ``segments/seg0/pos0/...``; the port keeps one module per layer
under the same leaf names (``layers.<i>.mixer.wq``, ``layers.<i>.norm1.g``,
...). The two frameworks draw different random numbers from the same
seed, so the tests carry weights across this way.
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
