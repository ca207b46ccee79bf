"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

The names are those of ``repro.configs``, plus
``jamba-v0.1-52b-dense-ffn`` (Jamba with its experts replaced by the dense
MLP). An architecture the JAX package knows but the port cannot build yet
raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.base import ArchConfig

# name -> (module, attribute)
_MODULES = {
    "qwen3-1.7b": ("qwen3_1_7b", "CONFIG"),
    "jamba-v0.1-52b": ("jamba_v0_1_52b", "CONFIG"),
    "jamba-v0.1-52b-dense-ffn": ("jamba_v0_1_52b", "DENSE_FFN"),
    "gpt-paper-20b": ("gpt_paper_20b", "CONFIG"),
    "stablelm-1.6b": ("stablelm_1_6b", "CONFIG"),
    "nemotron-4-15b": ("nemotron_4_15b", "CONFIG"),
    "deepseek-v2-lite-16b": ("deepseek_v2_lite_16b", "CONFIG"),
    "deepseek-v3-671b": ("deepseek_v3_671b", "CONFIG"),
}

# known to the JAX package, not yet ported: the ROADMAP.md §1 item each
# one waits for
_NOT_PORTED = {
    "h2o-danube-3-4b": "dense config variants",
    "xlstm-350m": "other mixers and architectures",
    "internvl2-26b": "other mixers and architectures",
    "whisper-small": "other mixers and architectures",
}
# what an item's arch still lacks, where the item is under way
_WAITS_FOR = {
    "h2o-danube-3-4b": "head_dim 120 in kernels K2, K4 and K5",
}


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to PyTorch yet: it waits for the "
            f"ROADMAP.md §1 item '{_NOT_PORTED[name]}'"
            + (f" ({_WAITS_FOR[name]})" if name in _WAITS_FOR else "")
            + f". Ported: "
            f"{sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    module, attr = _MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    return getattr(mod, attr)
