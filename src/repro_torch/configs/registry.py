"""Architecture registry of the port: --arch <id> resolves here.

A copy of src/repro/configs/registry.py for the architectures the port has
(the dense decoder LMs, the four recsys models and the search system
`veretennikov`, whose serve tier `launch/serve.py --mode search` drives).
Every other architecture of the reference raises in `get_arch`, naming the
ROADMAP.md item that ports it; none gets a stand-in.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

ALL_ARCHS = [
    "granite-3-8b", "qwen2.5-32b", "llama3-8b",
    "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
    "gin-tu",
    "fm", "mind", "autoint", "bst",
    "veretennikov",
]

_MODULES = {
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "fm": "repro_torch.configs.fm",
    "mind": "repro_torch.configs.mind",
    "autoint": "repro_torch.configs.autoint",
    "bst": "repro_torch.configs.bst",
    "veretennikov": "repro_torch.configs.veretennikov",
}

# what ports the rest (ROADMAP.md, "Open items", queue 1)
_NOT_PORTED = {
    "granite-moe-1b-a400m": "item 10 (models/moe.py)",
    "moonshot-v1-16b-a3b": "item 10 (models/moe.py)",
    "gin-tu": "item 10 (models/gnn.py)",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys | search
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict                      # shape name -> shape params dict


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: ROADMAP.md queue 1, "
            f"{_NOT_PORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_ARCHS)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC


# Shared shape sets ---------------------------------------------------------

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": 1_000_000},
}
