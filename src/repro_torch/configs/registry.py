"""Architecture registry of the port: --arch <id> resolves here.

A copy of src/repro/configs/registry.py: every architecture of the
reference (the dense and MoE decoder LMs, the GNN `gin-tu`, the four
recsys models and the search system `veretennikov`, whose serve tier
`launch/serve.py --mode search` drives) and the shared shape sets.
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
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "gin-tu": "repro_torch.configs.gin_tu",
    "fm": "repro_torch.configs.fm",
    "mind": "repro_torch.configs.mind",
    "autoint": "repro_torch.configs.autoint",
    "bst": "repro_torch.configs.bst",
    "veretennikov": "repro_torch.configs.veretennikov",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys | search
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict                      # shape name -> shape params dict


def get_arch(arch_id: str) -> ArchSpec:
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

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train_full", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7},
    "minibatch_lg": {"kind": "train_minibatch", "n_nodes": 232965,
                     "n_edges": 114_615_892, "batch_nodes": 1024,
                     "fanout": (15, 10), "d_feat": 602, "n_classes": 41},
    "ogb_products": {"kind": "train_full", "n_nodes": 2_449_029,
                     "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
    "molecule": {"kind": "train_graphs", "n_nodes": 30, "n_edges": 64,
                 "batch": 128, "d_feat": 16, "n_classes": 2},
}
