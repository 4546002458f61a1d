"""Carry an index, or LM weights, built by the reference package into the
port.

`index_from_reference(ref_index)` turns a reference `IndexSet` into the
port's own `IndexSet` — the port's "weights carried across".  It copies,
field by field, every numpy array of the reference objects: lexicon,
analyzer, index parameters, the raw CSR / DenseCSR posting streams and the
packed `lanes` / block metadata of every stream.  It reads attributes only
(duck typing on the class name), so it imports nothing of the reference
package; an engine over a carried index answers exactly like one over an
index the port built itself.

`lm_params_from_reference(params, cfg, device)` does the same for a
reference LM parameter dict (numpy arrays, layers stacked [L, ...]): it
returns the port's `Transformer` with each array cast to `cfg.dtype` or,
for training, a `param_dtype` asked for (an MoE router to float32, as the
reference stores it);
`recsys_params_from_reference(params, cfg, device)` returns the port's
`RecSysModel` for a reference recsys parameter dict (lists of layer dicts
become `attn.{i}.wq`-style names), and `gnn_params_from_reference(params,
cfg, device)` the port's `GIN` for a reference GIN parameter dict
(`layers.{i}.w1`-style names).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.basic_index import BasicIndex
from repro_torch.core.builder import IndexParams, IndexSet
from repro_torch.core.expanded_index import ExpandedIndex
from repro_torch.core.lexicon import Lexicon, LexiconConfig
from repro_torch.core.multi_key_index import MultiKeyIndex
from repro_torch.core.postings import CSR, DenseCSR, PackedPostings
from repro_torch.core.stop_phrase_index import StopPhraseIndex
from repro_torch.models.gnn import GIN, GINConfig
from repro_torch.models.recsys import RecSysConfig, RecSysModel
from repro_torch.models.transformer import Transformer, TransformerConfig

# the reference's index classes, by name, and their port counterparts
PORT_CLASSES = {cls.__name__: cls for cls in (
    Analyzer, BasicIndex, CSR, DenseCSR, ExpandedIndex, IndexParams, IndexSet,
    Lexicon, LexiconConfig, MultiKeyIndex, PackedPostings, StopPhraseIndex)}


def _carry(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if value is None or isinstance(value, (bool, int, float, str, np.generic)):
        return value
    if isinstance(value, tuple):
        return tuple(_carry(v) for v in value)
    if isinstance(value, list):
        return [_carry(v) for v in value]
    if isinstance(value, dict):
        return {k: _carry(v) for k, v in value.items()}
    cls = PORT_CLASSES.get(type(value).__name__)
    if cls is None:
        raise TypeError(f"cannot carry a {type(value).__module__}."
                        f"{type(value).__name__} into the port")
    names = ([f.name for f in dataclasses.fields(cls)]
             if dataclasses.is_dataclass(cls) else list(vars(value)))
    obj = object.__new__(cls)          # no __init__: nothing is rebuilt
    for name in names:
        # object.__setattr__ also sets the fields of frozen dataclasses
        object.__setattr__(obj, name, _carry(getattr(value, name)))
    return obj


def index_from_reference(ref_index) -> IndexSet:
    """A port IndexSet holding copies of every array of `ref_index`, a
    reference-package IndexSet (built with `repro.core.build_all`)."""
    if type(ref_index).__name__ != "IndexSet":
        raise TypeError(f"expected an IndexSet, got {type(ref_index)}")
    return _carry(ref_index)


@torch.no_grad()
def lm_params_from_reference(params: dict, cfg: TransformerConfig,
                             device=None, param_dtype=None) -> Transformer:
    """The port's model holding the reference LM parameters `params`
    (`embed`, `final_norm`, `lm_head` unless tied, and `layers`: a dict of
    arrays stacked [L, ...]; an MoE model's `router` [L, D, E] and expert
    weights [L, E, ...]), each cast to its parameter's dtype, on `device`
    (the card unless the caller asks for the CPU).  The weights are
    stored in `param_dtype`: by default the compute dtype `cfg.dtype`,
    as served; float32 to train from the reference's float32 weights (the
    router is float32 always).  Reads arrays only."""
    pd = cfg.dtype if param_dtype is None else param_dtype
    model = Transformer(dataclasses.replace(cfg, param_dtype=pd), device)
    want = {name for name, _ in model.layers[0].named_parameters()}
    if set(params["layers"]) != want:
        kind = "an MoE" if cfg.moe else "a dense"
        raise ValueError(f"layer parameters {sorted(params['layers'])}, "
                         f"want {sorted(want)} ({kind} model)")

    def put(dst: torch.Tensor, arr, what: str):
        src = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {tuple(src.shape)}, want "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))

    for name in want:
        stacked = np.asarray(params["layers"][name])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name}: {stacked.shape[0]} layers, "
                             f"want {cfg.n_layers}")
        for i, layer in enumerate(model.layers):
            put(getattr(layer, name), stacked[i], f"layers.{name}[{i}]")
    put(model.embed, params["embed"], "embed")
    put(model.final_norm, params["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        put(model.lm_head, params["lm_head"], "lm_head")
    return model


def _flat_names(params: dict, prefix: str = "") -> dict:
    """{'attn': [{'wq': a}, ...], 'table': t} -> {'attn.0.wq': a,
    'table': t}: the reference's dict under the port's names."""
    out = {}
    for key, value in params.items():
        if isinstance(value, list):
            for i, item in enumerate(value):
                out.update(_flat_names(item, f"{prefix}{key}.{i}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


@torch.no_grad()
def _fill_named(model: torch.nn.Module, params: dict, what: str):
    """Copy the reference's nested dict `params` into `model`'s parameters
    of the same (flattened) names, each cast to its parameter's dtype.
    Names and shapes must match the model's."""
    flat = _flat_names(params)
    want = dict(model.named_parameters())
    if set(flat) != set(want):
        raise ValueError(f"parameters {sorted(flat)}, want {sorted(want)} "
                         f"({what})")
    for name, dst in want.items():
        src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, want "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))
    return model


def recsys_params_from_reference(params: dict, cfg: RecSysConfig,
                                 device=None) -> RecSysModel:
    """The port's model holding the reference recsys parameters `params`
    (numpy arrays; `attn`, `blocks`, `mlp` lists of dicts), each cast to
    `cfg.param_dtype`, on `device` (the card unless the caller asks for
    the CPU).  Names and shapes must match the model's; reads arrays
    only."""
    return _fill_named(RecSysModel(cfg, device), params, f"a {cfg.model} model")


def gnn_params_from_reference(params: dict, cfg: GINConfig,
                              device=None) -> GIN:
    """The port's GIN holding the reference GIN parameters `params` (numpy
    arrays; `layers` a list of dicts {eps, w1, b1, w2, b2}, `head_w`,
    `head_b`), each cast to its parameter's dtype (`eps` float32, the
    rest `cfg.param_dtype`), on `device` (the card unless the caller asks
    for the CPU).  Reads arrays only."""
    return _fill_named(GIN(cfg, device), params, f"a {cfg.n_layers}-layer GIN")
