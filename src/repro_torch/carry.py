"""Carry an index built by the reference package into the port.

`index_from_reference(ref_index)` turns a reference `IndexSet` into the
port's own `IndexSet` — the port's "weights carried across".  It copies,
field by field, every numpy array of the reference objects: lexicon,
analyzer, index parameters, the raw CSR / DenseCSR posting streams and the
packed `lanes` / block metadata of every stream.  It reads attributes only
(duck typing on the class name), so it imports nothing of the reference
package; an engine over a carried index answers exactly like one over an
index the port built itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.basic_index import BasicIndex
from repro_torch.core.builder import IndexParams, IndexSet
from repro_torch.core.expanded_index import ExpandedIndex
from repro_torch.core.lexicon import Lexicon, LexiconConfig
from repro_torch.core.multi_key_index import MultiKeyIndex
from repro_torch.core.postings import CSR, DenseCSR, PackedPostings
from repro_torch.core.stop_phrase_index import StopPhraseIndex

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
