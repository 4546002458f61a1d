"""The port's host layer and package rules, against the reference package.

* `build_all` in the port builds, from the same corpus, exactly the
  reference's index: every raw CSR / DenseCSR stream (keys, offsets,
  columns), the stream-3 slots and every packed store (`lanes`, block
  metadata).
* The port's planner plans every query fixture exactly like the
  reference's.
* `index_from_reference` carries a reference index into the port
  unchanged.
* The package imports neither jax nor `repro`, its engines refuse to fall
  back from a missing card silently, and the ranked and K-word requests
  the first slice refused answer as the reference's do.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import IndexParams as RefIndexParams
from repro_torch.carry import index_from_reference
from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, OrdinaryEngine, Planner,
                              SearchRequest, build_all, generate_corpus,
                              make_lexicon_and_analyzer)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _assert_same(ref, port, path="index"):
    """Recursive structural equality across the two packages: same class
    names, same attributes, numpy arrays equal in dtype, shape and value."""
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), path
        assert ref.dtype == port.dtype and ref.shape == port.shape, path
        assert np.array_equal(ref, port), path
        return
    if ref is None or isinstance(ref, (bool, int, float, str, np.generic)):
        assert type(ref) is type(port) and ref == port, (path, ref, port)
        return
    if isinstance(ref, (tuple, list)):
        assert type(ref) is type(port) and len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            _assert_same(r, p, f"{path}[{i}]")
        return
    if isinstance(ref, dict):
        assert list(ref) == list(port), path
        for k in ref:
            _assert_same(ref[k], port[k], f"{path}[{k!r}]")
        return
    assert type(ref).__name__ == type(port).__name__, path
    assert type(port).__module__.startswith("repro_torch."), path
    assert list(vars(ref)) == list(vars(port)), path
    for k in vars(ref):
        _assert_same(getattr(ref, k), getattr(port, k), f"{path}.{k}")


@pytest.fixture(scope="module")
def port_world():
    """The small_world configuration, generated and built by the port."""
    lc = LexiconConfig(n_surface=8000, n_base=6000, n_stop=150,
                       n_frequent=500, seed=2)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=120, mean_doc_len=400,
                                              seed=2))
    return {"corpus": corpus, "index": build_all(corpus, lex, ana)}


def test_corpus_matches_reference(small_world, port_world):
    _assert_same(small_world["corpus"], port_world["corpus"], "corpus")


def test_build_all_matches_reference(small_world, port_world):
    ref, port = small_world["index"], port_world["index"]
    _assert_same(ref, port)
    # the walk above covers these; name the streams the executors ship
    for name in ("packed_occ", "packed_first"):
        r, p = getattr(ref.basic, name), getattr(port.basic, name)
        assert np.array_equal(r.lanes, p.lanes)
        assert np.array_equal(r.meta_matrix(), p.meta_matrix())
    for r, p in ((ref.expanded.packed, port.expanded.packed),
                 (ref.stop_phrase.packed, port.stop_phrase.packed),
                 (ref.multi_key.packed_pairs, port.multi_key.packed_pairs),
                 (ref.multi_key.packed_triples, port.multi_key.packed_triples),
                 (ref.ordinary_packed, port.ordinary_packed)):
        assert np.array_equal(r.lanes, p.lanes)
        assert np.array_equal(r.meta_matrix(), p.meta_matrix())


def test_build_all_matches_reference_gated_triples(small_world):
    """A non-default IndexParams (triple gating, a narrower multi-key
    NeighborDistance) builds the same index in both packages."""
    from repro.core import build_all as ref_build_all
    from repro_torch.core import IndexParams
    kw = dict(triple_pair_min_count=4, neighbor_distance=4)
    corpus = small_world["corpus"]
    ref = ref_build_all(corpus, small_world["lex"], small_world["ana"],
                        RefIndexParams(**kw))
    lc = LexiconConfig(n_surface=8000, n_base=6000, n_stop=150,
                       n_frequent=500, seed=2)
    lex, ana = make_lexicon_and_analyzer(lc)
    port = build_all(generate_corpus(lc, CorpusConfig(n_docs=120,
                                                      mean_doc_len=400,
                                                      seed=2)),
                     lex, ana, IndexParams(**kw))
    _assert_same(ref.multi_key, port.multi_key, "multi_key")


def _plain(obj):
    """A plan as nested tuples of builtins, comparable across packages."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(x) for x in obj)
    if isinstance(obj, np.ndarray):
        return tuple(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@pytest.mark.parametrize("fixture", ["paper_queries", "stop_near_queries",
                                     "kword_queries"])
def test_planner_matches_reference(request, small_world, port_world, fixture):
    queries = request.getfixturevalue(fixture)
    ref_planner = small_world["engine"].planner
    planner = Planner(port_world["index"])
    for q in queries:
        if fixture == "paper_queries":
            ids, mode, window = q[0], q[1], None
        elif fixture == "stop_near_queries":
            ids, mode, window = q[0], "near", None
        else:
            ids, mode, window = q[0], "kword", q[1]
        want = ref_planner.plan(list(ids), mode=mode, window=window)
        got = planner.plan(list(ids), mode=mode, window=window)
        assert _plain(got) == _plain(want), (ids, mode, window)


def test_index_from_reference_matches_port_build(small_world, port_world):
    carried = index_from_reference(small_world["index"])
    _assert_same(port_world["index"], carried)
    # arrays are copies, not views of the reference's
    assert not np.shares_memory(carried.ordinary.offsets,
                                small_world["index"].ordinary.offsets)


def test_engine_over_carried_index_matches_port_build(small_world, port_world,
                                                      paper_queries):
    carried = AdditionalIndexEngine(index_from_reference(small_world["index"]),
                                    device="cpu")
    built = AdditionalIndexEngine(port_world["index"], device="cpu")
    reqs = [SearchRequest(q, mode=m) for q, m, _ in paper_queries[:40]]
    for a, b in zip(carried.search_batch(reqs), built.search_batch(reqs)):
        assert np.array_equal(a.doc, b.doc) and np.array_equal(a.pos, b.pos)
        assert (a.postings_read, a.used_fallback, a.doc_only) == \
            (b.postings_read, b.used_fallback, b.doc_only)


def test_index_from_reference_rejects_foreign_objects():
    with pytest.raises(TypeError):
        index_from_reference(object())


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_reference():
    """With jax blocked, every port module imports, and neither jax nor the
    reference package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.core.engine, repro_torch.carry\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.configs.registry, repro_torch.configs.llama3_8b\n"
        "import repro_torch.configs.granite_3_8b, "
        "repro_torch.configs.qwen2_5_32b\n"
        "import repro_torch.launch.steps, repro_torch.launch.serve\n"
        "import repro_torch.models.recsys, repro_torch.data.recsys_data\n"
        "import repro_torch.kernels.segment_bag\n"
        "import repro_torch.serve.front, repro_torch.core.segments\n"
        "import repro_torch.dist.fault_tolerance, repro_torch.dist.chaos\n"
        "from repro_torch.configs.registry import get_arch\n"
        "assert get_arch('llama3-8b').make_config().n_layers == 32\n"
        "for a in ('fm', 'autoint', 'bst', 'mind'):\n"
        "    assert get_arch(a).make_config().model == a\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.') or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax_or_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                         r"from repro\.|from repro |import repro$)", re.M)
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 20
    for sub in ("core", "kernels", "models", "configs", "launch", "data",
                "serve", "dist"):
        assert any(f.parent.name == sub for f in files), sub
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_engines_need_cuda_unless_cpu_is_asked(port_world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (AdditionalIndexEngine, OrdinaryEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(port_world["index"])
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(port_world["index"], device="cuda")
        assert cls(port_world["index"], device="cpu").device.type == "cpu"


def test_lm_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3-8b").make_smoke_config()
    for fn in (lambda d: tfm.Transformer(cfg, device=d),
               lambda d: tfm.init_params(cfg, torch.Generator(), device=d),
               lambda d: tfm.init_cache(cfg, 2, 8, device=d),
               lambda d: serve_lm("llama3-8b", 2, device=d)):
        for d in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(d)
    assert tfm.Transformer(cfg, device="cpu").device.type == "cpu"
    assert len(serve_lm("llama3-8b", 2, device="cpu")) == 2
    assert "cpu" in capsys.readouterr().out
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--mode", "search"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--mode", "search", "--qps", "50"])


@pytest.mark.parametrize("cls", [AdditionalIndexEngine, OrdinaryEngine])
def test_unported_requests_raise(small_world, port_world, cls):
    """The request kinds the first slice refused (ranked, K-word) now
    answer, on both entry points of both engines, exactly as the
    reference engine does."""
    from repro.core import SearchRequest as RefRequest
    eng = cls(port_world["index"], device="cpu")
    ref = small_world["engine" if cls is AdditionalIndexEngine else "ordinary"]
    q = port_world["corpus"].doc(3)[5:9].tolist()
    kinds = (dict(rank=True), dict(mode="near", rank=True, top_k=3),
             dict(mode="kword", window=6))
    for kw in kinds:
        want = ref.search(RefRequest(q, **kw))
        got = [eng.search(SearchRequest(q, **kw)),
               eng.search_batch([SearchRequest(q), SearchRequest(q, **kw)])[1]]
        for g in got:
            for f in ("doc", "pos", "postings_read", "used_fallback",
                      "doc_only", "subplan_types", "ranked", "anchor_scores",
                      "doc_ids", "doc_scores"):
                w, v = getattr(want, f), getattr(g, f)
                if isinstance(w, np.ndarray):
                    assert v.dtype == w.dtype and np.array_equal(v, w), (kw, f)
                else:
                    assert v == w, (kw, f)
        assert len(got[0].doc) > 0, kw
