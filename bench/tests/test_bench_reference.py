"""The reference against the program's CPU engine on a tiny corpus, for
each configuration and mix, and the controls that must fail."""
import numpy as np
import pytest

import benchpath
from benchpath import one_torch_thread  # noqa: F401
import cell
import generator
import judge
from reference.search import anchor_keys
from inputs import make_corpus, make_lexicon

SEED = 2**31 + 77
CASES = [("ordinary-phrase", "paper64"), ("ordinary-ranked", "paper64"),
         ("ordinary-phrase", "kword64")]


@pytest.fixture(scope="module")
def world():
    cfg = benchpath.tiny_config("ordinary-phrase", n_docs=80)
    lex = make_lexicon(cfg)
    off, tok = make_corpus(cfg, lex)
    index = cell.build_program(cfg, lex, off, tok)
    return {"lex": lex, "off": off, "tok": tok, "index": index}


def _round(world, cfg_name, mix_name, n=160):
    from repro_torch import core
    cfg = benchpath.tiny_config(cfg_name, n_docs=80)
    mix = generator.load_mix(mix_name)
    specs = generator.queries(mix, world["off"], world["tok"], world["lex"],
                              n, SEED)
    engine = cell.make_engine(cfg, world["index"], "cpu")
    resps = []
    for i in range(0, n, 32):
        resps += engine.search_batch(cell.requests_of(core, cfg,
                                                      specs[i:i + 32]))
    return cfg, specs, resps


def _answers(cfg, world, specs, **kw):
    ref = cell.reference_for(cfg, world["lex"], world["off"], world["tok"],
                             **kw)
    s = cfg["service"]
    return [ref.answer(q["surface_ids"], q["mode"], q["window"],
                       bool(s["rank"]), s["top_k"]) for q in specs]


@pytest.mark.parametrize("cfg_name,mix_name", CASES)
def test_reference_agrees_with_the_program(world, cfg_name, mix_name):
    cfg, specs, resps = _round(world, cfg_name, mix_name)
    answers = _answers(cfg, world, specs)
    assert sum(len(a.keys) for a in answers) > len(specs)
    got, wrong = judge.judge(specs, resps, answers, cfg["service"]["rank"],
                             cfg["service"]["top_k"],
                             cfg["limits"].get("score_rel_gap", 0.0))
    assert wrong == []
    assert all(got[k] <= cfg["limits"][k] for k in got)


@pytest.mark.parametrize("cfg_name,mix_name", CASES)
def test_control_fails(world, cfg_name, mix_name):
    """The reference in the program's place, one step below what the
    configuration states: bfloat16 scores for the ranked service, each
    document's first occurrence only for the exact ones."""
    cfg, specs, _ = _round(world, cfg_name, mix_name, n=96)
    ranked = cfg["service"]["rank"]
    kw = {"score_dtype": "bfloat16"} if ranked else {"first_per_doc": True}
    control = [judge.AsResponse(a, cfg["service"]["top_k"])
               for a in _answers(cfg, world, specs, **kw)]
    got, _ = judge.judge(specs, control, _answers(cfg, world, specs), ranked,
                         cfg["service"]["top_k"],
                         cfg["limits"].get("score_rel_gap", 0.0))
    assert any(got[k] > cfg["limits"][k] for k in got), got


def test_missing_and_altered_answers_are_wrong(world):
    cfg, specs, resps = _round(world, "ordinary-phrase", "paper64", n=32)
    answers = _answers(cfg, world, specs)
    hit = next(i for i, a in enumerate(answers) if len(a.keys))
    gone = len(specs) - 1 if hit != len(specs) - 1 else 0
    resps = list(resps)
    resps[gone] = None
    r = resps[hit]
    r.pos = r.pos.copy()
    r.pos[0] += 1
    got, wrong = judge.judge(specs, resps, answers, False, None, 0.0)
    assert wrong == sorted([gone, hit]) and got["wrong_answers"] == 2


def test_split_parts_cover_every_word():
    from reference.search import split_parts
    for n in range(2, 13):
        parts = split_parts(n, 2, 5)
        covered = set()
        for s, L in parts:
            assert 2 <= L <= 5 and s + L <= n
            covered |= set(range(s, s + L))
        assert covered == set(range(n))


def test_bf16_rounds_to_nearest_even():
    from reference.search import bf16
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 3 * 2**-9, 1 / 3])
    got = bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == 1.0 + 2**-7
    assert abs(got[3] - 1 / 3) < 2**-9


def _repeats_a_nonstop_form(lex, q) -> bool:
    forms = [f for s in q["surface_ids"] for f in lex.forms(s)
             if f >= lex.n_stop]
    return len(forms) != len(set(forms))


@pytest.mark.parametrize("mix_name", ["paper64", "kword64"])
def test_additional_service_agrees_with_the_programs_oracles(world,
                                                              mix_name):
    """The reference's semantics of the additional-index service (the
    configurations' `"engine": "additional"`) against the program's own
    brute-force oracles, request by request."""
    from repro_torch import core
    cfg = dict(benchpath.tiny_config("ordinary-phrase", n_docs=80),
               engine="additional")
    specs = generator.queries(generator.load_mix(mix_name), world["off"],
                              world["tok"], world["lex"], 40, SEED + 1)
    corpus = core.Corpus(doc_offsets=world["off"], tokens=world["tok"])
    for q, a in zip(specs, _answers(cfg, world, specs)):
        if q["mode"] == "kword":
            pos, docs = core.brute_force_kword(corpus, world["index"],
                                               q["surface_ids"], q["window"])
        else:
            pos, docs = core.brute_force_search(corpus, world["index"],
                                                q["surface_ids"],
                                                mode=q["mode"])
        if pos:
            d, p = zip(*pos)
            assert np.array_equal(anchor_keys(d, p), a.keys), q
        else:
            assert a.doc_only == bool(docs), q
            assert sorted(docs) == a.docs.tolist(), q


@pytest.mark.parametrize("mix_name", ["paper64", "kword64"])
def test_additional_engine_agrees_where_no_form_repeats(world, mix_name):
    """The additional-index engine against the reference on requests that
    repeat no non-stop basic form: the engine misses occurrences on the
    others, a fault of the program that keeps its cells out of the
    benchmark."""
    from repro_torch import core
    cfg = dict(benchpath.tiny_config("ordinary-phrase", n_docs=80),
               engine="additional")
    specs = [q for q in generator.queries(
        generator.load_mix(mix_name), world["off"], world["tok"],
        world["lex"], 160, SEED) if not _repeats_a_nonstop_form(world["lex"], q)]
    engine = cell.make_engine(cfg, world["index"], "cpu")
    resps = engine.search_batch(cell.requests_of(core, cfg, specs))
    got, wrong = judge.judge(specs, resps, _answers(cfg, world, specs), False,
                             None, 0.0)
    assert wrong == [] and len(specs) > 100


def test_additional_engine_still_misses_on_a_repeated_form(world):
    """Pins the program's fault that keeps the additional-index engine out
    of the benchmark: on requests that repeat a non-stop basic form (here
    `[1019, 243, 1019]` near, among others) it answers otherwise than the
    reference, and the program's own brute-force oracle sides with the
    reference.  When the engine is mended this test fails: then it becomes
    an agreement test, and the `"engine": "additional"` cells can come."""
    from repro_torch import core
    cfg = dict(benchpath.tiny_config("ordinary-phrase", n_docs=80),
               engine="additional")
    specs = [q for q in generator.queries(
        generator.load_mix("paper64"), world["off"], world["tok"],
        world["lex"], 6000, SEED) if _repeats_a_nonstop_form(world["lex"], q)]
    engine = cell.make_engine(cfg, world["index"], "cpu")
    resps = engine.search_batch(cell.requests_of(core, cfg, specs))
    answers = _answers(cfg, world, specs)
    _, wrong = judge.judge(specs, resps, answers, False, None, 0.0)
    assert wrong, "the additional engine now agrees on repeated forms"
    corpus = core.Corpus(doc_offsets=world["off"], tokens=world["tok"])
    for k in wrong:
        q = specs[k]
        pos, _ = core.brute_force_search(corpus, world["index"],
                                         q["surface_ids"], mode=q["mode"])
        d, p = zip(*pos)
        assert np.array_equal(anchor_keys(d, p), answers[k].keys), q
