"""The inputs and the traffic repeat from their seeds, a mix with a
`pool_seed` gives every run seed the same pool in another order, and the
program builds its lexicon tables equal to the benchmark's."""
import itertools

import numpy as np
import pytest

import benchpath
from benchpath import one_torch_thread  # noqa: F401
import generator
from inputs import make_corpus, make_lexicon

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3, -1)


def _world(n_docs=60):
    cfg = benchpath.tiny_config("ordinary-phrase", n_docs=n_docs)
    lex = make_lexicon(cfg)
    return cfg, lex, *make_corpus(cfg, lex)


def test_inputs_repeat_from_the_configuration():
    cfg, lex, off, tok = _world()
    assert np.array_equal(lex.form_ids, make_lexicon(cfg).form_ids)
    off2, tok2 = make_corpus(cfg, lex)
    assert np.array_equal(off, off2) and np.array_equal(tok, tok2)
    assert len(off) == cfg["n_docs"] + 1 and (np.diff(off) >= 8).all()
    other = dict(cfg, corpus_seed=cfg["corpus_seed"] + 1)
    assert not np.array_equal(make_corpus(other, lex)[1][:100], tok[:100])


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("mix_name", ["paper64", "kword64"])
def test_pool_repeats_and_has_its_size(mix_name, fixed):
    cfg, lex, off, tok = _world()
    mix = benchpath.tiny_mix(mix_name)
    if not fixed:
        del mix["pool_seed"]
    seed = SEEDS[2]
    pool = generator.pool(mix, off, tok, lex, seed)
    assert pool == generator.pool(mix, off, tok, lex, seed)
    assert len(pool) == mix["pool_batches"]
    assert all(len(b) == mix["batch"] for b in pool)
    if "pool_seed" in mix:          # one pool for every run seed
        assert generator.pool(mix, off, tok, lex, seed + 1) == pool
        other = dict(mix, pool_seed=mix["pool_seed"] + 1)
    else:                           # a pool of each run seed's own
        other = mix
    assert generator.pool(other, off, tok, lex, seed + 1) != pool


@pytest.mark.parametrize("seed", SEEDS)
def test_every_pass_runs_the_whole_pool_in_a_seeds_order(seed):
    n = 7
    first = list(itertools.islice(generator.order(n, seed), 3 * n))
    for p in range(3):
        assert sorted(first[p * n:(p + 1) * n]) == list(range(n))
    assert first == list(itertools.islice(generator.order(n, seed), 3 * n))
    other = list(itertools.islice(generator.order(n, seed + 1), 3 * n))
    assert other != first


def test_stop_share_is_the_configured_one():
    cfg, lex, _, tok = _world(n_docs=200)
    share = lex.surface_has_stop()[tok].mean()
    assert abs(share - cfg["stop_mass"]) < 0.02


@pytest.mark.parametrize("lexicon_seed", (4, 1801, 2**40 + 9))
def test_program_lexicon_tables_equal_the_benchmarks(lexicon_seed):
    from repro_torch.core import LexiconConfig, make_lexicon_and_analyzer
    cfg = benchpath.tiny_config("ordinary-phrase")
    cfg["lexicon_seed"] = lexicon_seed
    lex = make_lexicon(cfg)
    plex, pana = make_lexicon_and_analyzer(
        LexiconConfig(**cfg["lexicon"], seed=lexicon_seed))
    assert np.array_equal(pana.form_offsets, lex.form_offsets)
    assert np.array_equal(pana.form_ids, lex.form_ids)
    assert np.array_equal(plex.base_tier, lex.base_tier)


def test_paper_stream_pairs_phrase_and_near_from_one_place():
    _, lex, off, tok = _world(n_docs=100)
    qs = generator.queries(generator.load_mix("paper64"), off, tok, lex, 200,
                           3)
    assert [q["mode"] for q in qs[:4]] == ["phrase", "near"] * 2
    for ph, nr in zip(qs[0::2], qs[1::2]):
        assert ph["surface_ids"][0] == nr["surface_ids"][0]
        assert len(ph["surface_ids"]) == len(nr["surface_ids"])
        assert 3 <= len(ph["surface_ids"]) <= 5 and nr["window"] is None


def test_kword_windows_follow_the_mix():
    _, lex, off, tok = _world(n_docs=100)
    qs = generator.queries(generator.load_mix("kword64"), off, tok, lex, 600,
                           5)
    w = np.array([q["window"] for q in qs])
    assert all(q["mode"] == "kword" and 3 <= len(q["surface_ids"]) <= 5
               for q in qs)
    assert ((w >= 2) & (w <= 31)).all()
    assert 0.05 < (w > 15).mean() < 0.15
