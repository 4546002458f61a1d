"""The port's kernel modules against the reference package's Pallas kernels.

The port's plain versions (repro_torch.kernels.ops.*_plain, which the CPU
path runs) must equal the reference's Pallas path in interpret mode
exactly — both are integer functions (tests/test_torch_lm.py does the same
for the two attention kernels' plain versions, tests/test_torch_recsys.py
for the embedding bag's).  The CUDA kernels themselves run only on a card:
their tests take the `cuda_device` fixture, which skips without one, and
hold each kernel against its plain version on the card (the attention
kernels to 2e-5 in float32, and in bf16 to 5e-2 and to one bf16 ulp of
each output row's largest value; the embedding bag exactly in
float32 — it adds in the plain version's order, product and sum rounded
apart — and to 5e-2 in bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.batch_executor import BatchDeviceIndex
from repro_torch.core.postings import BLOCK, PACK_WIDTHS, PackedPostings
from repro_torch.kernels import ops
from repro_torch.kernels.edge_cases import (BAG_EDGE_CASES, MD_EDGE_CASES,
                                            MD_EDGE_WIDTHS, ROW_EDGE_CASES,
                                            ROW_EDGE_WIDTHS, bag_edge_case,
                                            bag_past_4gib, md_edge_case,
                                            md_sub_stride, offset_view,
                                            row_edge_case, row_regime)

I32_MAX = np.iinfo(np.int32).max
SDB, SDM = ops.SCORE_DELTA_BITS, ops.SCORE_DELTA_MASK   # (key, delta) layout


@pytest.fixture(scope="module")
def ref():
    """The reference package (it needs jax; the card's machine has none, so
    there these comparisons skip and the card tests below still run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.postings import PackedPostings
    from repro.kernels import ops
    return {"jnp": jnp, "ops": ops, "PackedPostings": PackedPostings}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _width_class_columns(rng):
    """One 128-posting block per width class per field (spans forcing each
    class, negative anchors included) plus a short tail block."""
    cols = {"doc": [], "pos": [], "dist": []}
    for w in PACK_WIDTHS:
        hi = 0 if w == 0 else (1 << min(w, 31)) - 1
        for f in cols:
            anchor = int(rng.integers(-1000, 1000))
            vals = anchor + rng.integers(0, hi + 1, BLOCK, dtype=np.int64)
            vals[0], vals[-1] = anchor, anchor + hi      # pin the span
            if w == 32:                                   # full int32 range
                vals[0], vals[-1] = -(1 << 31), (1 << 31) - 1
            cols[f].append(vals)
    tail = {f: rng.integers(-5, 5, 37) for f in cols}
    return {f: np.concatenate(v + [tail[f]]).astype(np.int32)
            for f, v in cols.items()}


def _port_arena(pp):
    return {"lanes": torch.from_numpy(pp.lanes),
            "blk_meta": torch.from_numpy(pp.meta_matrix())}


def _ref_unpack(ref, lanes, meta, idx):
    jnp = ref["jnp"]
    arena = {"lanes": jnp.asarray(lanes), "blk_meta": jnp.asarray(meta)}
    out = ref["ops"].unpack_postings(arena, jnp.asarray(idx),
                                     implementation="pallas", interpret=True)
    return [np.asarray(o) for o in out]


def test_unpack_plain_matches_pallas_every_width_class(ref):
    rng = np.random.default_rng(11)
    cols = _width_class_columns(rng)
    pp = PackedPostings.from_columns(cols, fields=("doc", "pos", "dist"))
    ref_pp = ref["PackedPostings"].from_columns(cols,
                                                fields=("doc", "pos", "dist"))
    assert np.array_equal(pp.lanes, ref_pp.lanes)
    assert np.array_equal(pp.meta_matrix(), ref_pp.meta_matrix())
    widths = {int(w) for f in ("doc", "pos", "dist") for w in pp.field_width(f)}
    assert set(PACK_WIDTHS) <= widths
    # every ordinal, the tail pad, and ordinals past the arena's end (the
    # reference clamps them to the last block)
    idx = np.concatenate([np.arange(pp.n_padded),
                          pp.n_padded + np.arange(3) * 1000]).astype(np.int32)
    want = _ref_unpack(ref, pp.lanes, pp.meta_matrix(), idx)
    got = ops.unpack_postings_plain(_port_arena(pp), torch.from_numpy(idx))
    for f, w, g in zip(("doc", "pos", "dist"), want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w), f
    for f in ("doc", "pos", "dist"):                     # and the codec itself
        assert np.array_equal(got[("doc", "pos", "dist").index(f)].numpy()[:pp.n],
                              cols[f])


def test_unpack_plain_matches_pallas_on_engine_arena(ref, port_arena_np):
    """The batched arena of a real index (all six streams, width-0 tail
    blocks whose lane word lies past the end), at the executor's [T, G, F, P]
    ordinal layout."""
    lanes, meta = port_arena_np
    rng = np.random.default_rng(5)
    A = meta.shape[0] * BLOCK
    starts = rng.integers(0, A, (4, 2, 3))
    idx = np.clip(starts[..., None] + np.arange(256), 0, A - 1).astype(np.int32)
    idx[0, 0, 0, :] = A - 1 - np.arange(256)             # the arena's tail
    want = _ref_unpack(ref, lanes, meta, idx)
    got = ops.unpack_postings_plain(
        {"lanes": torch.from_numpy(lanes), "blk_meta": torch.from_numpy(meta)},
        torch.from_numpy(idx))
    for w, g in zip(want, got):
        assert g.shape == idx.shape
        assert np.array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def port_arena_np():
    from repro_torch.core import (CorpusConfig, LexiconConfig, build_all,
                                  generate_corpus, make_lexicon_and_analyzer)
    lc = LexiconConfig(n_surface=3000, n_base=2500, n_stop=80, n_frequent=200,
                       seed=9)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=12, mean_doc_len=200,
                                              seed=9))
    dev = BatchDeviceIndex(build_all(corpus, lex, ana), "cpu")
    return dev.packed.lanes, dev.packed.meta_matrix()


def _rebased_rows(rng, n_rows, pa, pb, dup_straddle=True):
    """Rows in the rebased int32 key domain ((doc_local << 17) | pos'):
    unsorted a with sentinel pads, ascending b with sentinel tails, mixed
    bands 0..8, an all-sentinel a row, an all-sentinel b row, and duplicate
    runs of b straddling 128-blocks."""
    a = np.full((n_rows, pa), I32_MAX, np.int32)
    b = np.full((n_rows, pb), I32_MAX, np.int32)
    for r in range(n_rows):
        docs = rng.integers(0, 64, pb)
        keys = (docs << 17) | rng.integers(64, 400, pb)
        nb = int(rng.integers(pb // 2, pb + 1))
        b[r, :nb] = np.sort(keys[:nb])
        if dup_straddle and nb > 140:
            b[r, 120:136] = b[r, 120]                    # run across 128
            b[r, :nb] = np.sort(b[r, :nb])
        na = int(rng.integers(pa // 2, pa + 1))
        near = b[r, rng.integers(0, max(nb, 1), na)].astype(np.int64) \
            + rng.integers(-9, 10, na)
        a[r, :na] = np.where(rng.random(na) < 0.5, near,
                             (rng.integers(0, 64, na) << 17)
                             | rng.integers(64, 400, na))
    a[1] = I32_MAX                                       # empty a row
    b[2] = I32_MAX                                       # empty b row
    bands = rng.choice([0, 0, 1, 2, 5, 8], n_rows).astype(np.int32)
    return a, b, bands


@pytest.mark.parametrize("pa,pb", [(128, 128), (256, 1024), (1024, 256)])
def test_intersect_rows_plain_matches_pallas(ref, pa, pb):
    jnp = ref["jnp"]
    rng = np.random.default_rng(pa + pb)
    a, b, bands = _rebased_rows(rng, 6, pa, pb)
    want = np.asarray(ref["ops"].banded_intersect_rows(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bands),
        implementation="pallas", interpret=True))
    got = ops.banded_intersect_rows_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bands))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert not got[1].any()                              # sentinels never hit
    assert want.any()                                    # the test has hits


def test_intersect_rows_duplicates_straddling_blocks(ref):
    """A run of equal b keys across the 128-block boundary: every probe
    inside or at the band edge of the run hits (the reference needs its
    side='left' - 1 tile rule for this; a lower bound needs nothing)."""
    b = np.full((1, 256), I32_MAX, np.int32)
    b[0, :200] = np.sort(np.r_[np.arange(0, 120) * 10,
                               np.full(80, 5000)]).astype(np.int32)
    a = np.array([[5000, 4999, 4998, 5002, 4990, 15, 1190, I32_MAX]
                  + [I32_MAX] * 120], np.int32)
    bands = np.array([1], np.int32)
    jnp = ref["jnp"]
    want = np.asarray(ref["ops"].banded_intersect_rows(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bands),
        implementation="pallas", interpret=True))
    got = ops.banded_intersect_rows_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bands))
    assert np.array_equal(got.numpy(), want)
    assert got[0, :8].tolist() == [True, True, False, False, False, False,
                                   True, False]


@pytest.mark.parametrize("band", [0, 3])
def test_banded_intersect_single_row_matches_pallas(ref, band):
    jnp = ref["jnp"]
    rng = np.random.default_rng(band)
    b = np.sort(rng.integers(0, 1 << 20, 700)).astype(np.int32)
    a = np.concatenate([b[rng.integers(0, 700, 300)] + rng.integers(-4, 5, 300),
                        rng.integers(0, 1 << 20, 200),
                        np.full(12, I32_MAX)]).astype(np.int32)
    want = np.asarray(ref["ops"].banded_intersect(
        jnp.asarray(a), jnp.asarray(b), band, implementation="pallas",
        interpret=True))
    got = ops.banded_intersect(torch.from_numpy(a), torch.from_numpy(b), band)
    assert np.array_equal(got.numpy(), want)


def _scored_rows(rng, n_rows, pa, pb, plan_domain=False):
    """Min-delta rows: the rows of `_rebased_rows` folded onto four docs,
    with a delta in [0, 15] beside every b key, each row sorted by (key, delta) — so the run of
    equal keys across the 128-block boundary carries mixed deltas — and
    bands 0, 1, 8 and 15.  `plan_domain` zeroes the deltas of band > 0
    rows, the only rows on which the reference's two-probe ref path is
    exact; otherwise those rows carry non-zero deltas too.  Sentinel pads
    carry delta 0, as the batch executor's composite split leaves them."""
    a, b, _ = _rebased_rows(rng, n_rows, pa, pb)
    # four docs instead of 64: dense rows, so bands hold several keys
    a = np.where(a == I32_MAX, a, a & ((4 << 17) - 1))
    b = np.sort(np.where(b == I32_MAX, b, b & ((4 << 17) - 1)), axis=1)
    bands = rng.choice([0, 1, 8, 15], n_rows).astype(np.int32)
    bands[:4] = [0, 1, 8, 15][:min(4, n_rows)]
    bd = rng.integers(0, 16, b.shape)
    bd[b == I32_MAX] = 0
    if plan_domain:
        bd[bands > 0] = 0
    comp = np.sort((b.astype(np.int64) << SDB) | bd, axis=1)
    return (a, (comp >> SDB).astype(np.int32), (comp & SDM).astype(np.int32),
            bands)


def _ref_min_delta(ref, a, bk, bd, bands, impl):
    jnp = ref["jnp"]
    return np.asarray(ref["ops"].banded_min_delta_rows(
        jnp.asarray(a), jnp.asarray(bk), jnp.asarray(bd), jnp.asarray(bands),
        implementation=impl, interpret=True))


@pytest.mark.parametrize("pa,pb", [(128, 128), (256, 1024), (1024, 256)])
def test_min_delta_plain_matches_pallas(ref, pa, pb):
    """The general minimum, band > 0 rows with non-zero deltas included."""
    rng = np.random.default_rng(pa * 3 + pb)
    a, bk, bd, bands = _scored_rows(rng, 6, pa, pb)
    want = _ref_min_delta(ref, a, bk, bd, bands, "pallas")
    got = ops.banded_min_delta_rows_plain(*map(torch.from_numpy,
                                               (a, bk, bd, bands)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (got[1] == I32_MAX).all()                     # sentinel a row
    assert ((want < I32_MAX) & (want > 0)).any()         # non-trivial minima
    # the test exercises the general case: some band > 0 minimum differs
    # from the two-probe answer
    two_probe = _ref_min_delta(ref, a, bk, bd, bands, "ref")
    assert not np.array_equal(two_probe, want)


@pytest.mark.parametrize("pa,pb", [(128, 128), (256, 1024)])
def test_min_delta_plain_matches_ref_on_plan_domain(ref, pa, pb):
    """Where band > 0 rows carry zero deltas (plan construction), the
    general minimum equals the reference's two-probe ref path too."""
    rng = np.random.default_rng(pa + 5 * pb)
    a, bk, bd, bands = _scored_rows(rng, 6, pa, pb, plan_domain=True)
    got = ops.banded_min_delta_rows_plain(*map(torch.from_numpy,
                                               (a, bk, bd, bands))).numpy()
    assert np.array_equal(got, _ref_min_delta(ref, a, bk, bd, bands, "ref"))
    assert np.array_equal(got, _ref_min_delta(ref, a, bk, bd, bands,
                                              "pallas"))


def test_min_delta_plain_edge_rows(ref):
    """Hand-made rows: an empty b row, a duplicate run with mixed deltas
    across the 128-block boundary, probes at the band edges, band 15."""
    bk = np.full((3, 256), I32_MAX, np.int32)
    bd = np.zeros((3, 256), np.int32)
    keys = np.r_[np.arange(0, 120) * 40, np.full(20, 6000), 7000]
    deltas = np.r_[np.zeros(120), np.arange(20)[::-1] % 16, 3]
    comp = np.sort((keys.astype(np.int64) << SDB) | deltas.astype(np.int64))
    bk[0, :141] = comp >> SDB
    bd[0, :141] = comp & SDM
    bk[2] = bk[0]
    bd[2] = bd[0]
    a = np.full((3, 128), I32_MAX, np.int32)
    probes = [6000, 5999, 5985, 6015, 6016, 7000, 6993, 40, 55, I32_MAX]
    a[:, :len(probes)] = probes
    bands = np.array([15, 15, 0], np.int32)
    want = _ref_min_delta(ref, a, bk, bd, bands, "pallas")
    got = ops.banded_min_delta_rows_plain(*map(torch.from_numpy,
                                               (a, bk, bd, bands))).numpy()
    assert np.array_equal(got, want)
    assert got[0, :len(probes)].tolist() == [
        0, 1, 15, 15, I32_MAX, 3, 7 + 3, 0, 15, I32_MAX]
    assert (got[1] == I32_MAX).all()                     # empty b row
    assert got[2, :2].tolist() == [0, I32_MAX]           # band 0


# ---------------------------------------------------------------------------
# min delta: the fence search's edge cases.  The min-delta kernel searches
# a fence of every s-th key of its row (s = fence_stride(pb)) in shared
# memory, then one window of the row; these rows put runs, probes and row
# widths where that search has its edges (kernels/edge_cases.py, shared
# with chip_smoke.py).  Here the plain version against
# the Pallas kernel (which wants widths of 128: a and b are padded with
# sentinels for it, pads that no probe reaches); on the card the kernel
# against the plain version at each case's widths, whose planned strides
# reach every path of the search.
# ---------------------------------------------------------------------------

def _pad128(x, fill):
    return np.pad(x, ((0, 0), (0, -x.shape[1] % 128)), constant_values=fill)


@pytest.mark.parametrize("name", MD_EDGE_CASES)
def test_min_delta_plain_fence_edge_cases_match_pallas(ref, name):
    a, bk, bd, bands = md_edge_case(name)
    want = _ref_min_delta(ref, _pad128(a, I32_MAX), _pad128(bk, I32_MAX),
                          _pad128(bd, 0), bands, "pallas")[:, :a.shape[1]]
    got = ops.banded_min_delta_rows_plain(*map(torch.from_numpy,
                                               (a, bk, bd, bands))).numpy()
    assert np.array_equal(got, want)
    hit = want != I32_MAX
    assert hit.any() and not hit.all()
    for r in range(4):                  # every band finds and misses
        if (a[r] != I32_MAX).any() and (bk[r] != I32_MAX).sum() > 1:
            assert hit[r].any() and not hit[r].all(), (name, r)
    if name == "all_sentinel_row":
        assert (want[1] == I32_MAX).all() and (want[2] == I32_MAX).all()


def test_min_delta_edge_cases_hold_their_edges():
    """Each case puts what its name says where the planned fence has its
    edges, at each of its widths, and the widths' planned strides reach
    every path of the kernel's search: no fence, a fence whose segments
    are one window, a sub-fence, and binary steps past the sub-fence."""
    from repro_torch.kernels.edge_cases import MD_WINDOW
    from repro_torch.kernels.intersect import fence_stride
    paths = set()
    for name, widths in MD_EDGE_WIDTHS.items():
        for pb in widths:
            a, bk, bd, bands = md_edge_case(name, pb)
            s = fence_stride(pb)
            assert bk.shape == bd.shape == (4, pb) and a.shape == (4, 128)
            paths.add("no fence" if pb <= s else "window" if s <= MD_WINDOW
                      else "sub-fence" if md_sub_stride(s) <= MD_WINDOW
                      else "binary steps")
            if name == "pb_not_stride_multiple":
                assert pb % s and pb > s
            if name == "pb_within_one_stride":
                assert pb <= s
            if name == "run_straddles_fence":
                s2 = md_sub_stride(s)
                for r in range(4):
                    for j in (s, 2 * s, 3 * s, s + s2, s + MD_WINDOW):
                        assert bk[r, j - 1] == bk[r, j] == bk[r, j + 1]
            if name == "key_equals_fence_key":
                for r in range(4):
                    fence = set(bk[r, ::s].tolist()) - {I32_MAX}
                    assert fence <= set(a[r].tolist())
                    assert fence <= set((a[r].astype(np.int64)
                                         - bands[r]).tolist())
            if name == "unsorted_a_segments":
                live = a != I32_MAX
                assert (~live).any(axis=1).all()
                assert (np.diff(np.where(live, a, -1).astype(np.int64),
                                axis=1) < 0).any()
            if name == "all_sentinel_row":
                assert (a[1] == I32_MAX).all() and (bk[2] == I32_MAX).all()
    assert paths == {"no fence", "window", "sub-fence", "binary steps"}


def test_fence_stride_plan():
    """A power of two >= 32 whose fence fits the kernel's 1024 keys (the
    planner keeps it to FENCE_KEYS), for every row width from 1 to 2^20;
    no fence (pb <= s) for rows of one window."""
    from repro_torch.kernels.intersect import (FENCE_KEYS, FENCE_MIN_STRIDE,
                                               fence_stride)
    assert FENCE_KEYS <= 1024
    last = 0
    for pb in range(1, (1 << 20) + 1):
        s = fence_stride(pb)
        if s != last:
            assert s >= 32 and s & (s - 1) == 0 and s >= last
            last = s
        assert -(-pb // s) <= FENCE_KEYS
    assert fence_stride(FENCE_MIN_STRIDE) == FENCE_MIN_STRIDE
    assert fence_stride(16384) == 16384 // FENCE_KEYS
    assert fence_stride(1 << 20) == (1 << 20) // FENCE_KEYS


# ---------------------------------------------------------------------------
# intersect and delta mask: the two regimes' edge cases.  Both kernels copy
# a row of up to ROW_STAGE_KEYS keys whole into shared memory and search
# wider rows through min delta's fence (`row_plan`); these rows put widths,
# runs, probes and sentinels where the two regimes have their edges
# (kernels/edge_cases.py, shared with chip_smoke.py).  Here the plain
# versions against the Pallas kernels and the reference's window scan, at
# each case's own width; on the card each kernel against its plain
# version at every width.
# ---------------------------------------------------------------------------

def _ref_intersect(ref, a, b, bands):
    jnp = ref["jnp"]
    return np.asarray(ref["ops"].banded_intersect_rows(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bands),
        implementation="pallas", interpret=True))


@pytest.mark.parametrize("name", ROW_EDGE_CASES)
def test_intersect_plain_row_edge_cases_match_pallas(ref, name):
    a, b, bands, _ = row_edge_case(name)
    want = _ref_intersect(ref, a, _pad128(b, I32_MAX), bands)
    got = ops.banded_intersect_rows(*map(torch.from_numpy, (a, b, bands)))
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    for r in (0, 1, 2, 3):              # every band finds and misses
        if (a[r] != I32_MAX).any() and (b[r] != I32_MAX).sum() > 1:
            assert want[r].any() and not want[r].all(), (name, r)


@pytest.mark.parametrize("name", ROW_EDGE_CASES)
def test_delta_mask_plain_row_edge_cases_match_pallas(ref, name):
    """Both outputs of the op on the CPU: the mask against the Pallas
    kernel, the window scan against the reference's `delta_mask_t_bits`
    at the rows' windows (which differ from the bands on the two inactive
    pads)."""
    jnp = ref["jnp"]
    a, b, bands, windows = row_edge_case(name)
    want = _ref_delta_mask(ref, a, _pad128(b, I32_MAX), bands)
    want_t = np.asarray(ref["ops"].delta_mask_t_bits(jnp.asarray(want),
                                                     jnp.asarray(windows)))
    mask, t_bits = ops.banded_delta_mask_rows(
        *map(torch.from_numpy, (a, b, bands, windows)))
    assert np.array_equal(mask.numpy(), want)
    assert np.array_equal(t_bits.numpy(), want_t)
    assert (want != 0).any() and (want == 0).any()
    assert (want_t[4:] != 0).any()      # the pads' windows are in use
    if name == "long_in_band_run":      # runs of many in-band entries
        assert (want[3, :3] != 0).all()


def test_row_edge_cases_hold_their_edges():
    """Each case puts what its name says where the two regimes have their
    edges, at each of its widths, and the widths reach every path: the
    staged row by 16-byte and by 4-byte copies and the fence, and a long
    in-band run in both regimes."""
    from repro_torch.kernels.edge_cases import (ROW_BANDS, ROW_PA, ROW_RUN,
                                                ROW_WINDOWS)
    from repro_torch.kernels.intersect import (ROW_STAGE_KEYS, fence_stride,
                                               row_plan)
    paths = set()
    for name, widths in ROW_EDGE_WIDTHS.items():
        for pb in widths:
            a, b, bands, windows = row_edge_case(name, pb)
            assert a.shape == (6, ROW_PA) and b.shape == (6, pb)
            assert (np.diff(b.astype(np.int64), axis=1) >= 0).all()
            assert np.array_equal(bands, ROW_BANDS)
            assert np.array_equal(windows, ROW_WINDOWS)
            assert (windows[4:] != bands[4:]).all()
            paths.add(row_regime(pb))
            s = row_plan(pb)
            if name == "pb_at_stage_threshold":
                assert pb - ROW_STAGE_KEYS in (0, 1)
            if name == "pb_not_stride_multiple":
                assert pb % (s or fence_stride(pb))
            if name == "run_straddles_edges":
                assert (b != I32_MAX).all()
                assert (b[:, -9:] == b[:, -9:-8]).all()   # the row's end
                for j in (1, 2, 3):
                    j *= s or fence_stride(pb)
                    assert (b[:, j - 1] == b[:, j]).all()
                    assert (b[:, j] == b[:, j + 1]).all()
            if name == "long_in_band_run":
                for r in range(4):
                    w = min(int(bands[r]), 15)
                    x = int(a[r, 0])
                    inband = (b[r] >= x - w) & (b[r] <= x + w)
                    assert inband.sum() >= ROW_RUN > 64
                paths.add(f"long run, {row_regime(pb)}")
            if name == "near_int32_max":
                live = a[a != I32_MAX].astype(np.int64)
                assert (live.max() + 15 > I32_MAX)
                assert b.max() <= I32_MAX - 16
            if name == "unsorted_a_segments":
                live = a != I32_MAX
                assert (~live).any(axis=1).all()
                assert (np.diff(np.where(live, a, -1).astype(np.int64),
                                axis=1) < 0).any()
            if name == "all_sentinel_rows_and_slices":
                assert (a[1] == I32_MAX).all() and (b[2] == I32_MAX).all()
                assert (b[3] != I32_MAX).sum() == 1
                assert (a[4:, 128:] == I32_MAX).all()
    assert paths == {"row staged, 16-byte copies", "row staged, 4-byte copies",
                     "fenced", "long run, row staged, 16-byte copies",
                     "long run, fenced"}


def test_row_plan():
    """Rows of up to ROW_STAGE_KEYS keys are staged whole (their shared
    memory within the 48 KB a launch gets without opting in), wider ones
    take min delta's fence stride, a fence a warp's lanes copy."""
    from repro_torch.kernels.intersect import (ROW_STAGE_KEYS, fence_stride,
                                               row_plan)
    assert ROW_STAGE_KEYS * 4 <= 48 * 1024
    for pb in [0, 1, 127, 128, 1001, ROW_STAGE_KEYS, ROW_STAGE_KEYS + 1,
               16384, 30000, 1 << 20]:
        s = row_plan(pb)
        assert s == (0 if pb <= ROW_STAGE_KEYS else fence_stride(pb))
        assert s == 0 or -(-pb // s) <= 32      # one key a lane of a warp


def test_kword_found_fuses_the_window_scan():
    """The K-word join through the op's two outputs equals the old
    composition (the plain masks, then each group's `delta_mask_t_bits`
    at the task's window, inactive groups as -1, ANDed) on a bucket of
    four tasks with three constraint groups: inactive groups, a task with
    none active, and windows 1, 5, 8 and 15."""
    from repro_torch.core.batch_executor import kword_found
    rng = np.random.default_rng(41)
    T, G1, pa, pb = 4, 3, 128, 256
    a, b, _ = _rebased_rows(rng, T * G1, pa, pb)
    b = np.sort(b & ((2 << 17) - 1) | np.where(b == I32_MAX, I32_MAX, 0),
                axis=1).astype(np.int32)
    a = np.where(a == I32_MAX, a, a & ((2 << 17) - 1)).astype(np.int32)
    a = np.repeat(a[::G1], G1, axis=0)              # a task's seed, per group
    W = np.array([1, 5, 8, 15], np.int32)
    active = np.array([[1, 1, 0], [1, 0, 1], [0, 0, 0], [1, 1, 1]], bool)
    bands = np.where(active, W[:, None], 0).astype(np.int32)
    ta, tb, tbands, tact = map(torch.from_numpy, (a, b, bands, active))
    got = kword_found(ta, tb, tbands, tact)
    masks = ops.banded_delta_mask_rows_plain(ta, tb, tbands.reshape(-1))
    masks = masks.reshape(T, G1, pa)
    t_ok = None
    for g in range(G1):
        bits = torch.where(tact[:, g, None],
                           ops.delta_mask_t_bits(masks[:, g],
                                                 torch.from_numpy(W)), -1)
        t_ok = bits if t_ok is None else t_ok & bits
    want = t_ok != 0
    assert got.dtype == torch.bool and got.shape == (T, pa)
    assert torch.equal(got, want)
    assert want[2].all()                # no active group: every anchor
    live = torch.from_numpy(a[::G1] != I32_MAX)
    assert (want & live)[[0, 1, 3]].any() and not (want | ~live).all()


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_tile_plan(elem_size, weighted):
    """Every bag in exactly one tile, every column in one group, threads a
    multiple of 32 covering the tile, the shared memory within the budget,
    at F <= 64 and D <= 128."""
    from repro_torch.kernels.segment_bag import (BAG_SMEM_BUDGET,
                                                 BAG_LOADS_IN_FLIGHT, bag_tile)
    for D in range(1, 129):
        for vec in (v for v in (1, 2, 4) if D % v == 0):
            for F in (0, 1, 7, 13, 39, 50, 64):
                for B in (1, 2, 53, 256, 1001):
                    t = bag_tile(B, F, D, elem_size, weighted, vec)
                    starts = range(0, B, t.bags)
                    covered = [b for s in starts
                               for b in range(s, min(B, s + t.bags))]
                    assert covered == list(range(B))
                    assert t.groups * -(-(D // vec) // t.groups) >= D // vec
                    assert t.bags * t.groups <= t.threads <= 256
                    assert t.threads % 32 == 0 and t.vec == vec
                    assert t.smem_bytes <= BAG_SMEM_BUDGET
                    assert t.fields >= F or (
                        t.fields % BAG_LOADS_IN_FLIGHT == 0 and t.fields > 0)


def _ref_delta_mask(ref, a, b, bands):
    jnp = ref["jnp"]
    return np.asarray(ref["ops"].banded_delta_mask_rows(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bands),
        implementation="pallas", interpret=True))


@pytest.mark.parametrize("pa,pb", [(128, 128), (256, 1024), (1024, 256)])
def test_delta_mask_plain_matches_pallas(ref, pa, pb):
    rng = np.random.default_rng(pa + 7 * pb)
    a, b, _ = _rebased_rows(rng, 6, pa, pb)
    bands = np.array([0, 15, 1, 8, 15, 3], np.int32)
    want = _ref_delta_mask(ref, a, b, bands)
    got = ops.banded_delta_mask_rows_plain(*map(torch.from_numpy,
                                                (a, b, bands)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (got[1] == 0).all()                           # sentinel a row
    assert (want[1:] >> 16 != 0).any()                   # high bits in use


def test_delta_mask_plain_duplicates_straddling_blocks(ref):
    b = np.full((1, 256), I32_MAX, np.int32)
    b[0, :200] = np.sort(np.r_[np.arange(0, 120) * 10,
                               np.full(80, 5000)]).astype(np.int32)
    a = np.full((1, 128), I32_MAX, np.int32)
    a[0, :6] = [5000, 4985, 5015, 5016, 1190, 1195]
    bands = np.array([15], np.int32)
    want = _ref_delta_mask(ref, a, b, bands)
    got = ops.banded_delta_mask_rows_plain(*map(torch.from_numpy,
                                                (a, b, bands))).numpy()
    assert np.array_equal(got, want)
    assert got[0, :6].tolist() == [1 << 15, 1 << 30, 1, 0,
                                   (1 << 15) | (1 << 5),
                                   (1 << 10) | (1 << 0)]


def test_kword_window_hits_matches_reference(ref):
    """The window scan and K-way combine over per-group masks, exactly;
    inactive groups never constrain."""
    jnp = ref["jnp"]
    rng = np.random.default_rng(31)
    G, N, pa = 3, 8, 128
    bands = rng.integers(1, 16, N).astype(np.int32)
    masks = np.zeros((G, N, pa), np.int32)
    for g in range(G):
        for n in range(N):
            width = 2 * int(bands[n]) + 1
            bits = rng.random((pa, width)) < 0.08
            masks[g, n] = (bits * (1 << np.arange(width))).sum(axis=1)
    active = rng.random((G, N)) < 0.8
    active[:, 0] = False                                 # no active group
    want = np.asarray(ref["ops"].kword_window_hits(
        jnp.asarray(masks), jnp.asarray(active), jnp.asarray(bands)))
    t_bits = torch.stack([ops.delta_mask_t_bits(torch.from_numpy(m),
                                                torch.from_numpy(bands))
                          for m in masks])
    got = ops.kword_window_hits(t_bits, torch.from_numpy(active))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    for g in range(G):
        assert np.array_equal(
            ops.delta_mask_t_bits(torch.from_numpy(masks[g]),
                                  torch.from_numpy(bands)).numpy(),
            np.asarray(ref["ops"].delta_mask_t_bits(jnp.asarray(masks[g]),
                                                    jnp.asarray(bands))))


def test_dispatch_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version; no build is attempted."""
    rng = np.random.default_rng(3)
    a, b, bands = _rebased_rows(rng, 4, 128, 128)
    ta, tb, tbands = map(torch.from_numpy, (a, b, bands))
    launches = ops.banded_intersect_rows_cuda.launches
    assert torch.equal(ops.banded_intersect_rows(ta, tb, tbands),
                       ops.banded_intersect_rows_plain(ta, tb, tbands))
    assert ops.banded_intersect_rows_cuda.launches == launches


def test_scoring_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    a, bk, bd, bands = map(torch.from_numpy, _scored_rows(rng, 4, 128, 128))
    counts = (ops.banded_min_delta_rows_cuda.launches,
              ops.banded_delta_mask_rows_cuda.launches)
    assert torch.equal(ops.banded_min_delta_rows(a, bk, bd, bands),
                       ops.banded_min_delta_rows_plain(a, bk, bd, bands))
    mask = ops.banded_delta_mask_rows_plain(a, bk, bands)
    got = ops.banded_delta_mask_rows(a, bk, bands, bands + 1)
    assert torch.equal(got[0], mask)
    assert torch.equal(got[1], ops.delta_mask_t_bits(mask, bands + 1))
    assert counts == (ops.banded_min_delta_rows_cuda.launches,
                      ops.banded_delta_mask_rows_cuda.launches)


# ---------------------------------------------------------------------------
# the embedding bag's tile edges (kernels/edge_cases.py, shared with
# chip_smoke.py; tests/test_torch_recsys.py holds the plain version against
# the reference on these, the card tests below the kernel against the
# plain version)
# ---------------------------------------------------------------------------

def test_bag_edge_cases_hold_their_edges():
    for name in BAG_EDGE_CASES:
        table, ids, _, t = bag_edge_case(name)
        B, F = ids.shape
        if name == "ragged_last_tile":
            assert B % t.bags and B > t.bags
        if name == "odd_F_unaligned_tiles":
            assert F % 2 and (t.bags * F * 4) % 16
        if name == "F_past_one_stage":
            assert t.fields < F and F % t.fields    # the last stage short
        if name == "D_1":
            assert table.shape[1] == 1
        if name == "all_pad_bags_at_tile_edges":
            edges = [b for s in range(0, B, t.bags)
                     for b in (s, min(B, s + t.bags) - 1)]
            assert len(edges) >= 4 and (ids[edges] < 0).all()


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def test_unpack_kernel_matches_plain_on_card(cuda_device, port_arena_np):
    lanes, meta = port_arena_np
    arena = {"lanes": torch.from_numpy(lanes).to(cuda_device),
             "blk_meta": torch.from_numpy(meta).to(cuda_device)}
    A = meta.shape[0] * BLOCK
    idx = torch.arange(A + 300, dtype=torch.int32, device=cuda_device)
    got = ops.unpack_postings(arena, idx)
    want = ops.unpack_postings_plain(arena, idx)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pa,pb", [(128, 128), (1024, 32768)])
def test_intersect_kernel_matches_plain_on_card(cuda_device, pa, pb):
    rng = np.random.default_rng(pa)
    a, b, bands = (torch.from_numpy(x).to(cuda_device)
                   for x in _rebased_rows(rng, 8, pa, pb))
    got = ops.banded_intersect_rows(a, b, bands)
    want = ops.banded_intersect_rows_plain(a, b, bands)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("pa,pb", [(128, 128), (1024, 32768)])
def test_min_delta_kernel_matches_plain_on_card(cuda_device, pa, pb):
    rng = np.random.default_rng(pa + 1)
    a, bk, bd, bands = (torch.from_numpy(x).to(cuda_device)
                        for x in _scored_rows(rng, 8, pa, pb))
    got = ops.banded_min_delta_rows(a, bk, bd, bands)
    want = ops.banded_min_delta_rows_plain(a, bk, bd, bands)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,pb", [(n, pb) for n in MD_EDGE_CASES
                                     for pb in MD_EDGE_WIDTHS[n]])
def test_min_delta_kernel_fence_edge_cases_on_card(cuda_device, name, pb):
    """The fence's edge cases at each of their widths, whose planned
    strides reach every path of the search (no fence, one window per
    segment, a sub-fence, binary steps past it); exact equality."""
    a, bk, bd, bands = (torch.from_numpy(x).to(cuda_device)
                        for x in md_edge_case(name, pb))
    before = ops.banded_min_delta_rows_cuda.launches
    got = ops.banded_min_delta_rows_cuda(a, bk, bd, bands)
    want = ops.banded_min_delta_rows_plain(a, bk, bd, bands)
    torch.cuda.synchronize()
    assert ops.banded_min_delta_rows_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("pb", [1024, 4096, 32768])
def test_min_delta_kernel_odd_width_and_offset_rows_on_card(cuda_device, pb):
    """Rows whose width is no multiple of 4 and planes that start off a
    16-byte boundary take the scalar window, at widths whose planned
    strides search one window, a sub-fence and binary steps."""
    rng = np.random.default_rng(17 + pb)
    a, bk, bd, bands = _scored_rows(rng, 8, 128, pb)
    for w in (pb - 23, pb - 1):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                for x in (a, bk[:, :w], bd[:, :w], bands)]
        got = ops.banded_min_delta_rows_cuda(*args)
        assert torch.equal(got, ops.banded_min_delta_rows_plain(*args))
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, bk, bd, bands)]
    args[1] = offset_view(args[1])
    assert args[1].data_ptr() % 16 == 4
    got = ops.banded_min_delta_rows_cuda(*args)
    assert torch.equal(got, ops.banded_min_delta_rows_plain(*args))


@pytest.mark.parametrize("pa,pb", [(128, 128), (1024, 32768)])
def test_delta_mask_kernel_matches_plain_on_card(cuda_device, pa, pb):
    rng = np.random.default_rng(pa + 2)
    a, b, _ = _rebased_rows(rng, 8, pa, pb)
    bands = np.array([0, 1, 8, 15, 15, 2, 5, 15], np.int32)
    windows = np.array([0, 15, 8, 15, 3, 2, 31, -1], np.int32)
    a, b, bands, windows = (torch.from_numpy(x).to(cuda_device)
                            for x in (a, b, bands, windows))
    mask, t_bits = ops.banded_delta_mask_rows(a, b, bands, windows)
    want = ops.banded_delta_mask_rows_plain(a, b, bands)
    torch.cuda.synchronize()
    assert torch.equal(mask, want)
    assert torch.equal(t_bits, ops.delta_mask_t_bits(want, windows))


@pytest.mark.parametrize("name,pb", [(n, pb) for n in ROW_EDGE_CASES
                                     for pb in ROW_EDGE_WIDTHS[n]])
def test_intersect_kernel_row_edge_cases_on_card(cuda_device, name, pb):
    """The two regimes' edge cases at each of their widths (the staged row
    by 16-byte and 4-byte copies, the fence); exact equality, one launch
    each."""
    a, b, bands, _ = (torch.from_numpy(x).to(cuda_device)
                      for x in row_edge_case(name, pb))
    before = ops.banded_intersect_rows_cuda.launches
    got = ops.banded_intersect_rows_cuda(a, b, bands)
    want = ops.banded_intersect_rows_plain(a, b, bands)
    torch.cuda.synchronize()
    assert ops.banded_intersect_rows_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,pb", [(n, pb) for n in ROW_EDGE_CASES
                                     for pb in ROW_EDGE_WIDTHS[n]])
def test_delta_mask_kernel_row_edge_cases_on_card(cuda_device, name, pb):
    """Both outputs of one launch, the mask against the plain version and
    the window scan against `delta_mask_t_bits` of the plain mask at the
    rows' windows; exact equality."""
    a, b, bands, windows = (torch.from_numpy(x).to(cuda_device)
                            for x in row_edge_case(name, pb))
    before = ops.banded_delta_mask_rows_cuda.launches
    mask, t_bits = ops.banded_delta_mask_rows_cuda(a, b, bands, windows)
    want = ops.banded_delta_mask_rows_plain(a, b, bands)
    torch.cuda.synchronize()
    assert ops.banded_delta_mask_rows_cuda.launches == before + 1
    assert torch.equal(mask, want)
    assert torch.equal(t_bits, ops.delta_mask_t_bits(want, windows))


@pytest.mark.parametrize("pb", [256, 512, 16384, 32768])
def test_row_kernels_offset_rows_on_card(cuda_device, pb):
    """b planes that start 4 bytes past a 16-byte boundary take 4-byte
    copies in both regimes; equal to the plain versions."""
    a, b, bands, windows = (torch.from_numpy(x).to(cuda_device)
                            for x in row_edge_case("run_straddles_edges", pb))
    b = offset_view(b)
    assert b.data_ptr() % 16 == 4
    assert torch.equal(ops.banded_intersect_rows_cuda(a, b, bands),
                       ops.banded_intersect_rows_plain(a, b, bands))
    mask, t_bits = ops.banded_delta_mask_rows_cuda(a, b, bands, windows)
    want = ops.banded_delta_mask_rows_plain(a, b, bands)
    assert torch.equal(mask, want)
    assert torch.equal(t_bits, ops.delta_mask_t_bits(want, windows))


@pytest.mark.parametrize("pb", [128, 511, 512, 513, 16384])
def test_row_kernel_info_on_card(cuda_device, pb):
    """The compiled kernels report the planned regime and their
    resources."""
    from repro_torch.kernels.intersect import (banded_delta_mask_rows_info,
                                               banded_intersect_rows_info,
                                               row_plan)
    for info in (banded_intersect_rows_info(pb),
                 banded_delta_mask_rows_info(pb)):
        s = row_plan(pb)
        assert info["regime"] == ("row_staged" if s == 0 else "fenced")
        assert info["fence_stride"] == s and info["threads"] == 128
        assert info["registers"] > 0
        if s == 0:
            assert info["staged_keys"] == pb
            assert info["dynamic_smem_bytes"] == -(-pb // 4) * 16
            assert info["int4_copies"] == (pb % 4 == 0)
        else:
            assert info["fence_keys"] == -(-pb // s) <= 32
            assert info["dynamic_smem_bytes"] == 4 * 32 * 4   # a warp's fence


def _attention_inputs(rng, shapes, dtype, device):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device=device, dtype=dtype) for s in shapes]


def _row_rel_err(got, want):
    """The largest over output rows of max|got - want| / max|want|; a zero
    row of `want` must be matched exactly."""
    g, w = got.float(), want.float()
    err, scale = (g - w).abs().amax(-1), w.abs().amax(-1)
    assert bool((err[scale == 0] == 0).all())
    return float((err / scale.clamp_min(1e-30))[scale > 0].max())


def _hold_attention(got, want, dtype):
    """float32 to 2e-5; bf16 to 5e-2 and to one bf16 ulp (2^-7) of each
    output row's largest value."""
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    assert float((got.float() - want.float()).abs().max()) < tol
    if dtype == torch.bfloat16:
        assert _row_rel_err(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("B,Hq,Hkv,D,S,kv_len,dtype", [
    (2, 4, 4, 32, 96, [1, 96], torch.float32),           # G = 1
    (3, 8, 2, 64, 1000, [0, 999, 517], torch.float32),   # kv_len 0, odd
    (2, 5, 1, 128, 777, [777, 5000], torch.float32),     # G = 5, > S
    (4, 32, 8, 128, 4096, [4096, 1, 3001, 2048], torch.bfloat16),
    (2, 8, 1, 32, 300, [299, 17], torch.bfloat16),       # G = 8
    # the split's edges (decode_split: 512-row chunks at S 8192, B 4,
    # Hkv 8; 64-row chunks at S 1000, B 3, Hkv 2): one row past a chunk
    # boundary, exactly on one, shorter than a chunk beside long rows
    (4, 32, 8, 128, 8192, [513, 1024, 100, 8192], torch.bfloat16),
    (4, 32, 8, 128, 8192, [511, 512, 1, 0], torch.bfloat16),
    (3, 8, 2, 64, 1000, [0, 1000, 5000], torch.bfloat16),  # 0 beside S, > S
    (3, 8, 2, 64, 1000, [65, 64, 63], torch.float32),    # S % 64 != 0
    (2, 10, 2, 32, 130, [129, 130], torch.bfloat16),     # G = 5
])
def test_flash_decode_kernel_matches_plain_on_card(cuda_device, B, Hq, Hkv,
                                                   D, S, kv_len, dtype):
    rng = np.random.default_rng(S + D)
    q, k, v = _attention_inputs(rng, [(B, Hq, D), (B, S, Hkv, D),
                                      (B, S, Hkv, D)], dtype, cuda_device)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    before = ops.flash_decode_cuda.launches
    got = ops.flash_decode(q, k, v, kl)
    want = ops.flash_decode_plain(q, k, v, kl)
    torch.cuda.synchronize()
    assert ops.flash_decode_cuda.launches == before + 1
    _hold_attention(got, want, dtype)


def test_flash_decode_kernel_is_deterministic_on_card(cuda_device):
    """The partials are merged in a fixed order, without atomics: the same
    call twice gives the same bits."""
    rng = np.random.default_rng(7)
    q, k, v = _attention_inputs(rng, [(4, 32, 128), (4, 8192, 8, 128),
                                      (4, 8192, 8, 128)], torch.bfloat16,
                                cuda_device)
    kl = torch.tensor([8192, 5000, 513, 1], dtype=torch.int32,
                      device=cuda_device)
    first = ops.flash_decode(q, k, v, kl)
    second = ops.flash_decode(q, k, v, kl)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype", [
    (1, 128, 4, 1, 32, torch.float32),
    (2, 200, 8, 2, 64, torch.float32),                   # ragged last tile
    (1, 77, 5, 1, 128, torch.float32),
    (1, 1024, 32, 8, 128, torch.bfloat16),
    # the wgmma route: S below one 128-row q tile or 64-row kv tile, S not
    # a multiple of either, G 1, 4, 5 and 8, D 32, 64 and 128
    (1, 1, 1, 1, 64, torch.bfloat16),
    (1, 40, 5, 1, 128, torch.bfloat16),
    (2, 200, 8, 2, 64, torch.bfloat16),
    (1, 333, 8, 1, 32, torch.bfloat16),
    (1, 129, 4, 4, 32, torch.bfloat16),
    (2, 300, 16, 4, 128, torch.bfloat16),
    (1, 1000, 10, 2, 64, torch.bfloat16),
])
def test_flash_prefill_kernel_matches_plain_on_card(cuda_device, B, S, Hq,
                                                    Hkv, D, dtype):
    rng = np.random.default_rng(S + D + 1)
    q, k, v = _attention_inputs(rng, [(B, S, Hq, D), (B, S, Hkv, D),
                                      (B, S, Hkv, D)], dtype, cuda_device)
    before = ops.flash_prefill_cuda.launches
    got = ops.flash_prefill(q, k, v)
    want = ops.flash_prefill_plain(q, k, v)
    torch.cuda.synchronize()
    assert ops.flash_prefill_cuda.launches == before + 1
    _hold_attention(got, want, dtype)


@pytest.mark.parametrize("kernel,args", [
    ("flash_decode_cuda", [(2, 4, 32), (2, 8, 1, 32), (2, 8, 1, 32)]),
    ("flash_prefill_cuda", [(1, 8, 4, 32), (1, 8, 1, 32), (1, 8, 1, 32)]),
])
def test_attention_kernels_refuse_cpu_tensors(kernel, args):
    """A wrapper launches its kernel or raises: CPU tensors go to the
    plain version through `ops`, never through the wrapper."""
    tensors = [torch.zeros(s) for s in args]
    if kernel == "flash_decode_cuda":
        tensors.append(torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(ops, kernel)(*tensors)


@pytest.mark.parametrize("B,F,V,D,dtype,weighted,combine", [
    (1, 1, 7, 1, torch.float32, False, "sum"),           # B = 1, F = 1
    (300, 39, 5000, 10, torch.float32, False, "sum"),    # FM's width
    (129, 50, 1000, 64, torch.float32, True, "mean"),
    (64, 13, 100, 128, torch.float32, True, "sum"),
    (77, 20, 300, 32, torch.bfloat16, True, "mean"),
    (50, 9, 40, 16, torch.bfloat16, False, "sum"),
])
def test_segment_bag_kernel_matches_plain_on_card(cuda_device, B, F, V, D,
                                                  dtype, weighted, combine):
    rng = np.random.default_rng(B + F + D)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.1] = -1
    if B > 1:
        ids[0] = -1                                      # an all-pad bag
    ids[-1, -1] = V + 5                                  # clamped to V - 1
    weights = (torch.from_numpy(rng.normal(size=(B, F)).astype(np.float32))
               .to(cuda_device) if weighted else None)
    table = table.to(device=cuda_device, dtype=dtype)
    ids = torch.from_numpy(ids).to(cuda_device)
    before = ops.segment_bag_cuda.launches
    got = ops.segment_bag(table, ids, weights, combine)
    want = ops.segment_bag_plain(table, ids, weights, combine)
    torch.cuda.synchronize()
    assert ops.segment_bag_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, D)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", BAG_EDGE_CASES)
def test_segment_bag_kernel_edge_cases_on_card(cuda_device, name, dtype):
    """The tile edge cases at the planned tile, with ids and weights as
    given and as views 4 bytes past a 16-byte boundary (the staged run's
    head and tail by plain loads): equal to the plain version in float32
    (weighted too: the same products and adds), to 5e-2 in bf16."""
    table, ids, w, _ = bag_edge_case(name)
    table = torch.from_numpy(table).to(cuda_device, dtype)
    ids = torch.from_numpy(ids).to(cuda_device)
    w = None if w is None else torch.from_numpy(w).to(cuda_device, dtype)
    want = ops.segment_bag_plain(table, ids, w)
    for ids_c, w_c in ((ids, w), (offset_view(ids),
                                  None if w is None else offset_view(w))):
        assert ids_c.data_ptr() % 16 in (0, 4)
        before = ops.segment_bag_cuda.launches
        got = ops.segment_bag(table, ids_c, w_c)
        torch.cuda.synchronize()
        assert ops.segment_bag_cuda.launches == before + 1
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            assert float((got.float() - want.float()).abs().max()) < 5e-2


def test_segment_bag_kernel_table_past_4_gib_on_card(cuda_device):
    """A float32 table of 4.6 GB, bags that read rows past its first 4 GiB
    (and ids past the table): equal to the plain version."""
    table, ids = bag_past_4gib(cuda_device)
    D = table.shape[1]
    assert table.numel() * 4 > 2**32
    assert bool((ids.long() * D * 4 >= 2**32).any())
    got = ops.segment_bag(table, ids)
    want = ops.segment_bag_plain(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
