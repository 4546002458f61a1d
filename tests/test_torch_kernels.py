"""The port's kernel modules against the reference package's Pallas kernels.

The port's plain versions (repro_torch.kernels.ops.*_plain, which the CPU
path runs) must equal the reference's Pallas path in interpret mode
exactly — both are integer functions.  The CUDA kernels themselves run only
on a card: their tests take the `cuda_device` fixture, which skips without
one, and hold each kernel against its plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.batch_executor import BatchDeviceIndex
from repro_torch.core.postings import BLOCK, PACK_WIDTHS, PackedPostings
from repro_torch.kernels import ops

I32_MAX = np.iinfo(np.int32).max


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


def test_dispatch_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version; no build is attempted."""
    rng = np.random.default_rng(3)
    a, b, bands = _rebased_rows(rng, 4, 128, 128)
    ta, tb, tbands = map(torch.from_numpy, (a, b, bands))
    launches = ops.banded_intersect_rows_cuda.launches
    assert torch.equal(ops.banded_intersect_rows(ta, tb, tbands),
                       ops.banded_intersect_rows_plain(ta, tb, tbands))
    assert ops.banded_intersect_rows_cuda.launches == launches


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
