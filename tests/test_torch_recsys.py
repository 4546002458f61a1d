"""The port's recsys serving path against the reference package, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
JAX function and the port's counterpart: the plain embedding bag
(`ops.segment_bag` on CPU tensors) against the reference's
`ops.segment_bag`, Pallas kernel in interpret mode and `ref` path alike;
and, with the reference's `init_params` weights carried by
`recsys_params_from_reference`, `serve_scores` and `retrieval_scores` of
the fm, autoint, bst and mind smoke configs on the same `ClickLog`
batches, and the retrieval step's top 128 against `jax.lax.top_k` on a
batch with ties.  Tolerances are the model zoo's: 2e-5 in float32, 5e-2
in bf16 (tests/test_kernels.py); scores are also held to 2e-5 of their
largest magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.data import recsys_data as ref_data  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import recsys as ref_rec  # noqa: E402
from repro_torch.carry import recsys_params_from_reference  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import recsys_data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import (recsys_retrieval_step,  # noqa: E402
                                      recsys_serve_step)
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.kernels.edge_cases import (BAG_EDGE_CASES,  # noqa: E402
                                            bag_edge_case)

TOL = {np.float32: 2e-5, "bf16": 5e-2}
DTYPES = {np.float32: (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
REC_ARCHS = ["fm", "autoint", "bst", "mind"]
N_CAND = 300


def _err(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0


def _held(want, got, tol=TOL[np.float32]):
    """Scores within `tol`, absolutely and of the largest |score|: MIND's
    scores are ~1e-4, where the absolute limit alone would pass zeros."""
    scale = float(np.abs(np.asarray(want)).max())
    err = _err(want, got)
    assert err < tol and err <= tol * scale, (err, scale)


# ---------------------------------------------------------------------------
# the embedding bag
# ---------------------------------------------------------------------------

def _bag_inputs(rng, B, F, V, D):
    """Seeded table, ids and weights: ~20% pads, bag 0 all pads, one id
    past the table (the reference clamps it to the last row)."""
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.2] = -1
    ids[0] = -1
    ids[-1, 0] = V + 3
    weights = rng.normal(size=(B, F)).astype(np.float32)
    return table, ids, weights


@pytest.mark.parametrize("D", [1, 10, 64])
@pytest.mark.parametrize("dt", [np.float32, "bf16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_segment_bag_plain_matches_reference(D, dt, combine):
    """Weighted bags against the Pallas kernel (interpret mode) and the
    `ref` path; unweighted bags against the `ref` path.  B * F <= 64: the
    interpreter runs one grid step per (b, f)."""
    rng = np.random.default_rng(D + (7 if combine == "mean" else 0))
    B, F, V = 8, 7, 50
    table, ids, weights = _bag_inputs(rng, B, F, V, D)
    jdt, tdt = DTYPES[dt]
    tj, ij, wj = jnp.asarray(table, jdt), jnp.asarray(ids), jnp.asarray(weights, jdt)
    tt, it = torch.from_numpy(table).to(tdt), torch.from_numpy(ids)
    wt = torch.from_numpy(weights).to(tdt)
    got_w = ops.segment_bag(tt, it, wt, combine)
    got = ops.segment_bag(tt, it, None, combine)
    assert got.dtype == tdt and got.shape == (B, D)
    for impl in ("pallas", "ref"):
        want = ref_ops.segment_bag(tj, ij, wj, combine, implementation=impl)
        assert _err(want, got_w) < TOL[dt], impl
    want = ref_ops.segment_bag(tj, ij, None, combine, implementation="ref")
    assert _err(want, got) < TOL[dt]
    assert float(got_w[0].abs().max()) == 0.0             # the all-pad bag


def test_segment_bag_plain_adds_fields_in_order():
    """Float32 sums field by field, f = 0 .. F-1, as the Pallas grid adds
    them: a bag whose order matters (1e8, 1, -1e8) gives 0, and pads are
    skipped, not added as zeros."""
    table = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    ids = torch.tensor([[0, 1, 2], [1, -1, 0], [-1, -1, -1]],
                       dtype=torch.int32)
    got = ops.segment_bag(table, ids)
    assert got[:, 0].tolist() == [0.0, 1e8, 0.0]
    want = ref_ops.segment_bag(jnp.asarray(table.numpy()),
                               jnp.asarray(ids.numpy()))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", BAG_EDGE_CASES)
def test_segment_bag_plain_tile_edge_cases_match_reference(name):
    """The embedding-bag kernel's tile edges (a ragged last tile, tiles off
    16-byte boundaries, fields past one stage, D = 1, all-pad bags at tile
    edges; `kernels/edge_cases.py::bag_edge_case`): the plain version
    against the reference's `ref` path to 2e-5, sum and mean, all-pad bags
    exactly zero."""
    table, ids, w, _ = bag_edge_case(name)
    tt, it = torch.from_numpy(table), torch.from_numpy(ids)
    wt = None if w is None else torch.from_numpy(w)
    pads = (ids < 0).all(axis=1)
    assert pads.any()
    for combine in ("sum", "mean"):
        got = ops.segment_bag(tt, it, wt, combine)
        want = ref_ops.segment_bag(jnp.asarray(table), jnp.asarray(ids),
                                   None if w is None else jnp.asarray(w),
                                   combine, implementation="ref")
        assert _err(want, got) < TOL[np.float32], combine
        assert float(got[torch.from_numpy(pads)].abs().max()) == 0.0


def test_segment_bag_on_cpu_takes_plain_version_and_checks_args():
    rng = np.random.default_rng(5)
    table, ids, weights = map(torch.from_numpy, _bag_inputs(rng, 4, 6, 30, 10))
    launches = ops.segment_bag_cuda.launches
    assert torch.equal(ops.segment_bag(table, ids.long(), weights, "mean"),
                       ops.segment_bag_plain(table, ids, weights, "mean"))
    assert ops.segment_bag_cuda.launches == launches
    with pytest.raises(ValueError, match="combine"):
        ops.segment_bag(table, ids, combine="max")
    with pytest.raises(ValueError, match="weights"):
        ops.segment_bag(table, ids, weights[:, :2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.segment_bag_cuda(table, ids, None)


# ---------------------------------------------------------------------------
# data, configs, registry
# ---------------------------------------------------------------------------

def test_click_log_gives_the_reference_arrays():
    vocabs = recsys_data.criteo_vocabs(12, max_vocab=3000)
    assert vocabs == ref_data.criteo_vocabs(12, max_vocab=3000)
    args = dict(embed_dim=8, item_vocab=5000, seq_len=9, seed=3)
    ours, ref = recsys_data.ClickLog(vocabs, **args), ref_data.ClickLog(vocabs, **args)
    for f in ref.teacher:
        assert np.array_equal(ours.teacher[f], ref.teacher[f])
    assert np.array_equal(ours.item_teacher, ref.item_teacher)
    for call in (lambda log: log.ctr_batch(33), lambda log: log.seq_batch(17),
                 lambda log: log.retrieval_batch(2, 40)):
        got, want = call(ours), call(ref)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recsys_configs_match_reference(arch):
    """The recsys archs resolve (the others still raise:
    tests/test_torch_lm.py) to the reference's numbers."""
    spec, ref_spec = registry.get_arch(arch), ref_registry.get_arch(arch)
    assert spec.family == ref_spec.family == "recsys"
    assert spec.shapes == ref_spec.shapes == ref_registry.RECSYS_SHAPES
    for make in ("make_config", "make_smoke_config"):
        ours = dataclasses.asdict(getattr(spec, make)())
        ref = dataclasses.asdict(getattr(ref_spec, make)())
        for k in ("dtype", "param_dtype"):
            assert ours.pop(k) == torch.float32
            assert ref.pop(k) == jnp.float32
        assert ours == ref


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=REC_ARCHS)
def pair(request):
    """(reference cfg, numpy params, port model on the CPU, numpy
    retrieval batch) for one smoke config."""
    arch = request.param
    ref_cfg = ref_registry.get_arch(arch).make_smoke_config()
    cfg = registry.get_arch(arch).make_smoke_config()
    params = jax.tree_util.tree_map(
        np.asarray, ref_rec.init_params(ref_cfg, jax.random.PRNGKey(0)))
    model = recsys_params_from_reference(params, cfg, device="cpu")
    log = recsys_data.ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                               seq_len=cfg.seq_len, seed=1)
    batch = log.retrieval_batch(16, N_CAND)
    batch.pop("label")
    return ref_cfg, params, model, batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_serve_scores_match_reference(pair):
    ref_cfg, params, model, batch = pair
    jb, tb = _both({k: v for k, v in batch.items() if k != "cand"})
    want = ref_rec.serve_scores(ref_cfg, params, jb)
    got = recsys_serve_step(model, tb)
    assert got.dtype == torch.float32 and got.shape == (16,)
    _held(want, got)
    assert float(got.abs().max()) > 0


def test_retrieval_scores_match_reference(pair):
    ref_cfg, params, model, batch = pair
    batch = {k: v[:2] if k != "cand" else v for k, v in batch.items()}
    jb, tb = _both(batch)
    want = ref_rec.retrieval_scores(ref_cfg, params, jb)
    got = rec.retrieval_scores(model, tb)
    assert got.shape == (2, N_CAND)
    _held(want, got)
    # the retrieval step's top 128 are the scores' top 128
    vals, idx = recsys_retrieval_step(model, tb)
    assert vals.shape == idx.shape == (2, 128)
    assert torch.equal(vals, torch.gather(got, 1, idx))
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())


@pytest.mark.parametrize("arch", ["fm", "autoint"])
def test_retrieval_top_k_breaks_ties_as_lax_top_k(arch):
    """Candidates drawn from 48 items, so every score repeats.  The top 128
    equal `jax.lax.top_k`'s on the port's own scores exactly (lower index
    first on ties).  Against the reference's top 128: FM's ties are exact
    (its sums run in a fixed order), so the indices are equal; AutoInt's
    batched products may differ in the last bit between equal rows, which
    reorders the copies of one item, so there every rank holds the same
    item as the reference's."""
    ref_cfg = ref_registry.get_arch(arch).make_smoke_config()
    cfg = registry.get_arch(arch).make_smoke_config()
    params = jax.tree_util.tree_map(
        np.asarray, ref_rec.init_params(ref_cfg, jax.random.PRNGKey(2)))
    model = recsys_params_from_reference(params, cfg, device="cpu")
    log = recsys_data.ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                               seed=4)
    batch = log.retrieval_batch(1, 400)
    cand = np.random.default_rng(4).integers(0, 48, 400).astype(np.int32)
    jb, tb = _both({"ids": batch["ids"], "cand": cand})
    vals, idx = recsys_retrieval_step(model, tb)
    scores = rec.retrieval_scores(model, tb)
    _, lax_idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 128)
    assert np.array_equal(idx.numpy(), np.asarray(lax_idx))
    ref_scores = np.asarray(ref_rec.retrieval_scores(ref_cfg, params, jb))[0]
    ref_vals, ref_idx = map(np.asarray, jax.lax.top_k(ref_scores, 128))
    idx = idx.numpy()[0]
    assert np.abs(ref_scores[idx] - ref_vals).max() < TOL[np.float32]
    assert np.array_equal(cand[idx], cand[ref_idx])
    if arch == "fm":
        assert len(set(scores[0].tolist())) <= 48
        assert np.array_equal(idx, ref_idx)


def test_fm_bag_reductions_go_through_the_op(monkeypatch):
    """fm_forward's two bag sums (field embeddings, linear term) are
    `ops.segment_bag` calls; the square term gathers the rows itself."""
    cfg = registry.get_arch("fm").make_smoke_config()
    model = rec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = ops.segment_bag

    def counted(table, ids, *args, **kw):
        calls.append((table.shape[1], tuple(ids.shape)))
        return real(table, ids, *args, **kw)

    monkeypatch.setattr(ops, "segment_bag", counted)
    log = recsys_data.ClickLog(cfg.field_vocabs, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in log.retrieval_batch(3, 50).items()}
    recsys_serve_step(model, batch)
    assert sorted(calls) == [(1, (3, 6)), (10, (3, 6))]
    recsys_retrieval_step(model, batch)
    assert sorted(calls[2:]) == [(1, (150, 6)), (10, (150, 6))]


def test_carry_checks_names_and_shapes():
    ref_cfg = ref_registry.get_arch("autoint").make_smoke_config()
    cfg = registry.get_arch("autoint").make_smoke_config()
    params = jax.tree_util.tree_map(
        np.asarray, ref_rec.init_params(ref_cfg, jax.random.PRNGKey(0)))
    model = recsys_params_from_reference(params, cfg, device="cpu")
    assert np.array_equal(model.attn[1].wres.numpy(), params["attn"][1]["wres"])
    bad = dict(params, head_w=params["head_w"][:-1])
    with pytest.raises(ValueError, match="head_w"):
        recsys_params_from_reference(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="autoint"):
        recsys_params_from_reference(dict(params, attn=params["attn"][:1]),
                                     cfg, device="cpu")


def test_recsys_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_arch("fm").make_smoke_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        rec.RecSysModel(cfg)
    assert rec.RecSysModel(cfg, device="cpu").device.type == "cpu"
