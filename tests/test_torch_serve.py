"""The port's serve tier (`repro_torch.serve.search_serve`) on the CPU,
against the reference package's `SearchServe` and the port's own engine.

Same corpus, same requests: on a one-rank mesh the port's `SearchServe`
returns exactly the reference serve's responses — doc, pos, postings_read,
used_fallback, doc_only, subplan_types and the ranked fields, float32
scores bit for bit — on the paper's phrase / near stream, ranked requests,
K-word requests (ranked or not, a window wider than the device masks
included), scrambled-order queries that take the doc-only fallback, and at
a fine doc-shard grain.  On the full query fixtures it equals the port's
own `search_batch`.  Also: the tier ladder's dump / load round trip, the
smoke config's dry-run shapes through the serve step, the engine options
the serve tier uses, and the search launcher.  Two gloo ranks over the CPU
(a subprocess each, as tests/test_dist.py spawns JAX) equal one rank.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import SearchRequest as RefRequest
from repro_torch.core import AdditionalIndexEngine, SearchRequest
from repro_torch.core.kword import KW_DEVICE_MAX_WINDOW
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.search_serve import (SearchServe, SearchServeConfig,
                                            arena_specs,
                                            make_search_serve_step,
                                            query_table_specs)
from test_torch_engine import _scrambled_queries
from test_torch_ranked import assert_same_response, carried_world

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_cfg():
    # tiny arena segment sizes: the real arenas come from the index; the n_*
    # fields only size the dry-run shapes (tests/test_serve.py's config)
    return SearchServeConfig(queries=16, postings_pad=4096, seed_pad=1024,
                             n_basic=1, n_expanded=1, n_stop=1, n_first=1,
                             n_multi=1)


def _cpu_mesh():
    return make_host_mesh(data=1, model=1, device="cpu")


@pytest.fixture(scope="module")
def port_world(small_world):
    return carried_world(small_world)


@pytest.fixture(scope="module")
def request_sets(small_world, paper_queries, stop_near_queries,
                 kword_queries):
    """The compared requests (as SearchRequest keyword dicts) by kind."""
    kw = kword_queries[:16]
    assert any(w > KW_DEVICE_MAX_WINDOW for _, w, _ in kw)
    return {
        "paper": [dict(surface_ids=q, mode=m) for q, m, _ in paper_queries[:24]],
        "ranked": [dict(surface_ids=q, mode="near", rank=True)
                   for q, _ in stop_near_queries[:8]]
        + [dict(surface_ids=q, mode=m, rank=True, top_k=k)
           for (q, m, _), k in zip(paper_queries[24:32], [None, 2] * 4)],
        "kword": [dict(surface_ids=q, mode="kword", window=w, rank=i % 2 == 1)
                  for i, (q, w, _) in enumerate(kw)],
        "fallback": [dict(surface_ids=q)
                     for q in _scrambled_queries(small_world["corpus"])],
    }


@pytest.fixture(scope="module")
def ref_serve(small_world):
    """One reference SearchServe for the file (its steps compile once per
    shape variant)."""
    from repro.launch.mesh import make_host_mesh as ref_mesh
    from repro.serve.search_serve import SearchServe as RefServe
    from repro.serve.search_serve import SearchServeConfig as RefConfig
    cfg = RefConfig(**{f: getattr(_serve_cfg(), f)
                       for f in ("queries", "postings_pad", "seed_pad",
                                 "n_basic", "n_expanded", "n_stop",
                                 "n_first", "n_multi")})
    return RefServe(small_world["index"], cfg, ref_mesh(data=1, model=1))


@pytest.fixture(scope="module")
def ref_responses(ref_serve, request_sets):
    """The reference serve's responses to every request set, asked as one
    batch so that the sets share step shapes."""
    union = [r for name in request_sets for r in request_sets[name]]
    want = ref_serve.search_batch([RefRequest(**r) for r in union])
    out, i = {}, 0
    for name, reqs in request_sets.items():
        out[name] = want[i:i + len(reqs)]
        i += len(reqs)
    return out


@pytest.fixture(scope="module")
def port_serve(port_world):
    return SearchServe(port_world["index"], _serve_cfg(), _cpu_mesh())


@pytest.fixture(scope="module")
def port_responses(port_serve, request_sets):
    union = [r for name in request_sets for r in request_sets[name]]
    got = port_serve.search_batch([SearchRequest(**r) for r in union])
    out, i = {}, 0
    for name, reqs in request_sets.items():
        out[name] = got[i:i + len(reqs)]
        i += len(reqs)
    return out


@pytest.mark.parametrize("name", ["paper", "ranked", "kword", "fallback"])
def test_serve_matches_reference_serve(request_sets, ref_responses,
                                       port_responses, name):
    reqs = request_sets[name]
    want, got = ref_responses[name], port_responses[name]
    assert len(got) == len(reqs)
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)
    if name == "fallback":
        assert any(g.used_fallback for g in got)
    elif name == "ranked":
        assert sum(len(g.doc_ids) for g in got) > 0
    else:
        assert sum(len(g.doc) for g in got) > 0


def test_serve_routes_and_tiers_like_reference(ref_serve, port_serve,
                                               ref_responses, port_responses):
    """The same tier ladder and the same rows, live elements and steps:
    the port tensorizes the batch exactly as the reference serve does."""
    assert port_serve.executor._tiers == ref_serve.executor._tiers
    assert port_serve.executor.slab_stats == ref_serve.executor.slab_stats
    # one rank, no process group: the merge is the identity, not a call
    assert port_serve.executor.collectives == 0
    t = port_serve.executor.timings
    assert t["plan"] > 0 and t["rows"] > 0 and t["device"] > 0


def test_serve_fine_shard_grain_matches_reference(port_world, request_sets,
                                                  ref_responses):
    """docs_per_shard=16 multiplies rows (>= 8 doc shards); the responses
    stay the reference serve's, bit for bit."""
    serve = SearchServe(port_world["index"], _serve_cfg(), _cpu_mesh(),
                        docs_per_shard=16)
    assert serve.executor.dev.n_shards >= 8
    for name in ("paper", "ranked"):
        reqs = request_sets[name]
        got = serve.search_batch([SearchRequest(**r) for r in reqs])
        for r, w, g in zip(reqs, ref_responses[name], got):
            assert_same_response(w, g, r)
    assert serve.executor.slab_stats["live_rows"] > \
        serve.executor.slab_stats["steps"]


@pytest.mark.parametrize("fixture", ["paper_queries", "stop_near_queries",
                                     "kword_queries"])
def test_serve_matches_port_engine_on_full_fixtures(request, port_world,
                                                    port_serve, fixture):
    """Every request of the fixture, unranked and ranked, against the port's
    own search_batch."""
    queries = request.getfixturevalue(fixture)
    if fixture == "paper_queries":
        base = [dict(surface_ids=q, mode=m) for q, m, _ in queries]
    elif fixture == "stop_near_queries":
        base = [dict(surface_ids=q, mode="near") for q, _ in queries]
    else:
        base = [dict(surface_ids=q, mode="kword", window=w)
                for q, w, _ in queries]
    reqs = [SearchRequest(**r, rank=rank) for rank in (False, True)
            for r in base]
    want = port_world["additional"].search_batch(reqs)
    got = port_serve.search_batch(reqs)
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)


def test_serve_tier_ladder_round_trip(port_world, port_serve, port_responses,
                                      request_sets, tmp_path):
    """dump_tiers / load_tiers: a fresh executor warmed from file carries
    the learned ladder verbatim and answers bit-identically; stale entries
    beyond the caps are clipped, junk entries dropped, a missing file
    refused (tests/test_kword.py's reference scenario)."""
    be = port_serve.executor
    assert be._tiers, "the serve executor never derived a tier ladder"
    path = tmp_path / "tiers.json"
    assert be.dump_tiers(path)
    cfg = _serve_cfg()
    fresh = SearchServe(port_world["index"], cfg, _cpu_mesh())
    assert not fresh.executor.dump_tiers(tmp_path / "none.json")
    assert fresh.executor._tiers is None
    assert fresh.executor.load_tiers(path)
    assert fresh.executor._tiers == be._tiers
    reqs = request_sets["kword"]
    for r, w, g in zip(reqs, port_responses["kword"],
                       fresh.search_batch([SearchRequest(**r) for r in reqs])):
        assert_same_response(w, g, r)
    assert not fresh.executor.load_tiers(tmp_path / "missing.json")
    stale = {"tiers": [[9999, 9999, 99999, 99999], [0, 1, 1, 1], [2, 1]]}
    (tmp_path / "stale.json").write_text(json.dumps(stale))
    assert fresh.executor.load_tiers(tmp_path / "stale.json")
    cap = (cfg.groups, cfg.fetch_slots, cfg.p_seed, cfg.postings_pad)
    assert fresh.executor._tiers == [cap]          # clipped, junk dropped
    (tmp_path / "junk.json").write_text(json.dumps({"tiers": [[0, 1, 1, 1]]}))
    assert not fresh.executor.load_tiers(tmp_path / "junk.json")


def _dryrun_tables(cfg):
    t = {}
    for k, (shape, dtype) in query_table_specs(cfg).items():
        fill = {"length": 16, "active": True, "req_dist": -128,
                "max_abs": 2**20, "ns_packed": -1}.get(k, 0)
        t[k] = torch.full(shape, fill, dtype=dtype)
    return t


@pytest.mark.parametrize("ranked", [False, True])
def test_serve_smoke_dryrun_shapes(ranked):
    """The smoke config's serve step on random packed arenas shaped by
    `arena_specs` (one rank's row) and tables shaped by
    `query_table_specs`: [T, F*P0] int64 keys, bool found, float32 scores
    when ranked — and the same keys as the reference's step."""
    import dataclasses
    import jax
    from repro.configs.registry import get_arch as ref_get_arch
    from repro.launch.mesh import make_host_mesh as ref_mesh
    from repro.serve.search_serve import \
        make_search_serve_step as ref_make_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.postings import PackedPostings
    cfg = dataclasses.replace(get_arch("veretennikov").make_smoke_config(),
                              ranked=ranked)
    ref_cfg = dataclasses.replace(
        ref_get_arch("veretennikov").make_smoke_config(), ranked=ranked)
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(ref_cfg).items()
        if k not in ("impl", "interpret")}
    rng = np.random.default_rng(0)
    pp = PackedPostings.from_columns(
        {"doc": np.sort(rng.integers(0, 50, cfg.n_arena)).astype(np.int32),
         "pos": rng.integers(0, 400, cfg.n_arena).astype(np.int32),
         "dist": rng.integers(-5, 6, cfg.n_arena).astype(np.int8)},
        fields=("doc", "pos", "dist"))
    specs = arena_specs(cfg, 1)
    arenas = {}
    for k, v in (("lanes", pp.lanes), ("blk_meta", pp.meta_matrix())):
        buf = np.zeros(specs[k][0], np.int32)
        assert len(v) <= buf.shape[1], (k, len(v))    # the spec budgets hold
        buf[0, :len(v)] = v
        arenas[k] = buf
    arenas["basic_ns"] = np.full(specs["basic_ns"][0], -1, np.int16)
    t = _dryrun_tables(cfg)
    # each row's groups read one random slice, so that its seed keys are
    # found in its constraint groups
    T, G, F = t["start"].shape
    t["start"] = torch.from_numpy(np.broadcast_to(
        rng.integers(0, pp.n - 16, (T, 1, 1)), (T, G, F)).astype(np.int32))
    out = make_search_serve_step(cfg, _cpu_mesh())(
        {k: torch.from_numpy(v[0]) for k, v in arenas.items()}, t)
    R, W = cfg.task_rows, cfg.fetch_slots * cfg.p_seed
    assert len(out) == (3 if ranked else 2)
    assert out[0].shape == out[1].shape == (R, W)
    assert out[0].dtype == torch.int64 and out[1].dtype == torch.bool
    if ranked:
        assert out[2].shape == (R, W) and out[2].dtype == torch.float32
    assert bool(out[1].any())
    ref_step = jax.jit(ref_make_step(ref_cfg, ref_mesh(data=1, model=1)))
    with ref_mesh(data=1, model=1):
        want = ref_step({k: jax.numpy.asarray(v) for k, v in arenas.items()},
                        {k: jax.numpy.asarray(v.numpy())
                         for k, v in t.items()})
    for g, w in zip(out, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_engine_serve_options(port_world, paper_queries):
    """The engine options the serve tier uses: `occ_counts` (cluster-wide
    pivot statistics), `refresh_occ_counts` and `plan` introspection."""
    index = port_world["index"]
    counts = index.base_occ_counts()
    eng = AdditionalIndexEngine(index, device="cpu", occ_counts=counts * 2)
    q, m, _ = paper_queries[1]
    plan = eng.plan(q, mode=m)
    assert plan == eng.plan_request(SearchRequest(q, mode=m))
    assert np.array_equal(eng.planner._occ_counts, counts * 2)
    eng.refresh_occ_counts()
    assert np.array_equal(eng.planner._occ_counts, counts)
    serve = SearchServe(index, _serve_cfg(), _cpu_mesh(), occ_counts=counts)
    assert serve.plan(q, mode=m) == plan
    serve.refresh_occ_counts(counts * 3)
    assert np.array_equal(serve.planner._occ_counts, counts * 3)
    assert serve.n_dp == 1
    with pytest.raises(TypeError):
        serve.search_batch([(q, m)])


def test_batch_device_index_serve_hooks(port_world):
    """The lazy device arena and the host columns the serve tier re-packs:
    pads (stream tails, the multi stream's pair pad) are not real."""
    from repro_torch.core.batch_executor import BatchDeviceIndex
    index = port_world["index"]
    dev = BatchDeviceIndex(index, "cpu")
    assert dev._dev_arena is None
    n_real = (index.basic.occurrences.n_postings
              + index.expanded.pairs.n_postings
              + index.stop_phrase.phrases.n_postings
              + index.basic.first_occ.n_postings
              + index.ordinary.n_postings
              + index.multi_key.pairs.n_postings
              + index.multi_key.triples.n_postings)
    assert int(dev.arena_real_np.sum()) == n_real
    assert len(dev.arena_pos_np) == len(dev.arena_dist_np) == \
        len(dev.arena_doc_np) == dev.packed.n_padded
    assert dev.device_nbytes() == sum(
        t.numel() * t.element_size() for t in dev.device_arena.values())
    assert dev._dev_arena is not None


def test_veretennikov_resolves():
    from repro.configs.registry import get_arch as ref_get_arch
    from repro_torch.configs.registry import get_arch
    spec = get_arch("veretennikov")
    assert spec.family == "search"
    assert spec.shapes == ref_get_arch("veretennikov").shapes
    assert spec.make_config().n_arena == ref_get_arch(
        "veretennikov").make_config().n_arena


def test_mesh_needs_a_group_beyond_one_rank(monkeypatch):
    mesh = _cpu_mesh()
    assert (mesh.data, mesh.model, mesh.dp_rank, mesh.dp_size) == (1, 1, 0, 1)
    assert not mesh.distributed and mesh.device.type == "cpu"
    with pytest.raises(ValueError):
        make_host_mesh(data=2, model=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(data=1, model=1)


def test_search_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--mode", "search", "--queries", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve/search] 4 phrase queries" in out and "CPU" in out
    # the open loop (--qps) through the front door prints the reference's
    # line; at 5 qps the CPU keeps up, so nothing sheds or degrades
    main(["--mode", "search", "--qps", "5", "--duration", "1",
          "--deadline-ms", "5000", "--queries", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve/search] open-loop phrase: offered" in out
    assert "degraded 0, shed 0 (shed_rate 0.000)" in out


# ---------------------------------------------------------------------------
# two dp ranks over gloo
# ---------------------------------------------------------------------------

_RANK = """
import os, pickle, sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
import repro_torch.serve.search_serve as ss
from repro_torch.launch.mesh import make_host_mesh
rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)         # two ranks share the host's cores
dist.init_process_group("gloo", world_size=2, rank=rank,
                        init_method="file://" + os.path.join(tmp, "store"))
with open(os.path.join(tmp, "world.pkl"), "rb") as fh:
    index, cfg, reqs = pickle.load(fh)
# rows this rank executes: the step masks every row it does not own
own_rows = []
step_math = ss.bucket_step_math

def recording_step_math(arena, t, **kw):
    own_rows.append(int(t["active"].any(1).sum()))
    return step_math(arena, t, **kw)

ss.bucket_step_math = recording_step_math
mesh = make_host_mesh(data=2, model=1, device="cpu")
serve = ss.SearchServe(index, cfg, mesh, docs_per_shard=16)
got = serve.search_batch(reqs)
ex = serve.executor
with open(os.path.join(tmp, f"rank{{rank}}.pkl"), "wb") as fh:
    pickle.dump({{"got": got, "own_rows": sum(own_rows),
                 "dp_rank": mesh.dp_rank, "collectives": ex.collectives,
                 "steps": ex.slab_stats["steps"],
                 "live_rows": ex.slab_stats["live_rows"],
                 "arena_blocks": int(ex.arenas["blk_meta"].shape[0])}}, fh)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_match_one_rank(port_world, request_sets,
                                       ref_responses, port_responses,
                                       tmp_path):
    """Two dp ranks, each holding half the arena, merge by all_reduce into
    exactly the one-rank port serve's and the reference serve's responses
    (ranked scores included); rows are owned by both ranks."""
    names = ("paper", "ranked", "kword")
    reqs = [SearchRequest(**r) for n in names for r in request_sets[n]]
    with open(tmp_path / "world.pkl", "wb") as fh:
        pickle.dump((port_world["index"], _serve_cfg(), reqs), fh)
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(_RANK.format(
        src=os.path.join(_ROOT, "src"))))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    assert [d["dp_rank"] for d in ranks] == [0, 1]
    want_ref = [w for n in names for w in ref_responses[n]]
    want_port = [w for n in names for w in port_responses[n]]
    for d in ranks:
        # both dp shards own rows, and every live row has one owner
        assert 0 < d["own_rows"] < d["live_rows"]
        # one MIN a step, one MAX more for ranked steps
        assert d["steps"] < d["collectives"] < 2 * d["steps"]
        for r, wr, wp, g in zip(reqs, want_ref, want_port, d["got"]):
            assert_same_response(wr, g, r)
            assert_same_response(wp, g, r)
    assert ranks[0]["own_rows"] + ranks[1]["own_rows"] == \
        ranks[0]["live_rows"]
    assert ranks[0]["collectives"] == ranks[1]["collectives"]
    # each rank holds its own part of the arena only
    n_blocks = port_world["additional"].batch_executor.dev.packed.n_blocks
    assert max(d["arena_blocks"] for d in ranks) < n_blocks
