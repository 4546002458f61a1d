"""The harness: discovery by name, the result line's schema, the trace's
reduction, and a run broken underneath that must come out not correct."""
import json
import subprocess
import sys

import numpy as np
import pytest

import benchpath
from benchpath import one_torch_thread  # noqa: F401
import cell
import devtrace
import generator

SPEC = json.loads((benchpath.ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_and_readers():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cfg = cell.load_json(benchpath.ROOT / configs[w["config"]]["file"])
        assert cfg["engine"] in cell.ENGINES
        generator.load_mix(w["traffic"])
        for group in ("end_to_end", "per_layer"):
            names = [m["name"] for m in SPEC[group]
                     if w["name"] in m.get("workloads", [w["name"]])]
            assert names
            for n in names:
                assert callable(cell.load_reader(n))
    for c in SPEC["configs"]:
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        generator.load_mix("no-such-mix")
    with pytest.raises(FileNotFoundError):
        cell.load_reader("no_such_metric")


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without one")
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(benchpath.BENCH / "run.py"), "--workload", w,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=benchpath.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def _run(cfg_name, mix_name, trace=False, seconds=0.3):
    cfg = benchpath.tiny_config(cfg_name)
    mix = benchpath.tiny_mix(mix_name)
    group = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    wl = f"{cfg_name}.{mix_name}"
    metrics = {m["name"]: m["unit"] for m in group
               if wl in m.get("workloads", [wl])}
    lines = []
    res = cell.run_cell(cfg, mix, 2**31 + 3, seconds, trace, "cpu", metrics,
                        0.0, log=lines.append)
    return res, lines


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    res, lines = _run("ordinary-ranked", "paper64", trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["compared"]) == {"wrong_answers", "score_rel_gap"}
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "plan_ms" in res["metrics"]
    else:
        assert {"qps", "p95_ms", "setup_s"} <= set(res["metrics"])
    json.dumps(res)


def _broken(monkeypatch, how):
    """Break the engine's batch call underneath the harness."""
    from repro_torch.core import engine as eng
    real = eng._BatchSearchMixin.search_batch
    last = {}

    def broken(self, requests):
        out = real(self, requests)
        if how == "half_batch":
            keep = len(out) // 2
            out = out[:keep] + [real(self, [requests[0]])[0]
                                for _ in out[keep:]]
        elif how == "altered":
            for r in out:
                if len(r.pos):
                    r.pos = r.pos.copy()
                    r.pos[-1] += 1
        elif how == "unchanged":
            prev, last["out"] = last.get("out"), out
            if prev is not None:
                out = prev
        return out

    monkeypatch.setattr(eng._BatchSearchMixin, "search_batch", broken)


@pytest.mark.parametrize("how", ["half_batch", "altered", "unchanged"])
@pytest.mark.parametrize("cfg_name,mix_name", [
    ("ordinary-phrase", "paper64"), ("ordinary-ranked", "paper64"),
    ("ordinary-phrase", "kword64")])
def test_broken_path_is_not_correct(monkeypatch, how, cfg_name, mix_name):
    _broken(monkeypatch, how)
    res, _ = _run(cfg_name, mix_name)
    assert res["correct"] is False
    assert res["compared"]["wrong_answers"]["value"] > 0


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_reduce_trace_unions_busy_time_and_names_the_gaps():
    ev = [_Ev("bench.window", "CPU", 0, 1000),
          _Ev("bench.batch", "CPU", 0, 1000),
          _Ev("bench.rows", "CPU", 0, 300),
          _Ev("bench.device_step", "CPU", 300, 400),
          _Ev("unpack_postings_kernel", "CUDA", 350, 100),
          _Ev("banded_intersect_rows_kernel", "CUDA", 400, 100),
          _Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 600, 50),
          _Ev("bench.batch", "CUDA", 0, 1000),
          _Ev("unpack_postings_kernel", "CUDA", 2000, 10)]
    r = devtrace.reduce_trace(ev)
    assert r["window_s"] == 1e-6
    assert r["busy_s"] == pytest.approx(200e-9)          # [350, 500) + [600, 650)
    assert r["n_kernels"] == 2
    gaps = dict(r["idle_gaps"])
    # each gap goes to the innermost span at its middle: [0, 350) to rows,
    # [500, 600) to the device step, [650, 1000) to the batch
    assert gaps["bench.rows"] == pytest.approx(350e-9)
    assert gaps["bench.device_step"] == pytest.approx(100e-9)
    assert gaps["bench.batch"] == pytest.approx(350e-9)
    assert devtrace.kernel_seconds(r, "unpack_postings_kernel") == [1e-7]


def test_forbidden_modules_compare_whole_names():
    loaded = ["numpy", "repro_torch.core", "reprox", "jaxtyping"]
    assert cell.forbidden_modules(loaded) == []
    assert cell.forbidden_modules(loaded + ["jax.numpy", "repro.core"]) == \
        ["jax", "repro"]


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port "
                    "on the card")
    return torch.device("cuda")


def test_cell_runs_on_the_card(cuda_device):
    """One short run of the first cell on the card: a result line that is
    correct and reports every end-to-end metric."""
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(benchpath.BENCH / "run.py"), "--workload", w,
         "--seed", "11", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=benchpath.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert {m["name"] for m in SPEC["end_to_end"]} <= set(res["metrics"])
    assert res["device"]["platform"] == "gpu"


def test_index_cache_keeps_the_built_index(tmp_path):
    """The first run of a checkout builds the index and keeps it; the next
    loads the same index; another configuration gets a key of its own."""
    from inputs import make_corpus, make_lexicon
    cfg = benchpath.tiny_config("ordinary-phrase", n_docs=30)
    lex = make_lexicon(cfg)
    off, tok = make_corpus(cfg, lex)
    first, built = cell.cached_index(cfg, lex, off, tok, tmp_path)
    assert built and len(list(tmp_path.glob("index-*.pkl"))) == 1
    again, built = cell.cached_index(cfg, lex, off, tok, tmp_path)
    assert not built
    assert np.array_equal(again.ordinary.offsets, first.ordinary.offsets)
    assert np.array_equal(again.ordinary_packed.lanes,
                          first.ordinary_packed.lanes)
    ranked = benchpath.tiny_config("ordinary-ranked", n_docs=30)
    assert cell.index_key(ranked) == cell.index_key(cfg)
    assert cell.index_key(dict(cfg, n_docs=31)) != cell.index_key(cfg)
