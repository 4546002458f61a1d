"""The readers of the program's spans and counters, the idle gaps charged
to `repro.` spans (bench/progspans.py) and the `[spans]` lines of a run
(bench/spans.py)."""
import pytest

import benchpath
from benchpath import one_torch_thread  # noqa: F401
import cell
import progspans

READERS = ("launch_ms", "d2h_ms", "h2d_ms", "scatter_ms", "batch_self_ms",
           "steps_per_batch", "copies_per_batch")


def _record(**timings):
    t = dict.fromkeys(("plan", "rows", "tensorize", "device", "merge",
                       "flex"), 0.0)
    t.update(timings)
    return {"batches": 4, "timings": t}


def test_readers_read_the_spans_and_counters():
    rec = _record(batch=1.0, plan=0.1, rows=0.2, bucket=0.01, tensorize=0.1,
                  h2d=0.04, device=0.4, launch=0.3, d2h=0.08, scatter=0.02,
                  collect=0.01, merge=0.05, flex=0.03)
    rec["counts"] = {"batches": 5, "steps": 100, "h2d_copies": 1200,
                     "d2h_copies": 200}
    got = {n: cell.load_reader(n)(rec) for n in READERS}
    assert got == pytest.approx({
        "launch_ms": 75.0, "d2h_ms": 20.0, "h2d_ms": 10.0, "scatter_ms": 5.0,
        # 1.0 less the direct children's 0.92 s, over 4 batches
        "batch_self_ms": 20.0,
        "steps_per_batch": 20.0, "copies_per_batch": 280.0})


@pytest.mark.parametrize("rec", [
    _record(),                                     # a program without them
    _record(batch=0.0, launch=0.0, d2h=0.0, h2d=0.0, scatter=0.0),
    # children that cover the whole batch leave no self time
    _record(batch=1.0, rows=0.6, device=0.4)])
def test_readers_find_nothing_where_the_program_has_nothing(rec):
    rec["counts"] = {"batches": 4, "steps": 0, "h2d_copies": 0,
                     "d2h_copies": 0}
    for n in READERS:
        assert cell.load_reader(n)(rec) is None
    del rec["counts"]
    for n in ("steps_per_batch", "copies_per_batch"):
        assert cell.load_reader(n)(rec) is None


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


def test_idle_gaps_go_to_the_innermost_program_span():
    ev = [_Ev("bench.window", "CPU", 0, 1000),
          _Ev("bench.batch", "CPU", 0, 1000),        # the harness's: ignored
          _Ev("bench.device_step", "CPU", 300, 400),
          _Ev("repro.batch", "CPU", 0, 950),
          _Ev("repro.tensorize", "CPU", 0, 300),
          _Ev("repro.h2d", "CPU", 200, 100),
          _Ev("repro.device", "CPU", 300, 400),
          _Ev("repro.launch", "CPU", 300, 250),
          _Ev("repro.d2h", "CPU", 550, 150),
          _Ev("repro.launch", "CPU", 2000, 10),        # after the window
          _Ev("unpack_postings_kernel", "CUDA", 100, 80),
          _Ev("unpack_postings_kernel", "CUDA", 250, 10),
          _Ev("banded_intersect_rows_kernel", "CUDA", 350, 100),
          _Ev("bench.device_step", "CUDA", 350, 300),  # an annotation
          _Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 600, 50),
          _Ev("unpack_postings_kernel", "CUDA", 960, 10)]
    p = progspans.program_spans(ev)
    # each gap goes whole to the innermost span at its middle: [0, 100)
    # tensorize, [180, 250) h2d, [260, 350) and [450, 600) launch,
    # [650, 960) the batch's self time, [970, 1000) outside
    assert dict(p["idle_gaps"]) == pytest.approx({
        "repro.tensorize": 100e-9, "repro.h2d": 70e-9,
        "repro.launch": 240e-9, "repro.batch": 310e-9,
        progspans.OUTSIDE: 30e-9})
    assert p["idle_s"] == pytest.approx(750e-9)
    assert p["named_share"] == pytest.approx(410 / 750)
    assert p["ranges"] == {"repro.batch": 1, "repro.tensorize": 1,
                           "repro.h2d": 1, "repro.device": 1,
                           "repro.launch": 1, "repro.d2h": 1}


@pytest.fixture
def spans(monkeypatch):
    """bench/spans.py; the thread variables that importing bench/run.py
    sets are put back after the test."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    import spans
    return spans


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_logs_its_spans(spans, trace):
    cfg = benchpath.tiny_config("ordinary-phrase")
    mix = benchpath.tiny_mix("paper64")
    lines = []
    with spans.hooks():
        res = cell.run_cell(cfg, mix, 2**31 + 5, 0.3, trace, "cpu",
                            {"qps": "req/s"}, 0.0, log=lines.append)
    assert res["correct"] is True
    assert cell.run_cell.__name__ == "run_cell"      # the hooks are gone
    spans_lines = [x for x in lines if x.startswith("[spans] batches=")]
    assert len(spans_lines) == 1
    fields = dict(kv.split("=") for kv in spans_lines[0].split()[1:])
    window = next(x for x in lines if x.startswith("[window]"))
    assert f" batches={fields['batches']} " in window
    assert float(fields["launch_ms"]) > 0 and float(fields["steps"]) >= 1
    idle = [x for x in lines if x.startswith("[spans] idle_gaps=")]
    assert len(idle) == (1 if trace else 0)
    if trace:
        assert "repro." in idle[0]
