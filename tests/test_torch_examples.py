"""The port's search examples and its ring all-reduce, on the CPU.

`examples/torch_quickstart.py` and `examples/torch_search_serve.py` run in
this process at a small `--docs` with `--device cpu` (their asserts hold
the engines, segments and front door to the reference's behaviour);
`examples/torch_distributed_search.py` spawns two gloo ranks of the serve
tier, each checked bit for bit against the engine, and its ring
all-reduce against `all_reduce`.  `dist/collectives.make_ring_all_reduce`
runs on three gloo ranks, over the world and over a subgroup.
"""
import os
import runpy
import subprocess
import sys
import textwrap

import torch

from repro_torch.dist.collectives import make_ring_all_reduce

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_ROOT, "examples")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    src = os.path.join(_ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _example_main(name):
    return runpy.run_path(os.path.join(_EXAMPLES, name),
                          run_name="example")["main"]


def test_quickstart_example_on_cpu(capsys):
    # at 120 documents every query of the example finds its source
    # document (at 100 the reference's own K-word query finds none)
    _example_main("torch_quickstart.py")(["--docs", "120", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "corpus: 120 docs" in out and "(cpu)" in out
    assert "source document found by every query" in out
    assert "after merge: 1 segment(s)" in out


def test_search_serve_example_on_cpu(capsys):
    _example_main("torch_search_serve.py")(["--docs", "60", "--device",
                                            "cpu"])
    out = capsys.readouterr().out
    assert "16 submitted -> 16 exact" in out
    assert "front == engine.search_batch on all queries" in out
    assert "ranked front == ranked engine" in out
    assert "-> SERVED_EXACT" in out


def test_distributed_example_on_two_gloo_ranks():
    proc = subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, "torch_distributed_search.py"),
         "--device", "cpu", "--world", "2", "--docs", "60"],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "devices: 2 (gloo, cpu)" in out
    assert "serve over 2 shards == engine" in out
    assert "ranked serve over 2 shards == engine" in out
    assert "ring all-reduce max err" in out


_RING = """
import sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
from repro_torch.dist.collectives import make_ring_all_reduce
rank, addr = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", world_size=3, rank=rank, init_method=addr)
x = torch.arange(5, dtype=torch.int64) * 10 ** rank
assert torch.equal(make_ring_all_reduce()(x), torch.arange(5) * 111)
# a subgroup of global ranks 0 and 2: every rank creates it
sub = dist.new_group([0, 2])
if rank != 1:
    got = make_ring_all_reduce(sub)(x)
    assert torch.equal(got, torch.arange(5) * 101), got
f = torch.full((3,), 0.1 * (rank + 1))
fused = f.clone()
dist.all_reduce(fused)
assert float((make_ring_all_reduce()(f) - fused).abs().max()) < 1e-6
dist.destroy_process_group()
print("ok", rank)
"""


def test_ring_all_reduce_on_three_gloo_ranks(tmp_path):
    """Every rank gets the full sum (exact on integers), over the world and
    over a subgroup whose ranks are not the global ones."""
    script = tmp_path / "ring.py"
    script.write_text(textwrap.dedent(_RING.format(
        src=os.path.join(_ROOT, "src"))))
    addr = "file://" + str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), addr],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(3)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"ok {r}" in out


def test_ring_all_reduce_without_a_group_is_the_identity():
    x = torch.arange(4.0)
    assert make_ring_all_reduce()(x) is x
