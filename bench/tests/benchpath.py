"""Puts the benchmark's modules and the port on the path of a test module
(imported first by each test file of this folder)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config(name: str, n_docs: int = 60) -> dict:
    """A configuration of BENCHMARK.json cut to a test's size."""
    import json
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["n_docs"] = n_docs
    cfg["mean_doc_len"] = 400.0
    return cfg


def tiny_mix(name: str) -> dict:
    import generator
    mix = generator.load_mix(name)
    mix.update(batch=16, pool_batches=3, sample=48)
    return mix


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tests' CPU engines run many small tensor ops: one thread a test
    process, as the test suite runs several processes at once; restored
    after."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
