"""The port's checkpoints and training supervisor against the reference
package, on the CPU.

`save_pytree` / `restore_pytree` round trips (float32, bf16 as its uint16
bits, int32, nested dicts and lists, a model's parameters with its AdamW
state), the reference's on-disk layout read both ways (the port restores
the reference's checkpoints and the reference the port's), keep-k
retention, the latest step, `.tmp` directories ignored; then
`TrainSupervisor` as tests/test_checkpoint.py drives the reference's
(failures at steps 7 and 13, the same report), on a real smoke-LM
training step of the port with failures (bit-equal to an uninterrupted
run), `max_restores`, and the rollback to the initial state when no
checkpoint is left.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.checkpoint import restore_pytree as ref_restore  # noqa: E402
from repro.checkpoint import save_pytree as ref_save  # noqa: E402
from repro.dist.fault_tolerance import TrainSupervisor as RefSupervisor  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.lm_data import lm_batches  # noqa: E402
from repro_torch.dist.fault_tolerance import (FailureReport,  # noqa: E402
                                              TrainSupervisor)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in parallel workers,
    and small training steps slow down tens of times when every worker's
    torch pool spans all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "h": torch.from_numpy(rng.normal(size=(3, 5)).astype(
                np.float32)).to(torch.bfloat16),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": [torch.ones(3), torch.zeros((2, 2))],
                       "s": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path / "ck"), t, step=5)
    got = restore_pytree(str(tmp_path / "ck"), _tree(1))
    _same(t, got)
    assert isinstance(got["nested"]["c"], list)
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 5
    by_key = {e["key"]: e for e in manifest["leaves"]}
    assert list(by_key) == ["a", "h", "nested/b", "nested/c/0",
                            "nested/c/1", "nested/s"]
    assert by_key["h"]["dtype"] == "bfloat16" and by_key["h"]["shape"] == [3, 5]
    assert by_key["nested/b"]["dtype"] == "int32"
    assert sorted(os.listdir(tmp_path / "ck")) == ["arrays.npz",
                                                   "manifest.json"]
    with pytest.raises(KeyError, match="no leaf"):
        restore_pytree(str(tmp_path / "ck"), {"missing": torch.zeros(1)})


def test_model_and_optimizer_state_roundtrip(tmp_path):
    """A bf16 model's parameters and its AdamW state (float32 moments, the
    int32 step) come back equal, on the device asked for."""
    cfg = dataclasses.replace(get_arch("llama3-8b").make_smoke_config(),
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = train_loop.param_dict(model)
    ocfg = opt.OptimizerConfig()
    state = opt.init_state(ocfg, params)
    state["mu"]["embed"].fill_(0.25)
    tree = {"params": params, "opt": state}
    save_pytree(str(tmp_path / "m"), tree, step=1)
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": opt.init_state(ocfg, params)}
    got = restore_pytree(str(tmp_path / "m"), like, device="cpu")
    _same(tree, got)
    assert got["params"]["embed"].dtype == torch.bfloat16


def test_reference_layout_read_both_ways(tmp_path):
    """The reference restores the port's float32 and int32 checkpoints, and
    the port the reference's."""
    t = _tree()
    del t["h"]
    save_pytree(str(tmp_path / "port"), t, step=3)
    jt = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t)
    got = ref_restore(str(tmp_path / "port"), jt)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    ref_save(str(tmp_path / "ref"), jt, step=3)
    _same(t, restore_pytree(str(tmp_path / "ref"), t))
    manifests = []
    for name in ("port", "ref"):
        with open(tmp_path / name / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]


def test_manager_keep_k_latest_and_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_tree()) == (None, None)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    os.makedirs(tmp_path / "step_00000009.tmp")      # a crashed writer
    os.makedirs(tmp_path / "step_notanumber")
    assert mgr.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d[5:].isdigit())
    assert dirs == ["step_00000003", "step_00000004"]
    step, got = mgr.restore_latest(_tree())
    assert step == 4
    _same(_tree(4), got)
    ref = RefManager(str(tmp_path), keep=2)
    assert ref.latest_step() == 4                    # the same directory rules


def _counting_step(state, i):
    return {"w": state["w"] + 1.0}


def _fail_once_at(steps):
    fired = set()

    def hook(step):
        if step in steps and step not in fired:
            fired.add(step)
            return True
        return False
    return hook


def test_supervisor_failure_injection_as_reference(tmp_path):
    sup = TrainSupervisor(CheckpointManager(str(tmp_path / "p"), keep=3),
                          save_every=5)
    state, report = sup.run({"w": torch.zeros(())}, _counting_step,
                            n_steps=20, failure_hook=_fail_once_at({7, 13}))
    ref_sup = RefSupervisor(RefManager(str(tmp_path / "r"), keep=3),
                            save_every=5)
    ref_state, ref_report = ref_sup.run(
        {"w": jnp.zeros(())}, lambda s, i: {"w": s["w"] + 1.0}, n_steps=20,
        failure_hook=_fail_once_at({7, 13}))
    assert report == FailureReport(failures=2, final_step=20, restores=2)
    assert (report.failures, report.final_step, report.restores) == (
        ref_report.failures, ref_report.final_step, ref_report.restores)
    assert float(state["w"]) == float(ref_state["w"]) == 20.0
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "r"))


def test_supervisor_max_restores_raises(tmp_path):
    sup = TrainSupervisor(CheckpointManager(str(tmp_path), keep=2),
                          save_every=5, max_restores=3)
    with pytest.raises(RuntimeError, match="3 restores without completing "
                                           "step 4"):
        sup.run({"w": torch.zeros(())}, _counting_step, n_steps=10,
                failure_hook=lambda step: step == 4)


class _ForgetfulManager(CheckpointManager):
    """Saves, but finds no checkpoint to restore."""

    def restore_latest(self, like, device=None):
        return None, None


def test_supervisor_rolls_back_to_the_initial_state(tmp_path):
    """With no checkpoint to restore, a failure replays from step 0 and the
    initial state, unchanged by in-place steps that ran before it."""
    def in_place_step(state, i):
        state["w"].add_(1.0)
        return state

    sup = TrainSupervisor(_ForgetfulManager(str(tmp_path)), save_every=100)
    state, report = sup.run({"w": torch.zeros(())}, in_place_step, n_steps=6,
                            failure_hook=_fail_once_at({4}))
    assert report == FailureReport(failures=1, final_step=6, restores=1)
    assert float(state["w"]) == 6.0


def test_supervisor_lm_step_with_failures_equals_uninterrupted(tmp_path):
    """A real port training step (llama3-8b smoke, AdamW) under the
    supervisor with failures at steps 3 and 5 (checkpoints every 2) ends
    with the same parameters and optimizer state, bit for bit, as the same
    steps run without a failure."""
    cfg = get_arch("llama3-8b").make_smoke_config()
    data = lm_batches(cfg.vocab, batch=2, seq_len=16, seed=1)
    batches = [{k: torch.from_numpy(v) for k, v in next(data).items()}
               for _ in range(6)]
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    step = train_loop.make_train_step(tfm.loss_fn, ocfg)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init = {k: p.detach().clone() for k, p in model.named_parameters()}

    def step_fn(state, i):
        train_loop.load_params(model, state["params"])
        _, opt_state, _ = step(model, state["opt"], batches[i - 1])
        return {"params": {k: p.detach().clone()
                           for k, p in model.named_parameters()},
                "opt": opt_state}

    def start():
        return {"params": {k: v.clone() for k, v in init.items()},
                "opt": opt.init_state(ocfg, init)}

    runs = []
    for name, hook in (("plain", None), ("faults", _fail_once_at({3, 5}))):
        sup = TrainSupervisor(CheckpointManager(str(tmp_path / name), keep=2),
                              save_every=2)
        runs.append(sup.run(start(), step_fn, n_steps=6, failure_hook=hook))
    (plain, plain_report), (faults, report) = runs
    assert plain_report == FailureReport(failures=0, final_step=6)
    assert report == FailureReport(failures=2, final_step=6, restores=2)
    _same(plain, faults)
    assert int(faults["opt"]["step"]) == 6
    assert not torch.equal(plain["params"]["embed"], init["embed"])
