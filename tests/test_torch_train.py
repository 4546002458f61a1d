"""The port's single-device training against the reference package, on the
CPU.

The same inputs, made with numpy from a seed, go through the reference's
JAX function and the port's counterpart: the three optimizers over 20
steps of tests/test_train.py's toy problem, `lr_schedule`,
`clip_by_global_norm`, gradient accumulation over 4 microbatches; with the
reference's `init_params` weights carried in float32, one `loss_fn` +
AdamW step of the llama3-8b (vocabulary cut to 500, so the padding rows
are masked), qwen2.5-32b (`qkv_bias`) and granite-moe-1b-a400m (capacity
dispatch, aux loss) smoke configs on a batch with labels of -100, and of
the fm, autoint, bst and mind smoke configs: loss, metrics, every gradient
and every updated parameter.  The chunked attention's gradient against
`jax.grad` of the reference's; `ops.SegmentBagFn`'s backward (the bag
kernel's, run here with the plain forward) against autograd through the
plain bag; `lm_batches`; then the port alone: remat on equal to off, `fit`
on the tiny LM, `launch/train.py` and `examples/torch_train_lm.py` on the
CPU.  Tolerance: the model zoo's float32 2e-5 (tests/test_kernels.py),
absolute and of the largest magnitude; the toy optimizers 2e-6.
"""
import dataclasses
import os
import runpy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data import lm_data as ref_lm_data  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recsys as ref_rec  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_loop as ref_loop  # noqa: E402
from repro_torch.carry import (lm_params_from_reference,  # noqa: E402
                               recsys_params_from_reference)
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.data.recsys_data import ClickLog  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

TOL = 2e-5
TOY_TOL = 2e-6
_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in parallel workers,
    and small training steps slow down tens of times when every worker's
    torch pool spans all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _held(want, got, tol=TOL, what="", of_scale=True):
    """got within `tol` of want, absolutely and (unless `of_scale` is off)
    of want's largest |value|."""
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = float(np.abs(want - got).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err < tol, (what, err, scale)
    assert not of_scale or err <= tol * max(scale, 1e-30), (what, err, scale)


# ---------------------------------------------------------------------------
# optimizers and the step on tests/test_train.py's toy problem
# ---------------------------------------------------------------------------

def _toy_data(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d,)).astype(np.float32) + 0.5).astype(np.float32)
    return {"x": x, "y": y}


def _ref_toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _toy_params(w0=0.0):
    w = np.full((8,), w0, np.float32)
    return ({"w": jnp.asarray(w), "b": jnp.zeros((), jnp.float32)},
            {"w": torch.from_numpy(w.copy()), "b": torch.zeros(())})


@pytest.mark.parametrize("name", ["adamw", "sgdm", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """20 steps of each optimizer (weight decay on) from the same start:
    the loss of every step and the parameters after it within 2e-6."""
    kw = dict(name=name, lr=0.05 if name != "sgdm" else 0.01,
              warmup_steps=5, decay_steps=400)
    ref_cfg, cfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    data = _toy_data()
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    jp, tp = _toy_params()
    js = ref_opt.init_state(ref_cfg, jp)
    ts = opt.init_state(cfg, tp)
    ref_step = ref_loop.make_train_step(_ref_toy_loss, ref_cfg, donate=False)
    step = train_loop.make_train_step(_toy_loss, cfg)
    for i in range(20):
        jp, js, jm = ref_step(jp, js, jb)
        tp, ts, tm = step(tp, ts, tb)
        for k in ("loss", "mse", "lr", "grad_norm"):
            _held(jm[k], tm[k], TOY_TOL, f"{name} step {i} {k}")
        for k in jp:
            _held(jp[k], tp[k], TOY_TOL, f"{name} step {i} {k}")
    assert int(ts["step"]) == int(js["step"]) == 20
    assert ts["step"].dtype == torch.int32
    if name == "adafactor":       # the factored state of the [8] vector
        _held(js["v"]["w"]["v"], ts["v"]["w"]["v"], TOY_TOL)


def test_adafactor_factors_match_reference():
    """Adafactor's row and column factors of rank-2 and rank-3 parameters
    after 3 steps, from the same seeded gradients."""
    rng = np.random.default_rng(3)
    kw = dict(name="adafactor", lr=0.01, warmup_steps=1, decay_steps=10)
    ref_cfg, cfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    shapes = {"m": (6, 5), "t": (2, 3, 4), "v": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = ref_opt.init_state(ref_cfg, jp), opt.init_state(cfg, tp)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * 0.1
             for k, s in shapes.items()}
        jp, js, _ = ref_opt.apply_updates(
            ref_cfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, _ = opt.apply_updates(
            cfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    for k in shapes:
        _held(jp[k], tp[k], TOY_TOL, k)
        for f in js["v"][k]:
            _held(js["v"][k][f], ts["v"][k][f], TOY_TOL, f"{k}.{f}")


def test_lr_schedule_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, decay_steps=110, min_lr_ratio=0.1)
    ref_cfg, ours = ref_opt.OptimizerConfig(**cfg), opt.OptimizerConfig(**cfg)
    for s in range(131):
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.int32(s)))
        got = opt.lr_schedule(ours, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, (s, float(got), want)
    assert float(opt.lr_schedule(ours, 0)) == 0.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(5, 3)), "b": rng.normal(size=(7,)),
            "c": rng.normal(size=())}
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    want, want_norm = ref_opt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    got, norm = opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    _held(want_norm, norm, TOY_TOL)
    for k in tree:
        assert got[k].dtype == torch.float32
        _held(want[k], got[k], TOY_TOL, k)
    # below the limit nothing is scaled
    if max_norm > float(norm):
        assert all(np.array_equal(got[k].numpy(), tree[k]) for k in tree)


def test_grad_accumulation_matches_big_batch_and_reference():
    """4 microbatches of 16 against one batch of 64 (the same step), and
    against the reference's accumulation, to 2e-6."""
    kw = dict(name="adamw", lr=1e-2, weight_decay=0.0)
    ref_cfg, cfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    data = _toy_data(n=64, seed=1)
    micro = {k: v.reshape((4, 16) + v.shape[1:]) for k, v in data.items()}
    jp, _ = _toy_params(1.0)
    results = []
    for accum, batch in ((1, data), (4, micro)):
        _, tp = _toy_params(1.0)
        step = train_loop.make_train_step(_toy_loss, cfg, accum_steps=accum)
        tp, _, tm = step(tp, opt.init_state(cfg, tp),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
        results.append((tp, tm))
    ref_acc = ref_loop.make_train_step(_ref_toy_loss, ref_cfg, accum_steps=4,
                                       donate=False)
    jp, _, jm = ref_acc(jp, ref_opt.init_state(ref_cfg, jp),
                        {k: jnp.asarray(v) for k, v in micro.items()})
    (big, big_m), (acc, acc_m) = results
    for k in jp:
        _held(big[k], acc[k], TOY_TOL, k)
        _held(jp[k], acc[k], TOY_TOL, k)
    _held(jm["loss"], acc_m["loss"], TOY_TOL)
    _held(big_m["loss"], acc_m["loss"], TOY_TOL)


# ---------------------------------------------------------------------------
# the LM: one loss_fn + AdamW step against the reference's
# ---------------------------------------------------------------------------

LM_ARCHS = ["llama3-8b", "qwen2.5-32b", "granite-moe-1b-a400m"]
LM_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm_step(request):
    """The reference's one jitted step (loss, metrics, grads, AdamW's new
    params) of the arch's smoke config on a (B 2, S 16) batch of
    `lm_batches` whose labels hold some -100s; llama3-8b's vocabulary is
    cut to 500, so 12 padding rows of its 512 are masked."""
    arch = request.param
    ref_cfg = ref_get_arch(arch).make_smoke_config()
    cfg = get_arch(arch).make_smoke_config()
    if arch == "llama3-8b":
        ref_cfg = dataclasses.replace(ref_cfg, vocab=500)
        cfg = dataclasses.replace(cfg, vocab=500)
    assert cfg.param_dtype == torch.float32 and cfg.remat
    params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = next(lm_data.lm_batches(cfg.vocab, batch=2, seq_len=16, seed=5))
    batch["labels"][0, 3:6] = -100
    batch["labels"][1, -1] = -100
    ocfg = ref_opt.OptimizerConfig(**LM_OPT)

    def step(p, b):
        (loss, m), g = jax.value_and_grad(
            lambda q: ref_tfm.loss_fn(ref_cfg, q, b), has_aux=True)(p)
        new_p, _, om = ref_opt.apply_updates(ocfg, p, g,
                                             ref_opt.init_state(ocfg, p))
        return loss, m, g, new_p, om

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.tree_util.tree_map(np.asarray, jax.jit(step)(params, jb))
    return {"arch": arch, "cfg": cfg, "params": jax.tree_util.tree_map(
        np.asarray, params), "batch": batch, "ref": out}


def _lm_model(lm_step, **changes):
    cfg = dataclasses.replace(lm_step["cfg"], **changes)
    return lm_params_from_reference(lm_step["params"], cfg, device="cpu",
                                    param_dtype=torch.float32)


def _port_lm_step(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = train_loop.value_and_grad(tfm.loss_fn, model, tb)
    ocfg = opt.OptimizerConfig(**LM_OPT)
    params = train_loop.param_dict(model)
    _, _, om = opt.apply_updates(ocfg, params, dict(grads),
                                 opt.init_state(ocfg, params))
    return loss, metrics, grads, om


def _ref_leaf(tree: dict, name: str):
    """The reference's array for the port's parameter `name`
    (`layers.{i}.{w}` is row i of the stacked `layers[w]`)."""
    if name.startswith("layers."):
        _, i, w = name.split(".")
        return tree["layers"][w][int(i)]
    return tree[name]


def test_lm_step_matches_reference(lm_step):
    model = _lm_model(lm_step)
    assert model.embed.dtype == torch.float32
    loss, metrics, grads, om = _port_lm_step(model, lm_step["batch"])
    r_loss, r_m, r_g, r_new, r_om = lm_step["ref"]
    _held(r_loss, loss, what="loss")
    _held(r_m["nll"], metrics["nll"], what="nll")
    _held(r_m["aux"], metrics["aux"], what="aux")
    if lm_step["cfg"].moe:
        assert float(metrics["aux"]) > 0
    _held(r_om["grad_norm"], om["grad_norm"], what="grad_norm")
    names = [n for n, _ in model.named_parameters()]
    assert set(grads) == set(names) and len(names) > 10
    # AdamW's first update is ~lr * sign(g): an element whose gradient is
    # near eps moves by an amount that rounding upstream can change, so
    # the new parameters are held to the absolute 2e-5, and every
    # parameter must have moved by more than ten times that
    moved = 0.0
    for name, p in model.named_parameters():
        _held(_ref_leaf(r_g, name), grads[name], what=f"grad {name}")
        _held(_ref_leaf(r_new, name), p, what=f"param {name}",
              of_scale=False)
        moved = max(moved, float(np.abs(_ref_leaf(lm_step["params"], name)
                                        - p.detach().numpy()).max()))
    assert moved > 10 * TOL


def test_lm_vocab_padding_and_ignored_labels(lm_step):
    """The padding rows of the head get no gradient, and a label of -100
    adds nothing: the nll is the mean over the other positions."""
    model = _lm_model(lm_step)
    batch = lm_step["batch"]
    _, metrics, grads, _ = _port_lm_step(model, batch)
    cfg = model.cfg
    if cfg.vocab_padded != cfg.vocab:
        assert float(grads["lm_head"][:, cfg.vocab:].abs().max()) == 0.0
        assert float(grads["lm_head"][:, :cfg.vocab].abs().max()) > 0.0
    model = _lm_model(lm_step)
    with torch.no_grad():
        logits = tfm.forward(model, torch.from_numpy(batch["tokens"]).long())
    logp = torch.log_softmax(logits[..., :cfg.vocab].double(), -1)
    labels = torch.from_numpy(batch["labels"]).long()
    keep = labels >= 0
    assert int((~keep).sum()) == 4
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    assert abs(float(nll[keep].mean()) - float(metrics["nll"])) < TOL


def test_lm_remat_off_equals_on(lm_step):
    """Per-layer recomputation changes no number of the step."""
    batch = lm_step["batch"]
    runs = []
    for remat in (True, False):
        model = _lm_model(lm_step, remat=remat)
        loss, _, grads, _ = _port_lm_step(model, batch)
        runs.append((loss, grads, dict(model.named_parameters())))
    (l1, g1, p1), (l2, g2, p2) = runs
    assert torch.equal(l1, l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
        assert torch.equal(p1[k], p2[k]), k


def test_chunked_attention_gradient_matches_reference():
    """The chunked online softmax (S 64, chunks of 16) differentiates, and
    its q, k, v gradients equal `jax.grad` of the reference's chunked path
    and the port's full path; without grad it gives the same output."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 64, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    ct = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)

    def ref_loss(q_, k_, v_):
        o = ref_layers.causal_attention(q_, k_, v_, chunk_q=16, chunk_kv=16)
        return jnp.sum(o * ct)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = {}
    for chunk in (16, 0):
        tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                      for a in (q, k, v))
        o = layers.causal_attention(tq, tk, tv, chunk_q=chunk, chunk_kv=16)
        (o * torch.from_numpy(ct)).sum().backward()
        grads[chunk] = (tq.grad, tk.grad, tv.grad)
        if chunk:
            with torch.no_grad():
                assert torch.equal(o, layers.causal_attention(
                    tq, tk, tv, chunk_q=16, chunk_kv=16))
    for w, g, f in zip(want, grads[16], grads[0]):
        _held(w, g, what="chunked vs jax.grad")
        _held(f, g, what="chunked vs full")


def test_lm_configs_train_as_the_reference():
    for arch in LM_ARCHS + ["granite-3-8b", "moonshot-v1-16b-a3b"]:
        for make in ("make_config", "make_smoke_config"):
            ref = getattr(ref_get_arch(arch), make)()
            cfg = getattr(get_arch(arch), make)()
            assert cfg.remat == ref.remat
            assert str(cfg.param_dtype).split(".")[-1] == \
                jnp.dtype(ref.param_dtype).name


# ---------------------------------------------------------------------------
# recsys: one loss_fn step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["fm", "autoint", "bst", "mind"])
def test_recsys_loss_and_grads_match_reference(arch):
    ref_cfg = ref_get_arch(arch).make_smoke_config()
    cfg = get_arch(arch).make_smoke_config()
    params = jax.tree_util.tree_map(
        np.asarray, ref_rec.init_params(ref_cfg, jax.random.PRNGKey(1)))
    log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                   seq_len=cfg.seq_len, seed=2)
    batch = log.seq_batch(32) if arch in ("bst", "mind") else log.ctr_batch(32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (r_loss, r_m), r_g = jax.jit(jax.value_and_grad(
        lambda p: ref_rec.loss_fn(ref_cfg, p, jb), has_aux=True))(params)
    model = recsys_params_from_reference(params, cfg, device="cpu")
    loss, metrics, grads = train_loop.value_and_grad(
        rec.loss_fn, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _held(r_loss, loss, what="loss")
    assert set(metrics) == set(r_m)
    for k in r_m:
        _held(r_m[k], metrics[k], what=k)
    flat = {}
    for key, value in r_g.items():
        if isinstance(value, list):
            for i, item in enumerate(value):
                flat.update({f"{key}.{i}.{n}": a for n, a in item.items()})
        else:
            flat[key] = value
    assert set(flat) == set(grads)
    for name, g in grads.items():
        _held(flat[name], g, what=f"grad {name}")
    # MIND reads only its item table (its field table gets zeros, as in
    # the reference)
    emb = "item_table" if arch == "mind" else "table"
    assert float(grads[emb].abs().max()) > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_segment_bag_fn_backward_matches_autograd_of_plain(weighted, combine):
    """`SegmentBagFn` with the plain forward in place of the kernel: its
    output and its table and weight gradients equal autograd's through
    `segment_bag_plain` (pads skipped, an id past the table on its last
    row, an all-pad bag)."""
    rng = np.random.default_rng(7 + weighted)
    B, F, V, D = 9, 5, 40, 6
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.2] = -1
    ids[0] = -1
    ids[-1, 0] = V + 3
    ids[2, :2] = 7                            # a row twice in one bag
    w = rng.normal(size=(B, F)).astype(np.float32) if weighted else None
    ct = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    it = torch.from_numpy(ids)
    runs = []
    for use_fn in (True, False):
        t = torch.from_numpy(table.copy()).requires_grad_()
        wt = None if w is None else torch.from_numpy(w.copy()).requires_grad_()
        if use_fn:
            sums = ops.SegmentBagFn.apply(t, wt, it, ops._bag_sums_plain)
            out = ops._bag_combine(sums, it, combine, t.dtype)
        else:
            out = ops.segment_bag_plain(t, it, wt, combine)
        (out * ct).sum().backward()
        runs.append((out.detach(), t.grad, None if wt is None else wt.grad))
    (o1, gt1, gw1), (o2, gt2, gw2) = runs
    assert torch.equal(o1, o2)
    _held(gt2, gt1, what="d table")
    assert float(gt1[V - 1].abs().max()) > 0           # the clamped id
    if weighted:
        _held(gw2, gw1, what="d weights")
        assert float(gw1[0].abs().max()) == 0.0        # the all-pad bag


def test_lm_batches_equal_reference():
    ours = lm_data.lm_batches(300, batch=3, seq_len=20, seed=4)
    ref = ref_lm_data.lm_batches(300, batch=3, seq_len=20, seed=4)
    for _ in range(3):
        got, want = next(ours), next(ref)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the port's loop, launcher and example on the CPU
# ---------------------------------------------------------------------------

def test_fit_trains_tiny_lm(tmp_path):
    """tests/test_train.py::test_fit_trains_tiny_lm on the port; then a
    second `fit` resumes from the step-60 checkpoint and does nothing."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = get_arch("llama3-8b").make_smoke_config()
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = lm_data.lm_batches(cfg.vocab, batch=8, seq_len=32, seed=0)
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    ocfg = opt.OptimizerConfig(lr=3e-3, warmup_steps=10, decay_steps=100)
    logs = []
    model, state, hist = train_loop.fit(model, tfm.loss_fn, ocfg, data,
                                        n_steps=60, ckpt=ckpt, log_every=10,
                                        log_fn=logs.append)
    assert [h["step"] for h in hist] == [10, 20, 30, 40, 50, 60]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.9
    assert ckpt.latest_step() == 60 and int(state["step"]) == 60
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000050",
                                                   "step_00000060"]
    fresh = tfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    fresh, _, hist2 = train_loop.fit(fresh, tfm.loss_fn, ocfg, data,
                                     n_steps=60, ckpt=ckpt,
                                     log_fn=logs.append)
    assert hist2 == [] and logs[-1] == "[fit] resumed from step 60"
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", ["llama3-8b", "fm"])
def test_train_launcher_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch.train import main
    hist = main(["--arch", arch, "--steps", "4", "--device", "cpu",
                 "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"[train] arch={arch}" in out and "device=cpu" in out
    assert "[train] loss" in out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]


def test_train_launcher_refuses_what_it_cannot_train(monkeypatch):
    from repro_torch.launch.train import main
    # the gnn family trains (its branch: tests/test_torch_gnn.py)
    hist = main(["--arch", "gin-tu", "--steps", "2", "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    with pytest.raises(SystemExit, match="served, not trained"):
        main(["--arch", "veretennikov", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "fm", "--steps", "1"])


def test_train_lm_example_on_cpu(capsys, tmp_path):
    main = runpy.run_path(os.path.join(_EXAMPLES, "torch_train_lm.py"),
                          run_name="example")["main"]
    hist = main(["--tiny", "--steps", "3", "--device", "cpu",
                 "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "model: lm-tiny" in out and "device=cpu" in out
    assert "over 3 steps" in out and np.isfinite(hist[-1]["loss"])
    assert os.listdir(tmp_path) == ["step_00000003"]
