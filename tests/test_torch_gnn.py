"""The port's GIN and graph data against the reference package, on the CPU.

The counterparts of tests/test_graph_partition.py, tests/test_models.py's
GIN smoke and tests/test_dist.py's halo-exchange test.  `graph_data`'s
functions equal the reference's array for array, bit for bit, on seeds;
with the reference's `init_params` weights carried into the port
(`carry.gnn_params_from_reference`), `forward` and `loss_fn` of the
gin-tu smoke config on each of the four `GNN_SHAPES` at smoke size (the
full graphs, a minibatch sampled at minibatch_lg's fanout, molecules with
the sum readout), in float32 and with bf16 messages, and one
`make_train_step` step on each; the halo-exchange loss on one rank
without a process group, then one spawn of four gloo ranks
(tests/torch_gloo.py): its loss, accuracy and rank-summed parameter
gradient against the reference's dense `loss_fn` and `jax.grad` of it;
`launch/train.py --arch gin-tu` on the CPU.  Tolerances: the model zoo's
float32 2e-5 and bf16 5e-2 (tests/test_kernels.py), of each tensor's
largest magnitude; the halo's 1e-4 (the loss absolute, gradients of their
magnitude) and exact accuracy (tests/test_dist.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data import graph_data as ref_gd  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_loop as ref_loop  # noqa: E402
from repro_torch.carry import gnn_params_from_reference  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import graph_data  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from torch_gloo import run_ranks  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 5e-2}
HALO_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _held(want, got, tol, what="", of_scale=True):
    """got within `tol` of want's largest |value| (the GIN's sums reach
    logits of ~400 at smoke size, where one float32 ulp is 3e-5: an
    absolute 2e-5 would ask for less than an ulp; at scales below 1 this
    is tighter than the absolute limit), or with `of_scale` off within
    `tol` absolutely (updated parameters: AdamW's first update is ~lr *
    g / (|g| + eps), so a tiny gradient's last bits set an O(lr) move)."""
    want = np.asarray(want, np.float32)
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = float(np.abs(want - got).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    limit = tol * max(scale, 1e-30) if of_scale else tol
    assert err <= limit, (what, err, scale)


# ---------------------------------------------------------------------------
# graph data, bit for bit
# ---------------------------------------------------------------------------

def _same(want, got, what):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            _same(want[k], got[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and want.shape == got.shape, what
        assert want.tobytes() == got.tobytes(), what
    else:
        assert type(want) is type(got) and want == got, (what, want, got)


def test_generate_graph_and_full_batch_equal_reference():
    want = ref_gd.generate_graph(300, 2400, 8, 4, homophily=0.7, seed=3)
    got = graph_data.generate_graph(300, 2400, 8, 4, homophily=0.7, seed=3)
    assert isinstance(got, graph_data.GraphData)
    for f in dataclasses.fields(ref_gd.GraphData):
        _same(getattr(want, f.name), getattr(got, f.name), f.name)
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    _same(ref_gd.full_graph_batch(want, train_frac=0.5, seed=2),
          graph_data.full_graph_batch(got, train_frac=0.5, seed=2), "full")


def test_sample_subgraph_equals_reference():
    g = graph_data.generate_graph(400, 6000, 6, 5, seed=2)
    seeds = np.random.default_rng(0).integers(0, g.n_nodes, 24)
    want = ref_gd.sample_subgraph(g, seeds, (15, 10), np.random.default_rng(1))
    got = graph_data.sample_subgraph(g, seeds, (15, 10),
                                     np.random.default_rng(1))
    _same(want, got, "subgraph")
    assert got["nodes"].shape == (24 * (1 + 15 + 150), 6)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_partition_for_halo_equals_reference(n_shards):
    g = graph_data.generate_graph(300, 2400, d_feat=8, n_classes=4, seed=3)
    _same(ref_gd.partition_for_halo(g, n_shards),
          graph_data.partition_for_halo(g, n_shards), "partition")
    _same(ref_gd.partition_for_halo(g, n_shards, order_by_label=False),
          graph_data.partition_for_halo(g, n_shards, order_by_label=False),
          "partition (unordered)")


def test_molecule_batch_equals_reference():
    _same(ref_gd.molecule_batch(8, 10, 20, 16, 2, seed=5),
          graph_data.molecule_batch(8, 10, 20, 16, 2, seed=5), "molecule")


# ---------------------------------------------------------------------------
# the model on the four shapes at smoke size
# ---------------------------------------------------------------------------

def _shape_batch(shape: str) -> dict:
    """A numpy batch of `shape`'s kind at smoke size (its d_feat and
    classes cut; minibatch_lg keeps its fanout)."""
    if shape == "molecule":
        return ref_gd.molecule_batch(16, 30, 64, 16, 2, seed=0)
    if shape == "minibatch_lg":
        g = ref_gd.generate_graph(400, 6000, 12, 41, seed=2)
        seeds = np.random.default_rng(0).integers(0, g.n_nodes, 8)
        return ref_gd.sample_subgraph(g, seeds, (15, 10),
                                      np.random.default_rng(0))
    n, e, f, c = {"full_graph_sm": (200, 1200, 24, 7),
                  "ogb_products": (300, 2400, 10, 47)}[shape]
    return ref_gd.full_graph_batch(ref_gd.generate_graph(n, e, f, c, seed=1))


def _configs(shape: str, batch: dict, message: str = "f32"):
    ref = ref_get_arch("gin-tu").make_smoke_config()
    cfg = get_arch("gin-tu").make_smoke_config()
    classes = 2 if shape == "molecule" else int(batch["labels"].max()) + 1
    kw = dict(d_feat=batch["nodes"].shape[1], n_classes=max(classes, 3),
              graph_readout=shape == "molecule")
    ref = dataclasses.replace(ref, **kw, message_dtype=(
        jnp.bfloat16 if message == "bf16" else None))
    cfg = dataclasses.replace(cfg, **kw, message_dtype=(
        torch.bfloat16 if message == "bf16" else None))
    return ref, cfg


def _both(batch: dict):
    jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    tb = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    return jb, tb


SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


@pytest.mark.parametrize("message", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_loss_match_reference(shape, message):
    batch = _shape_batch(shape)
    ref_cfg, cfg = _configs(shape, batch, message)
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = gnn_params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                             params), cfg, "cpu")
    jb, tb = _both(batch)
    want = ref_gnn.forward(ref_cfg, params, jb)
    got = gnn.forward(model, tb)
    assert got.dtype == torch.float32
    _held(want, got, TOL[message], f"{shape} logits")
    wl, wm = ref_gnn.loss_fn(ref_cfg, params, jb)
    gl, gm = gnn.loss_fn(model, tb)
    _held(wl, gl, TOL[message], f"{shape} loss")
    if message == "f32":
        assert float(gm["acc"]) == float(wm["acc"]), shape


@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_matches_reference(shape):
    """One loss_fn + AdamW step from the same weights: loss, accuracy and
    grad norm of their magnitude, and every new parameter absolutely (as
    tests/test_torch_train.py holds them)."""
    batch = _shape_batch(shape)
    ref_cfg, cfg = _configs(shape, batch)
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = gnn_params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                             params), cfg, "cpu")
    jb, tb = _both(batch)
    n_graphs = jb.pop("n_graphs", None)
    tb.pop("n_graphs", None)
    extra = {} if n_graphs is None else {"n_graphs": n_graphs}
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    ref_step = ref_loop.make_train_step(
        lambda p, b: ref_gnn.loss_fn(ref_cfg, p, dict(b, **extra)),
        ref_opt.OptimizerConfig(**kw), donate=False)
    new, _, wm = ref_step(params, ref_opt.init_state(
        ref_opt.OptimizerConfig(**kw), params), jb)
    ocfg = opt.OptimizerConfig(**kw)
    step = train_loop.make_train_step(
        lambda m, b: gnn.loss_fn(m, dict(b, **extra)), ocfg)
    model, _, gm = step(model, opt.init_state(ocfg, train_loop.param_dict(model)),
                        tb)
    for k in ("loss", "acc", "grad_norm"):
        _held(wm[k], gm[k], TOL["f32"], f"{shape} {k}")
    got = dict(model.named_parameters())
    for i, layer in enumerate(new["layers"]):
        for k, v in layer.items():
            _held(v, got[f"layers.{i}.{k}"], TOL["f32"],
                  f"{shape} layers.{i}.{k}", of_scale=False)
    for k in ("head_w", "head_b"):
        _held(new[k], got[k], TOL["f32"], f"{shape} {k}", of_scale=False)
    moved = float(np.abs(np.asarray(params["head_w"])
                         - got["head_w"].detach().numpy()).max())
    assert moved > 10 * TOL["f32"], moved


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------

def _halo_world():
    """tests/test_dist.py's halo graph and config, the reference's weights
    and dense loss, and its gradient by `jax.grad`."""
    g = ref_gd.generate_graph(400, 3200, d_feat=12, n_classes=4, seed=1)
    cfg = ref_gnn.GINConfig(name="t", n_layers=3, d_hidden=16, d_feat=12,
                            n_classes=4)
    params = ref_gnn.init_params(cfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in
         ref_gd.full_graph_batch(g, train_frac=1.0, seed=0).items()}
    (loss, m), grads = jax.value_and_grad(
        lambda p: ref_gnn.loss_fn(cfg, p, b), has_aux=True)(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    port_cfg = gnn.GINConfig(name="t", n_layers=3, d_hidden=16, d_feat=12,
                             n_classes=4)
    return g, np_params, port_cfg, float(loss), float(m["acc"]), grads


def test_halo_loss_on_one_rank_equals_dense():
    """One shard, no process group: the all_gather and psums are over one
    rank, and the halo loss is the dense loss."""
    g, params, cfg, loss, acc, _ = _halo_world()
    part = graph_data.partition_for_halo(g, 1)
    model = gnn_params_from_reference(params, cfg, "cpu")
    shard = {k: torch.from_numpy(part[k]) for k in (
        "nodes", "src", "dst", "edge_mask", "labels", "label_mask",
        "send_idx")}
    got, m = gnn.halo_loss_fn(model, shard)
    assert abs(float(got) - loss) < HALO_TOL
    assert float(m["acc"]) == acc


_HALO_RANKS = """
from repro_torch.carry import gnn_params_from_reference
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import gnn
from repro_torch.train import train_loop

mesh = make_host_mesh(device="cpu")
part = inputs["part"]
shard = {k: sharding.dp_placement(mesh, part[k].shape).block(
             torch.from_numpy(part[k])) for k in inputs["keys"]}
model = gnn_params_from_reference(inputs["params"], inputs["cfg"], "cpu")
loss, metrics, grads = train_loop.value_and_grad(
    lambda m, b: gnn.halo_loss_fn(m, b, mesh.dp_group), model, shard)
dump({"loss": float(loss), "acc": float(metrics["acc"]),
      "shard_nodes": tuple(shard["nodes"].shape),
      "grads": {k: g.numpy() for k, g in grads.items()}})
"""


def test_halo_exchange_on_four_gloo_ranks(tmp_path):
    """tests/test_dist.py::test_gin_halo_exchange_matches_dense on four
    gloo ranks, one shard each: every rank's loss within 1e-4 of the dense
    loss and its accuracy equal; the ranks' parameter gradients, summed,
    within 1e-4 of `jax.grad` of the dense loss (each rank's backward
    sends the boundary rows' gradients back to their owners)."""
    g, params, cfg, loss, acc, grads = _halo_world()
    part = graph_data.partition_for_halo(g, 4)
    keys = ("nodes", "src", "dst", "edge_mask", "labels", "label_mask",
            "send_idx")
    got = run_ranks(_HALO_RANKS, {"part": {k: part[k] for k in keys},
                                  "keys": keys, "params": params, "cfg": cfg},
                    tmp_path, world=4)
    for r in got:
        assert r["shard_nodes"] == (1, part["n_local"], 12)
        assert abs(r["loss"] - loss) < HALO_TOL, (r["loss"], loss)
        assert r["acc"] == acc
    summed = {k: sum(r["grads"][k] for r in got) for k in got[0]["grads"]}
    for i, layer in enumerate(grads["layers"]):
        for k, v in layer.items():
            _held(v, summed[f"layers.{i}.{k}"], HALO_TOL, f"layers.{i}.{k}")
    for k in ("head_w", "head_b"):
        _held(grads[k], summed[k], HALO_TOL, k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_launcher_gin_molecule_on_cpu(capsys, monkeypatch):
    """tests/test_launchers.py's gin-tu molecule run, on the CPU; without
    `--device` it asks for the card, and raises without CUDA."""
    from repro_torch.launch.train import main
    hist = main(["--arch", "gin-tu", "--shape", "molecule", "--steps", "10",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] arch=gin-tu family=gnn" in out and "device=cpu" in out
    assert "[train] loss" in out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "gin-tu", "--shape", "molecule", "--steps", "1"])
