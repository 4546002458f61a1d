"""The port's dry-run against the reference package, on the CPU.

Placement parity: the reference's rules (src/repro/dist/sharding.py) run
on a stand-in mesh (a namespace with `shape` and `axis_names`; the rules
need no devices) over `jax.eval_shape` of the reference's parameters;
the port's rules (dist/sharding.py) over its meta-device modules.  Every
arch of the registry at full size, on the meshes 16 x 16, 2 x 16 x 16,
32 x 8 and 2 x 32 x 8: the split of every leaf, both LM layouts, with the
layer axis of the reference's stacked leaves never split; each cell's
per-device parameter and AdamW-state bytes; each cell's model flops
against `benchmarks/roofline.model_flops_for` of the reference's meta.
No JAX compile, and no process group in this process: one subprocess
runs `python -m repro_torch.launch.dryrun` on four cells (its fake
process group lives there) and the records are held against the same
steps traced here at global shapes (one rank).  The multi-rank programs
run as four gloo ranks on a 2 x 2 mesh in tests/torch_gloo.py's one
spawn: each step's loss and gradients against the reference's
single-device `jax.value_and_grad`.
"""
import collections
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import roofline as ref_rl  # noqa: E402
from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.dist import sharding as ref_shr  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro.models import recsys as ref_rec  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.dist import sharding as shr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import MeshShape, mesh_shape  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from torch_gloo import run_ranks  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "32x8": (("data", "model"), (32, 8)),
          "2x32x8": (("pod", "data", "model"), (2, 32, 8))}
LM_ARCHS = [a for a in ALL_ARCHS if get_arch(a).family == "lm"]
REC_ARCHS = [a for a in ALL_ARCHS if get_arch(a).family == "recsys"]


def _stand_in(name):
    axes, dims = MESHES[name]
    return types.SimpleNamespace(
        shape=collections.OrderedDict(zip(axes, dims)), axis_names=axes)


def _port_mesh(name):
    return MeshShape(*MESHES[name])


def _flat(tree) -> dict:
    """{dotted name: leaf} of a reference tree (dict keys, list indices)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(getattr(e, "key", getattr(e, "idx", e))) for e in path]
        out[".".join(keys)] = leaf
    return out


def _ref_lm_struct(cfg):
    return jax.eval_shape(functools.partial(ref_tfm.init_params, cfg),
                          jax.random.PRNGKey(0))


def _lm_pairs(ref_specs: dict, port: dict, n_layers: int):
    """(name, reference spec with the layer axis dropped, port spec) for
    every leaf; asserts the layer axis is never split."""
    for name, spec in ref_specs.items():
        spec = tuple(spec)
        if name.startswith("layers."):
            leaf = name.split(".", 1)[1]
            assert spec[0] is None, (name, spec)
            for i in range(n_layers):
                yield name, spec[1:], port[f"layers.{i}.{leaf}"]
        else:
            yield name, spec, port[name]


@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_transformer_placements_match_reference(arch, layout):
    ref_cfg = ref_get_arch(arch).make_config()
    cfg = get_arch(arch).make_config()
    struct = _ref_lm_struct(ref_cfg)
    shapes = shr.leaf_shapes(__import__(
        "repro_torch.models.transformer", fromlist=["x"]).Transformer(
            cfg, device="meta"))
    for mesh in MESHES:
        ref = _flat(ref_shr.transformer_param_specs(ref_cfg, _stand_in(mesh),
                                                    layout))
        port = shr.transformer_param_specs(cfg, _port_mesh(mesh), layout,
                                           shapes=shapes)
        assert len(port) == sum(cfg.n_layers if k.startswith("layers.")
                                else 1 for k in ref)
        n_split = 0
        for name, want, got in _lm_pairs(ref, port, cfg.n_layers):
            assert got == want, (mesh, name, got, want)
            n_split += any(e is not None for e in got)
        assert n_split > 0
        # the stacked shapes agree with the port's per-layer ones
        for name, leaf in _flat(struct).items():
            if name.startswith("layers."):
                assert leaf.shape[1:] == shapes[
                    "layers.0." + name.split(".", 1)[1]]
    bs = shr.transformer_batch_specs(_port_mesh("2x32x8"))
    assert bs == {k: tuple(v) for k, v in ref_shr.transformer_batch_specs(
        _stand_in("2x32x8")).items()}
    for B in (1, 128):
        got = shr.transformer_cache_specs(cfg, _port_mesh("32x8"), B)
        want = ref_shr.transformer_cache_specs(ref_cfg, _stand_in("32x8"), B)
        assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recsys_and_gin_placements_match_reference(arch):
    ref_cfg = ref_get_arch(arch).make_config()
    cfg = get_arch(arch).make_config()
    for mesh in MESHES:
        ref = {k: tuple(v) for k, v in _flat(ref_shr.recsys_param_specs(
            ref_cfg, _stand_in(mesh))).items()}
        assert shr.recsys_param_specs(cfg, _port_mesh(mesh)) == ref
        for retrieval in (False, True):
            want = ref_shr.recsys_batch_specs(ref_cfg, _stand_in(mesh),
                                              retrieval)
            assert shr.recsys_batch_specs(cfg, _port_mesh(mesh),
                                          retrieval) == {
                k: tuple(v) for k, v in want.items()}
        want = ref_shr.gin_batch_specs(_stand_in(mesh))
        assert shr.gin_batch_specs(_port_mesh(mesh)) == {
            k: tuple(v) for k, v in want.items()}
        assert shr.gnn_dp_axis(_port_mesh(mesh)) == ref_shr.gnn_dp_axis(
            _stand_in(mesh))


# ---------------------------------------------------------------------------
# per-device bytes and model flops of every cell
# ---------------------------------------------------------------------------

def _spec_bytes(leaf, spec, mesh) -> int:
    n = 1
    for e in tuple(spec):
        n *= ref_shr._axes_size(mesh, e) if e is not None else 1
    return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n


def _ref_bytes(arch, shape_name, mesh_name, layout):
    """(parameter bytes, AdamW state bytes or 0, the reference cell's meta)
    per device from the reference's rules and `jax.eval_shape`."""
    spec = ref_get_arch(arch)
    shape = spec.shapes[shape_name]
    mesh = _stand_in(mesh_name)
    cfg = spec.make_config()
    dp_n = ref_shr._axes_size(mesh, ref_shr.dp_axis(mesh))
    train = shape["kind"] in ("train", "train_full", "train_minibatch",
                              "train_graphs")
    if spec.family == "lm":
        struct = _ref_lm_struct(cfg)
        lay = layout if shape["kind"] == "train" else "2d"
        specs = ref_shr.transformer_param_specs(cfg, mesh, lay)
        meta = {"params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "seq_len": shape["seq_len"],
                "global_batch": shape["global_batch"],
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "n_heads": cfg.n_heads, "hd": cfg.hd}
    elif spec.family == "recsys":
        struct = jax.eval_shape(functools.partial(ref_rec.init_params, cfg),
                                jax.random.PRNGKey(0))
        specs = ref_shr.recsys_param_specs(cfg, mesh)
        meta = {"params": cfg.param_count(), "batch": shape["batch"],
                "model": cfg.model, "embed_dim": cfg.embed_dim,
                "n_fields": cfg.n_fields}
        if shape["kind"] == "retrieval":
            meta["n_candidates"] = shape["n_candidates"]
    elif spec.family == "gnn":
        import dataclasses
        cfg = dataclasses.replace(cfg, d_feat=shape["d_feat"],
                                  n_classes=shape["n_classes"],
                                  graph_readout=shape["kind"] == "train_graphs")
        struct = jax.eval_shape(functools.partial(ref_gnn.init_params, cfg),
                                jax.random.PRNGKey(0))
        specs = jax.tree_util.tree_map(
            lambda l: jax.sharding.PartitionSpec(*([None] * l.ndim)), struct)
        n_all = int(np.prod(list(mesh.shape.values())))
        if shape["kind"] == "train_minibatch":
            seeds, f_prod, N = shape["batch_nodes"], 1, shape["batch_nodes"]
            for f in shape["fanout"]:
                f_prod *= f
                N += seeds * f_prod
            E = N - seeds
        elif shape["kind"] == "train_graphs":
            N = shape["batch"] * shape["n_nodes"]
            E = shape["batch"] * shape["n_edges"]
        else:
            N, E = shape["n_nodes"], shape["n_edges"]
        meta = {"params": cfg.param_count(),
                "n_nodes": -(-N // n_all) * n_all, "n_edges": E,
                "d_feat": shape["d_feat"], "d_hidden": cfg.d_hidden,
                "n_layers": cfg.n_layers}
    else:
        import dataclasses
        c = dataclasses.replace(
            cfg, queries=shape["queries"], postings_pad=shape["postings_pad"],
            ranked=shape.get("ranked", cfg.ranked))
        return 0, 0, {"queries": c.queries, "groups": c.groups,
                      "postings_pad": c.postings_pad,
                      "arena_per_shard": c.n_arena, "n_shards": dp_n,
                      "ranked": c.ranked}
    leaves = jax.tree_util.tree_leaves(struct)
    sps = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    pbytes = sum(_spec_bytes(l, s, mesh) for l, s in zip(leaves, sps))
    obytes = 0
    if train:
        from repro.train import optimizer as ref_opt
        ost = jax.eval_shape(functools.partial(
            ref_opt.init_state, ref_opt.OptimizerConfig(name="adamw")),
            struct)
        obytes = 4 + sum(_spec_bytes(l, s, mesh)
                         for m in ("mu", "nu")
                         for l, s in zip(jax.tree_util.tree_leaves(ost[m]),
                                         sps))
    return pbytes, obytes, meta


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_bytes_and_model_flops_match_reference(arch):
    spec = get_arch(arch)
    for shape_name, shape in spec.shapes.items():
        layouts = ("2d", "fsdp") if shape["kind"] == "train" and \
            spec.family == "lm" else ("2d",)
        for mesh in MESHES:
            for layout in layouts:
                port_mesh = _port_mesh(mesh)
                if layout == "fsdp" and shape["global_batch"] % \
                        port_mesh.size:
                    with pytest.raises(ValueError, match="does not split"):
                        build_cell(arch, shape_name, port_mesh, layout=layout)
                    continue
                cell = build_cell(arch, shape_name, port_mesh, layout=layout)
                pb, ob, meta = _ref_bytes(arch, shape_name, mesh, layout)
                what = (arch, shape_name, mesh, layout)
                assert cell.param_bytes() == pb, what
                assert cell.opt_state_bytes() == ob, what
                got = rl.model_flops_for(dict(cell.meta, ns_k=20),
                                         spec.family, cell.kind)
                want = ref_rl.model_flops_for(dict(meta, ns_k=20),
                                              spec.family, cell.kind)
                assert got == want and got > 0, what


def test_roofline_terms_take_each_link():
    t = rl.roofline_terms({"bfloat16": 989e12}, 3.35e12, {"model": 450e9,
                                            ("pod", "data"): 50e9}, 512)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    assert t["t_collective_by_link_s"] == {
        "model": pytest.approx(1.0), "pod+data": pytest.approx(1.0)}
    assert t["t_collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective"
    assert t["hlo_flops_global"] == pytest.approx(989e12 * 512)
    # each operand type at its own peak
    t = rl.roofline_terms({"bfloat16": 989e12, "tf32": 495e12,
                           "float32": 67e12}, 0.0, {}, 1)
    assert t["t_compute_s"] == pytest.approx(3.0)
    assert t["hlo_flops_global"] == pytest.approx(989e12 + 495e12 + 67e12)
    assert mesh_shape(True).size == 512 and mesh_shape(False).size == 256


def test_flops_are_counted_by_operand_type():
    """A bf16 product counts at the bf16 rate, a float32 product of bf16
    values under `exact_f32_products` (TF32 allowed) at the TF32 rate, any
    other float32 product at the float32 rate."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import layers as L
    counter = dryrun.PassCounter({})
    with FakeTensorMode(), counter:
        a = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
        b = torch.empty(16, 4, dtype=torch.bfloat16, device="meta")
        a @ b
        with L.exact_f32_products(a):
            a.float() @ b.float()
        a.float() @ b.float()
    n = 2 * 8 * 16 * 4
    assert counter.flops == {"bfloat16": n, "tf32": n, "float32": n}
    t = rl.roofline_terms(counter.flops, 0.0, {}, 1)
    assert t["t_compute_s"] == pytest.approx(n / 989e12 + n / 495e12
                                             + n / 67e12)


# ---------------------------------------------------------------------------
# the expert-split MoE layer's per-rank shares
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dropless", [False, True])
def test_moe_expert_shares_sum_to_the_layer(dropless):
    """Two ranks' shares of an expert-split MoE layer sum to the whole
    layer, in both of `moe_ffn`'s forms: experts [lo, hi) whole, and every
    expert's d_expert columns of the rank with the activations exchanged
    (the exchange played here by concatenating the ranks' columns)."""
    from repro_torch.models.moe import MoEConfig, moe_ffn
    cfg = MoEConfig(n_experts=4, top_k=2, d_expert=8)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 16, generator=g)
    router = torch.randn(16, 4, generator=g)
    wg, wu = torch.randn(2, 4, 16, 8, generator=g)
    wd = torch.randn(4, 8, 16, generator=g)
    want, _ = moe_ffn(x, router, wg, wu, wd, cfg, torch.float32, dropless)
    ranks = [(0, 2, slice(0, 4)), (2, 4, slice(4, 8))]
    whole = sum(moe_ffn(x, router, wg[lo:hi], wu[lo:hi], wd[lo:hi], cfg,
                        torch.float32, dropless, experts=(lo, hi))[0]
                for lo, hi, _ in ranks)
    acts = []

    def share(lo, hi, cols, exchange):
        return moe_ffn(x, router, wg[..., cols], wu[..., cols], wd[lo:hi],
                       cfg, torch.float32, dropless, experts=(lo, hi),
                       exchange=exchange)[0]

    for lo, hi, cols in ranks:              # each rank's columns, recorded
        share(lo, hi, cols, lambda a, lo=lo, hi=hi: (
            acts.append(a), a.new_zeros(hi - lo, a.shape[1], 8))[1])
    exchanged = sum(share(lo, hi, cols, lambda a, lo=lo, hi=hi: torch.cat(
        [b[lo:hi] for b in acts], dim=2)) for lo, hi, cols in ranks)
    assert torch.allclose(whole, want, atol=1e-5)
    assert torch.allclose(exchanged, want, atol=1e-5)


def test_moe_exchanges_activations_at_decode_and_gathers_at_prefill():
    """moonshot on 32 x 8: a decode step's 4 tokens a dp group exchange
    their activations; a 32768-token dropless prefill gathers wg / wu
    (its dispatch buffer of every expert would outgrow them)."""
    from repro_torch.launch import steps
    cfg = get_arch("moonshot-v1-16b-a3b").make_config()
    mesh = mesh_shape(False)
    tp = steps._TP(cfg, steps.geometry(mesh),
                   shr.transformer_param_specs(cfg, mesh, "2d"))
    wg = torch.empty(cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert // 8,
                     dtype=cfg.param_dtype, device="meta")

    def x(T):
        return torch.empty(1, T, cfg.d_model, dtype=cfg.dtype, device="meta")
    assert tp.expert_split
    assert tp.exchanges(x(4), False, wg)
    assert not tp.exchanges(x(32768), False, wg)


# ---------------------------------------------------------------------------
# the kernels as operators with fake implementations
# ---------------------------------------------------------------------------

def test_kernel_ops_have_fake_implementations():
    """Each kernel the dry-run's cells reach is one `repro_torch` operator;
    under `FakeTensorMode` on the meta device it gives its outputs'
    shapes and dtypes and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    wrappers = [ops.unpack_postings_cuda, ops.banded_intersect_rows_cuda,
                ops.banded_min_delta_rows_cuda,
                ops.banded_delta_mask_rows_cuda, ops.flash_decode_cuda,
                ops.segment_bag_cuda]
    before = [w.launches for w in wrappers]
    counter = dryrun.PassCounter({})
    with FakeTensorMode(), counter:
        dev = "meta"
        i32 = dict(dtype=torch.int32, device=dev)
        a = torch.empty(6, 128, **i32)
        bands = torch.zeros(6, **i32)
        arena = {"lanes": torch.empty(1000, **i32),
                 "blk_meta": torch.empty(8, 5, **i32)}
        outs = ops.unpack_postings(arena, a)
        assert [(o.shape, o.dtype) for o in outs] == [
            ((6, 128), torch.int32)] * 3
        hit = ops.banded_intersect_rows(a, torch.empty(6, 512, **i32), bands)
        assert hit.shape == (6, 128) and hit.dtype == torch.bool
        md = ops.banded_min_delta_rows(a, a, a, bands)
        assert md.shape == (6, 128) and md.dtype == torch.int32
        m, t = ops.banded_delta_mask_rows(a, a, bands, bands)
        assert m.shape == t.shape == (6, 128)
        q = torch.empty(4, 4, 128, dtype=torch.bfloat16, device=dev)
        kv = torch.empty(4, 32768, 1, 128, dtype=torch.bfloat16, device=dev)
        o = ops.flash_decode(q, kv, kv, torch.full((4,), 7, **i32))
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        table = torch.empty(5000, 10, device=dev, requires_grad=True)
        s = ops.segment_bag(table, torch.zeros(8, 3, dtype=torch.int64,
                                               device=dev))
        assert s.shape == (8, 10) and s.dtype == torch.float32
        s.sum().backward()
        assert table.grad.shape == table.shape
    assert counter.kernels == {
        "unpack_postings": 1, "banded_intersect_rows": 1,
        "banded_min_delta_rows": 1, "banded_delta_mask_rows": 1,
        "flash_decode": 1, "segment_bag_sums": 1}
    assert [w.launches for w in wrappers] == before
    assert set(counter.kernels) == set(ops.KERNEL_OPS)


# ---------------------------------------------------------------------------
# the CLI on four cells, against the same steps at global shapes
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("gin-tu/molecule", "fm/serve_p99", "veretennikov/serve_p99",
                "llama3-8b/decode_32k")
RECORD_KEYS = {"arch", "shape", "kind", "layout", "mesh", "chips", "device",
               "t_trace_s", "memory", "cost", "collectives", "kernels",
               "roofline", "model_flops", "useful_ratio", "meta"}


def test_dryrun_cli_cells(tmp_path):
    out = tmp_path / "records"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(DRYRUN_CELLS), "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=400, cwd=_ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "done; 0 failures" in proc.stdout
    one = MeshShape(("data", "model"), (1, 1))
    for c in DRYRUN_CELLS:
        arch, shape = c.split("/")
        with open(out / f"{arch}__{shape}__32_8.json") as fh:
            rec = json.load(fh)
        assert RECORD_KEYS <= set(rec), set(rec) ^ RECORD_KEYS
        assert rec["chips"] == 256 and rec["mesh"] == "32x8"
        mem = rec["memory"]
        assert {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                "fits"} <= set(mem)
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 or \
            arch == "gin-tu"
        assert mem["fits"] is True
        # per-device flops x ranks against the same step at global shapes
        whole = dryrun.trace_cell(build_cell(arch, shape, one), "meta")
        per_dev = rec["cost"]["flops_per_device"]
        assert per_dev * 256 == pytest.approx(whole["flops"], rel=0.02), c
        if arch == "llama3-8b":
            assert per_dev > 0
            assert rec["kernels"] == {"flash_decode": 32}
            assert rec["collectives"]["op_counts"]["all-reduce"] == 65
        if arch == "fm":
            assert rec["kernels"] == {"segment_bag_sums": 2}
        if arch == "veretennikov":
            assert rec["kernels"]["unpack_postings"] >= 1
            assert rec["kernels"]["banded_intersect_rows"] == 1
            assert rec["collectives"]["op_counts"]["all-reduce"] == \
                rec["step_collectives"] == 1
            assert rec["collectives"]["bytes_by_axes"].keys() == {"data"}


# ---------------------------------------------------------------------------
# four gloo ranks on a 2 x 2 (data, model) mesh against the reference
# ---------------------------------------------------------------------------

GLOO_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.dist import sharding as shr
from repro_torch.launch.steps import build_cell, materialize

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for case in inputs:
    cell = build_cell(case["arch"], case["arch"], mesh, smoke=True,
                      layout=case["layout"], shape=case["shape"])
    leaves = dict(cell.params, **cell.inputs)
    whole = dict(case["params"], **case["batch"])

    def fill(name, shape, dtype, dev):
        leaf = leaves[name]
        _, start = shr.local_block(leaf.shape, leaf.spec, mesh,
                                   cell.geo.coord)
        arr = np.asarray(whole[name])
        block = arr[tuple(slice(s, s + n) for s, n in zip(start, shape))]
        return torch.tensor(block).to(dtype)      # a copy: steps update it

    params, state, batch = materialize(cell, "cpu", fill)
    loss, grads = cell.step.grads(params, batch)
    out[case["name"]] = {
        "loss": float(loss), "coord": cell.geo.coord,
        "grads": {k: g.numpy() for k, g in grads.items()},
        "specs": {k: v.spec for k, v in cell.params.items()}}
    if case["name"] == "llama3-8b/2d":      # the whole step runs too
        loss2, _ = cell.step(params, state, batch)
        out[case["name"]]["stepped"] = (float(loss2), int(state["step"]))
dump(out)
"""


def _lm_case(arch, layout, n_groups=None, B=4, S=16, seed=0):
    import dataclasses
    cfg = ref_get_arch(arch).make_smoke_config()
    if n_groups:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_groups=n_groups))
    params = ref_tfm.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100
    batch = {"tokens": tokens, "labels": labels}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tfm.loss_fn(cfg, p, batch), has_aux=True))(params)

    def per_layer(tree):
        out = {}
        for k, v in tree.items():
            if k == "layers":
                for leaf, arr in v.items():
                    for i in range(cfg.n_layers):
                        out[f"layers.{i}.{leaf}"] = np.asarray(arr[i],
                                                               np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    case = {"name": f"{arch}/{layout}", "arch": arch, "layout": layout,
            "shape": {"kind": "train", "seq_len": S, "global_batch": B},
            "params": per_layer(params), "batch": batch}
    return case, float(loss), per_layer(grads)


def _gin_case():
    from repro.data import graph_data
    g = graph_data.generate_graph(256, 2048, 16, 4, seed=0)
    cfg = ref_gnn.GINConfig(name="t", n_layers=2, d_hidden=16, d_feat=16,
                            n_classes=4)
    params = ref_gnn.init_params(cfg, jax.random.PRNGKey(0))
    b = graph_data.full_graph_batch(g)
    pad = (-len(b["src"])) % 4
    for k in ("src", "dst"):
        b[k] = np.concatenate([b[k], np.zeros(pad, b[k].dtype)])
    b["edge_mask"] = np.concatenate([b["edge_mask"], np.zeros(pad, bool)])
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_gnn.loss_fn(cfg, p, jb), has_aux=True))(params)
    flat = lambda t: {k: np.asarray(v, np.float32) for k, v in _flat(t).items()}
    shape = {"kind": "train_full", "n_nodes": 256, "n_edges": len(b["src"]),
             "d_feat": 16, "n_classes": 4}
    case = {"name": "gin-tu", "arch": "gin-tu", "layout": "2d",
            "shape": shape, "params": flat(params),
            "batch": {k: np.asarray(v) for k, v in b.items()
                      if k in ("nodes", "src", "dst", "edge_mask", "labels",
                               "label_mask", "node_mask")}}
    return case, float(loss), flat(grads)


def _fm_case(B=16):
    cfg = ref_get_arch("fm").make_smoke_config()
    params = ref_rec.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(0, v, size=B) for v in cfg.field_vocabs],
                   axis=1).astype(np.int32)
    batch = {"ids": ids, "label": rng.integers(0, 2, size=B).astype(np.int32)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_rec.loss_fn(cfg, p, batch), has_aux=True))(params)
    flat = lambda t: {k: np.asarray(v, np.float32) for k, v in _flat(t).items()}
    case = {"name": "fm", "arch": "fm", "layout": "2d",
            "shape": {"kind": "train", "batch": B}, "params": flat(params),
            "batch": batch}
    return case, float(loss), flat(grads)


def _assemble(ranks, name, leaf, shape):
    """The whole gradient of `leaf` from the ranks' blocks (replicated
    blocks must agree)."""
    full = np.full(shape, np.nan, np.float32)
    mesh = MeshShape(("data", "model"), (2, 2))
    for r in ranks:
        got = r[name]["grads"][leaf]
        _, start = shr.local_block(shape, r[name]["specs"][leaf], mesh,
                                   r[name]["coord"])
        sl = tuple(slice(s, s + n) for s, n in zip(start, got.shape))
        prev = full[sl]
        seen = ~np.isnan(prev)
        assert np.allclose(prev[seen], got[seen], atol=1e-6), (name, leaf)
        full[sl] = np.reshape(got, np.shape(full[sl]))
    assert not np.isnan(full).any(), (name, leaf)
    return full


def test_gloo_ranks_match_reference(tmp_path):
    llama, loss, grads = _lm_case("llama3-8b", "2d")
    fsdp = dict(llama, name="llama3-8b/fsdp", layout="fsdp")
    cases = [(llama, loss, grads), (fsdp, loss, grads),
             _lm_case("qwen2.5-32b", "2d"),
             _lm_case("granite-moe-1b-a400m", "2d", n_groups=2),
             _gin_case(), _fm_case()]
    got = run_ranks(GLOO_BODY, [c for c, _, _ in cases], tmp_path,
                    timeout=400)
    tol = {"gin-tu": (1e-4, 1e-5)}
    for case, loss, grads in cases:
        name = case["name"]
        loss_tol, grad_tol = tol.get(name, (2e-5, 2e-5))
        for r in got:
            assert abs(r[name]["loss"] - loss) <= loss_tol, (name, r[name]["loss"], loss)
        assert set(got[0][name]["grads"]) == set(grads), name
        for leaf, want in grads.items():
            full = _assemble(got, name, leaf, want.shape)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(full - want).max()) / scale
            assert err <= grad_tol, (name, leaf, err)
    # the whole step (gradients, clip, AdamW) ran on every rank
    for r in got:
        loss2, step = r["llama3-8b/2d"]["stepped"]
        assert step == 1 and abs(loss2 - cases[0][1]) <= 2e-5


def test_gloo_placement_drift_is_refused():
    """The assembly the gloo check relies on shows a drifted placement: the
    blocks of a rank pair that swapped their 'model' coordinates assemble
    into another tensor than the one laid out."""
    want = np.arange(16, dtype=np.float32).reshape(4, 4)
    mesh = MeshShape(("data", "model"), (2, 2))

    def ranks(swap):
        out = []
        for d in range(2):
            for m in range(2):
                coord = {"data": d, "model": m}
                held = {"data": d, "model": 1 - m if swap else m}
                _, start = shr.local_block((4, 4), (None, "model"), mesh,
                                           held)
                block = want[:, start[1]:start[1] + 2]
                out.append({"x": {"grads": {"w": block}, "coord": coord,
                                  "specs": {"w": (None, "model")}}})
        return out

    assert np.array_equal(_assemble(ranks(False), "x", "w", (4, 4)), want)
    assert not np.array_equal(_assemble(ranks(True), "x", "w", (4, 4)), want)
