"""Steps of the port: the LM prefill that fills the KV cache, the recsys
serve and retrieval steps, and the dry-run's cells.

`forward_with_cache`, `recsys_serve_step` and `recsys_retrieval_step` are
the port of the reference's step bodies (src/repro/launch/steps.py) on
one device.  `build_cell(arch, shape, mesh)` is the port of its
`build_cell`, for the multi-pod dry-run (launch/dryrun.py): for every (arch x
shape x mesh) a `Cell` holding the shapes, dtypes and placements
(`dist/sharding.py`'s rules) of the step's inputs and ONE RANK'S PROGRAM
of the step, `cell.step(params, opt_state, inputs)` on that rank's
blocks, with its collectives explicit (`dist/collectives.py`:
`gather_dim`, `scatter_sum_dim`, `sum_over`) over the process groups of
the mesh's axes.  The reference writes one SPMD program and lets XLA
partition it; here the partition is spelled out, and each rank's
objective is its share of the global loss (the shares sum to it; a
computation replicated over r ranks counts 1 / r on each), so that the
collectives' adjoints give every rank the global gradient of its blocks.
A layer's math is the port's own `DecoderLayer` (its `qkv`, `out` and
`mlp`), built at the rank's widths with the rank's blocks bound into it;
the collectives go between those parts, inside the layer.  PyTorch's
`parallelize_module` styles would not reach them: they shard
`nn.Linear` and `nn.Embedding` modules, and the port's layers hold bare
weights that they multiply themselves.

Kinds per family:
  lm:     train (loss, gradients, AdamW), prefill (the forward that fills
          the cache), decode (one token over a cache).  "2d" layout:
          Megatron tensor parallelism on 'model' with the residual stream
          split on the sequence (the reference's act_pspec P(dp, 'model',
          None)): each layer all-gathers the sequence, computes its heads
          (column-parallel q, k, v; attention on this rank's heads, pinned
          to 'model' where the heads divide it, else on this rank's
          q-sequence rows with k and v whole) and its columns of the MLP,
          and reduce-scatters the row-parallel products back onto the
          sequence.  An MoE layer routes its dp group's tokens
          (n_groups = dp) on every model rank and computes its experts
          (wd's rule splits the experts, wg / wu's their d_expert: where
          the dispatch buffer of every expert is no larger than wg and wu
          gathered, as at decode, each rank's SwiGLU activations of every
          expert on its columns go to the experts' owners by an
          all-to-all over 'model'; else wg / wu are gathered whole).
          "fsdp" (train): every leaf split
          over all axes, gathered before use (cast to the compute dtype
          first, the reference's pre_cast_layers), the batch over all
          axes.  Decode and prefill split the cache's kv heads on
          'model' with the weights (the reference's cache spec is
          replicated there).
  gnn:    train_full / train_minibatch / train_graphs: node rows and edges
          split over all axes (`gin_batch_specs`), the edge-partitioned
          step `models/gnn.py::edge_partitioned_loss_fn`.
  recsys: train, serve, retrieval: tables row-split over all axes, every
          lookup an all-gather of the ids over dp, a masked local lookup
          (FM's bag sums through the segment-bag kernel, ids outside the
          rank's rows as -1), the partial rows summed over 'model' and
          reduce-scattered over dp; retrieval
          splits the candidates over dp (local top 128, gathered, top
          128).  MIND's in-batch softmax takes its dp rank's rows.
  search: search_serve (`serve/search_serve.py::make_search_serve_step`
          on the rank's per-shard arena of `arena_specs(cfg, dp)`).

Training, data-parallel too, runs through `repro_torch.train`
(`make_train_step`, `make_sharded_train_step`, `fit`) and
`launch/train.py`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import get_arch
from repro_torch.dist import sharding as shr
from repro_torch.dist.collectives import (all_to_all_dim, gather_dim,
                                          max_over, scatter_sum_dim, sum_over)
from repro_torch.kernels import ops
from repro_torch.models import gnn as gnn_m
from repro_torch.models import layers as L
from repro_torch.models import recsys as rec
from repro_torch.models.moe import moe_ffn
from repro_torch.models.transformer import DecoderLayer, Transformer
from repro_torch.train import optimizer as opt

RETRIEVAL_TOP_K = 128          # the reference retrieval cell's lax.top_k
OPT_CFG = opt.OptimizerConfig(name="adamw")


@torch.no_grad()
def forward_with_cache(model: Transformer, tokens: torch.Tensor):
    """Prefill: tokens [B, S] -> (last-position logits [B, Vp] float32,
    {"k", "v"}: per-layer cache [L, B, S, Hkv, hd] in the model's dtype).
    Attention is the reference's `causal_attention`, chunked above
    `cfg.attn_chunk.threshold`."""
    cfg = model.cfg
    B, S = tokens.shape
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    ks = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
    vs = torch.empty_like(ks)
    x = model.embed_tokens(tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    for layer, ck, cv in zip(model.layers, ks, vs):
        x, k, v = layer(x, positions)
        ck.copy_(k)
        cv.copy_(v)
        del k, v
    return model.logits(x[:, -1]), {"k": ks, "v": vs}


@torch.no_grad()
def recsys_serve_step(model: rec.RecSysModel, batch: dict) -> torch.Tensor:
    """The recsys serve cell's step: float32 scores [B] of `batch` (torch
    tensors on the model's device: `ids`, and `hist`, `target` for bst and
    mind)."""
    return rec.serve_scores(model, batch)


@torch.no_grad()
def recsys_retrieval_step(model: rec.RecSysModel, batch: dict):
    """The recsys retrieval cell's step: `retrieval_scores` of `batch`
    (`cand` [C] besides the serve inputs), then its top RETRIEVAL_TOP_K per
    row as (values, indices), ties to the lower index as `jax.lax.top_k`
    (a stable descending sort: `torch.topk` promises no order on ties)."""
    scores = rec.retrieval_scores(model, batch)
    return _top_k(scores)


def _top_k(scores: torch.Tensor):
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :RETRIEVAL_TOP_K], idx[:, :RETRIEVAL_TOP_K]


# ---------------------------------------------------------------------------
# the dry-run's cells: inputs, mesh geometry, placed state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One input of a cell: its global shape, dtype and placement."""
    shape: tuple
    dtype: Any
    spec: tuple


@dataclasses.dataclass
class Geometry:
    """This rank's place in the cell's mesh: axis names and sizes, its
    coordinate, and the process group of each set of axes (None without
    a process group: every collective is then over one rank)."""
    mesh: Any
    axes: tuple
    size: dict
    coord: dict
    groups: dict

    @property
    def world(self) -> int:
        return math.prod(self.size.values())

    def n(self, axes) -> int:
        return math.prod(self.size[a] for a in _tuple(axes))

    def index(self, axes) -> int:
        """This rank's linear index along `axes` (the first the major)."""
        i = 0
        for a in _tuple(axes):
            i = i * self.size[a] + self.coord[a]
        return i

    def group(self, axes):
        """The process group over `axes` (None on a mesh without one)."""
        if not self.groups:
            return None
        return self.groups[_tuple(axes)]


def _tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def geometry(mesh) -> Geometry:
    """The `Geometry` of a `DeviceMesh` (this process's rank; the groups
    of every axis, the dp axes and all axes, made here, outside any fake
    mode) or of a `MeshShape` (coordinate 0, no groups)."""
    axes, size = shr.mesh_axes(mesh)
    groups = {}
    if hasattr(mesh, "get_coordinate"):
        coord = dict(zip(axes, mesh.get_coordinate()))
        for a in axes:
            groups[(a,)] = mesh.get_group(a)
        groups[axes] = dist.group.WORLD
        dp = _tuple(shr.mesh_dp_axis(mesh))
        if dp not in groups:
            groups[dp] = mesh[dp]._flatten().get_group()
    else:
        if dist.is_initialized():
            raise ValueError("a process group is up: lay the cell over its "
                             "DeviceMesh")
        coord = dict.fromkeys(axes, 0)
    return Geometry(mesh, axes, size, coord, groups)


@dataclasses.dataclass
class Cell:
    """One dry-run cell: `params` (placed parameters; AdamW state beside
    them when `train`), `inputs` (batch, cache, tables), `step(params,
    opt_state, inputs)` one rank's program on its blocks (opt_state None
    unless `train`), `meta` the reference's meta keys plus the port's
    layout notes."""
    arch_id: str
    shape_name: str
    kind: str
    geo: Geometry
    params: dict
    inputs: dict
    step: Callable
    train: bool
    meta: dict = dataclasses.field(default_factory=dict)

    def local_shape(self, leaf: Leaf) -> tuple:
        return shr.local_block(leaf.shape, leaf.spec, self.geo.mesh,
                               self.geo.coord)[0]

    def param_bytes(self) -> int:
        return sum(_nbytes(self.local_shape(p), p.dtype)
                   for p in self.params.values())

    def opt_state_bytes(self) -> int:
        """AdamW's mu and nu (float32, placed as their parameters) and
        its step counter."""
        if not self.train:
            return 0
        return 2 * sum(_nbytes(self.local_shape(p), torch.float32)
                       for p in self.params.values()) + 4


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def placements(spec: tuple, axes: tuple) -> list:
    """The DTensor placements of `spec` over mesh dims `axes`: Shard(d)
    on each axis that splits dimension d, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axes)
    for d, entry in enumerate(spec):
        for a in _tuple(entry):
            out[axes.index(a)] = Shard(d)
    return out


def materialize(cell: Cell, device, fill: Optional[Callable] = None):
    """(params, opt_state, inputs) of this rank on `device`: its blocks,
    made by `fill(name, local_shape, dtype, device)` (default
    `torch.empty`; under `FakeTensorMode` they take no memory).  The
    parameters are DTensors over the cell's mesh (a `DeviceMesh`) placed
    by the rules, plain blocks on a `MeshShape`; the AdamW state is
    placed as the parameters, its step a 0-d int32 tensor on the CPU."""
    fill = fill or (lambda name, shape, dtype, dev:
                    torch.empty(shape, dtype=dtype, device=dev))
    geo = cell.geo
    params = {}
    for k, leaf in cell.params.items():
        local = fill(k, cell.local_shape(leaf), leaf.dtype, device)
        if hasattr(geo.mesh, "get_coordinate"):
            from torch.distributed.tensor import DTensor
            stride = torch.empty(leaf.shape, device="meta").stride()
            local = DTensor.from_local(local, geo.mesh,
                                       placements(leaf.spec, geo.axes),
                                       run_check=False,
                                       shape=torch.Size(leaf.shape),
                                       stride=stride)
        params[k] = local
    state = None
    if cell.train:
        state = {"step": torch.zeros((), dtype=torch.int32),
                 "mu": {}, "nu": {}}
        for k, leaf in cell.params.items():
            shape = cell.local_shape(leaf)
            for m in ("mu", "nu"):
                state[m][k] = torch.zeros(shape, dtype=torch.float32,
                                          device=device)
    inputs = {k: fill(k, cell.local_shape(v), v.dtype, device)
              for k, v in cell.inputs.items()}
    return params, state, inputs


def local(params: dict) -> dict:
    """The rank's blocks of placed parameters (DTensors or plain): the
    tensors that hold them, which the optimizer updates in place."""
    with torch.no_grad():
        return {k: (v.to_local() if hasattr(v, "to_local") else v)
                for k, v in params.items()}


def _bind(module: nn.Module, tensors: dict) -> nn.Module:
    """Point the module's parameters at `tensors` ({dotted name: tensor})."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub._parameters[leaf] = t
    return module


def _train_step(cell_specs: dict, geo: Geometry, loss_local: Callable):
    """One rank's training step from its objective `loss_local(params,
    inputs) -> (share of the global loss, metrics)`: gradients of its
    blocks, summed over the axes each parameter is replicated on (the
    blocks of a split leaf hold their own gradients), the global norm
    clipped as `OPT_CFG.grad_clip`, AdamW in place.  Returns (the global
    loss, metrics)."""
    clip = OPT_CFG.grad_clip
    no_clip = dataclasses.replace(OPT_CFG, grad_clip=float("inf"))

    def rep_axes(spec) -> tuple:
        split = {a for entry in spec for a in _tuple(entry)}
        return tuple(a for a in geo.axes if a not in split)

    def grads(params, inputs):
        """(the global loss, metrics, {name: the global gradient of this
        rank's block, float32}, the share's sum of squares)."""
        p = local(params)
        for t in p.values():
            t.requires_grad_(True)
        share, metrics = loss_local(p, inputs)
        gs = torch.autograd.grad(share, list(p.values()), allow_unused=True)
        for t in p.values():
            t.requires_grad_(False)
        g = {}
        sq = torch.zeros((), dtype=torch.float32, device=share.device)
        for (k, t), gk in zip(p.items(), gs):
            gk = torch.zeros_like(t) if gk is None else gk.detach()
            rep = rep_axes(cell_specs[k])
            if rep:
                gk = sum_over(gk, geo.group(rep))
            g[k] = gk.float()
            sq = sq + g[k].square().sum() / geo.n(rep)
        loss = sum_over(share.detach(), geo.group(geo.axes))
        return loss, metrics, g, sq

    def step(params, state, inputs):
        loss, metrics, g, sq = grads(params, inputs)
        norm = torch.sqrt(sum_over(sq, geo.group(geo.axes)))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        for v in g.values():
            v.mul_(scale)
        with torch.no_grad():
            opt.apply_updates(no_clip, local(params), g, state)
        return loss, dict(metrics, grad_norm=norm)

    step.grads = lambda params, inputs: grads(params, inputs)[::2]
    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_shapes(cfg) -> dict:
    return shr.leaf_shapes(Transformer(cfg, device="meta"))


def _lm_meta(cfg, B, S) -> dict:
    return {"params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "seq_len": S,
            "global_batch": B, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads, "hd": cfg.hd}


class _TP:
    """The Megatron program's view of one layer on this rank: how the heads
    and experts lie (see the module docstring), and `layer`, the port's own
    `DecoderLayer` at this rank's widths (its heads, kv heads and MLP
    columns where they split over 'model', else whole), into which each
    layer's blocks are bound (`bind`).  The collectives and the parts the
    layer has no counterpart for (the q-sequence rows, the expert split,
    the vocabulary-parallel embedding and head) are written here."""

    def __init__(self, cfg, geo: Geometry, specs: dict):
        self.cfg, self.geo = cfg, geo
        self.tp = geo.n("model") if "model" in geo.axes else 1
        self.r = geo.coord.get("model", 0)
        self.g_tp = geo.group("model")
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.heads = Hq % self.tp == 0        # heads pinned to 'model'
        self.kv_split = self.heads and Hkv % self.tp == 0
        self.spec = specs
        split = {k.split(".", 2)[2]: any(e is not None for e in v)
                 for k, v in specs.items() if k.startswith("layers.0.")}
        self.ff_split = split["wg"] and split["wu"] and split["wd"]
        self.expert_split = False
        moe = cfg.moe
        if moe:
            self.expert_split = specs["layers.0.wd"][0] is not None
            self.ff_split = self.ff_split and not self.expert_split
            self.moe_cols_split = split["wg"] and split["wu"]
            E = moe.n_experts
            self.experts = ((self.r * E // self.tp, (self.r + 1) * E // self.tp)
                            if self.expert_split else None)
            moe = dataclasses.replace(                # one routing group a rank
                moe, n_groups=1, d_expert=moe.d_expert // (
                    self.tp if self.ff_split else 1))
        self.local = {"wq": self.heads, "bq": self.heads, "wo": self.heads,
                      **dict.fromkeys(("wk", "wv", "bk", "bv"), self.kv_split),
                      **dict.fromkeys(("wg", "wu", "wd"), self.ff_split)}
        self.layer = DecoderLayer(dataclasses.replace(
            cfg, head_dim=cfg.hd, moe=moe,
            n_heads=Hq // self.tp if self.heads else Hq,
            n_kv_heads=Hkv // self.tp if self.kv_split else Hkv,
            d_ff=cfg.d_ff // self.tp if self.ff_split else cfg.d_ff),
            device="meta")

    def whole(self, lp: dict, name: str) -> torch.Tensor:
        """Leaf `name` of layer params `lp`, gathered whole if it is split."""
        spec = self.spec["layers.0." + name]
        t = lp[name]
        for d, entry in enumerate(spec):
            if entry is not None:
                t = gather_dim(t, d, self.geo.group(entry))
        return t

    def bind(self, lp: dict) -> DecoderLayer:
        """`layer` with layer params `lp`: this rank's blocks where `layer`
        is at this rank's widths, the leaves gathered whole elsewhere (the
        expert-split MoE weights are read from `lp` by `mlp_partial`)."""
        return _bind(self.layer, {
            k: t if self.local.get(k, True) else self.whole(lp, k)
            for k, t in lp.items()
            if not (self.expert_split and k in ("wg", "wu", "wd"))})

    def read_kv(self, k, v):
        """The kv heads [lo, hi) that this rank's q heads read, of k, v
        holding every kv head (the heads branch with kv heads that do not
        split over 'model'), as one GQA block: the rank's q heads must lie
        in whole groups, or inside one."""
        if not self.heads or self.kv_split:
            return k, v
        hq = self.cfg.n_heads // self.tp
        G = self.cfg.n_heads // self.cfg.n_kv_heads
        if hq % G and G % hq:
            raise ValueError(f"{hq} q heads a rank straddle kv groups of {G}")
        lo = self.r * hq // G
        hi = ((self.r + 1) * hq - 1) // G + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]

    def attention_block(self, layer, x, positions, kv_out=None):
        """Residual after attention: x [b, S/tp, D] this rank's rows of
        the sequence."""
        q, k, v = layer.qkv(gather_dim(x, 1, self.g_tp), positions)
        S = q.shape[1]
        if kv_out is not None:
            kv_out(k, v)
        if self.heads:
            cq, ckv = self.cfg.attn_chunk.for_seq(S)
            o = L.causal_attention(q, *self.read_kv(k, v), chunk_q=cq,
                                   chunk_kv=ckv)
            return x + scatter_sum_dim(layer.out(o), 1, self.g_tp)
        s = S // self.tp                      # q-sequence rows of this rank
        o = _attention_rows(q[:, self.r * s:(self.r + 1) * s], k, v,
                            self.r * s)
        return x + layer.out(o)

    def mlp_partial(self, layer, lp, h2, train: bool):
        """This rank's share of the MLP or MoE output of h2 [b, S, D] (the
        residual normed by ln2) and the layer's aux loss (the whole
        batch's)."""
        cfg = self.cfg
        reduce = None
        if cfg.moe:
            dp = shr.mesh_dp_axis(self.geo.mesh)
            dp_g, n_dp = self.geo.group(dp), self.geo.n(dp)

            def reduce(counts, psum):
                return (sum_over(counts, dp_g).detach(), sum_over(psum, dp_g),
                        n_dp)
        if self.expert_split:
            lo, hi = self.experts
            wg, wu, exchange = lp["wg"], lp["wu"], None
            if self.exchanges(h2, train, wg):
                def exchange(act):
                    return all_to_all_dim(act, 0, 2, self.g_tp)
            else:
                wg = self.whole(lp, "wg")[lo:hi]
                wu = self.whole(lp, "wu")[lo:hi]
            return moe_ffn(h2, lp["router"], wg, wu, lp["wd"],
                           layer.cfg.moe, cfg.dtype,
                           dropless=not train, experts=(lo, hi),
                           exchange=exchange, aux_reduce=reduce)
        y, aux = layer.mlp(h2, dropless=not train, aux_reduce=reduce)
        return (y, aux) if self.ff_split else (y / self.tp, aux)

    def exchanges(self, x, train: bool, wg) -> bool:
        """Whether an expert-split MoE layer sends its SwiGLU activations on
        this rank's d_expert columns of every expert to the experts'
        owners (an all-to-all) rather than gathering wg / wu whole: where
        wg / wu split their columns and the dispatch buffer of every
        expert, [E, C, D] in the compute dtype, is no larger than the two
        gathered weights, 2 x [E, D, Fe] (decode's few tokens; not
        prefill's dropless C = T)."""
        moe = self.cfg.moe
        T = x.numel() // x.shape[-1]
        C = T if not train else int(T * moe.top_k / moe.n_experts
                                    * moe.capacity_factor) + 1
        return (self.moe_cols_split and C * self.cfg.dtype.itemsize
                <= 2 * moe.d_expert * wg.element_size())

    def block(self, lp, x, positions, train: bool = True, kv_out=None):
        layer = self.bind(lp)
        x = self.attention_block(layer, x, positions, kv_out)
        h2 = L.rms_norm(gather_dim(x, 1, self.g_tp), layer.ln2)
        y, aux = self.mlp_partial(layer, lp, h2, train)
        return x + scatter_sum_dim(y, 1, self.g_tp), aux

    # -- embedding and head: the vocabulary split on 'model' -----------------

    def vocab_range(self, spec_name: str, n_rows: int) -> tuple[int, int]:
        split = self.spec[spec_name][0 if spec_name == "embed" else 1]
        if split is None:
            return 0, n_rows
        return self.r * n_rows, (self.r + 1) * n_rows

    def embed(self, p, tokens):
        """This rank's rows of the sequence of embedded tokens [b, S/tp, D]
        (vocab-parallel lookup, reduce-scattered onto the sequence)."""
        emb = p["embed"]
        lo, hi = self.vocab_range("embed", emb.shape[0])
        tok = tokens.long()
        inside = (tok >= lo) & (tok < hi)
        rows = F.embedding(torch.where(inside, tok - lo, 0), emb)
        rows = rows * inside[..., None].to(rows.dtype)
        if hi - lo == emb.shape[0] and self.spec["embed"][0] is None:
            s = tokens.shape[1] // self.tp
            return rows[:, self.r * s:(self.r + 1) * s].to(self.cfg.dtype)
        return scatter_sum_dim(rows, 1, self.g_tp).to(self.cfg.dtype)

    def head(self, p):
        """This rank's columns of the head [D, V'] and their first vocab
        index."""
        if self.cfg.tie_embeddings:
            lo, _ = self.vocab_range("embed", p["embed"].shape[0])
            return p["embed"].T, lo
        lo, _ = self.vocab_range("lm_head", p["lm_head"].shape[1])
        return p["lm_head"], lo

    def logits(self, p, x):
        """Float32 logits of this rank's vocabulary columns, x [..., D]."""
        head, lo = self.head(p)
        x = L.rms_norm(x, p["final_norm"])
        with L.exact_f32_products(x):
            return x.float() @ head.to(self.cfg.dtype).float(), lo

    def full_logits(self, p, x):
        z, _ = self.logits(p, x)
        if z.shape[-1] == self.cfg.vocab_padded:
            return z
        return gather_dim(z, z.dim() - 1, self.g_tp)


def _layer_params(p: dict, n_layers: int) -> list:
    """[{leaf: tensor} of layer i] of the flat parameters `p`."""
    out = [{} for _ in range(n_layers)]
    for k, v in p.items():
        if k.startswith("layers."):
            _, i, leaf = k.split(".", 2)
            out[int(i)][leaf] = v
    return out


def _attention_rows(q, k, v, q0: int):
    """Causal GQA attention of q rows at positions q0 + i (q [b, s, Hq,
    hd]) over the whole k, v [b, S, Hkv, hd]: the q-sequence branch, the
    reference's full `causal_attention` restricted to those rows."""
    b, s, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    with L.exact_f32_products(q):
        qg = q.reshape(b, s, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
        logits = torch.einsum("bhgqd,bkhd->bhgqk", qg, k.float()) / hd ** 0.5
        qpos = q0 + torch.arange(s, device=q.device)
        mask = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, L.NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
        o = torch.einsum("bhgqk,bkhd->bhgqd", probs, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, Hq, hd).to(q.dtype)


def _vocab_nll(tp: _TP, z, lo: int, labels):
    """Per-token NLL [b, S] from this rank's float32 logit columns z [b,
    S, V'] (columns lo..): the max, the sum of exponentials and the gold
    logit summed over 'model'; padding columns masked to -1e30."""
    cfg = tp.cfg
    col = lo + torch.arange(z.shape[-1], device=z.device)
    if cfg.vocab_padded != cfg.vocab:
        z = z.masked_fill(col >= cfg.vocab, L.NEG_INF)
    lab = labels.long().clamp(min=0)
    if z.shape[-1] == cfg.vocab_padded:       # the vocabulary whole
        gold = torch.gather(z, -1, lab[..., None])[..., 0]
        return torch.logsumexp(z, dim=-1) - gold
    g = tp.g_tp
    m = max_over(z.amax(dim=-1), g)
    sumexp = sum_over(torch.exp(z - m[..., None]).sum(dim=-1), g)
    logz = m + torch.log(sumexp)
    inside = (lab >= lo) & (lab < lo + z.shape[-1])
    gold = torch.gather(z, -1, torch.where(inside, lab - lo, 0)[..., None])
    gold = sum_over(gold[..., 0] * inside.to(z.dtype), g)
    return logz - gold


def _lm_2d_train_loss(cfg, geo: Geometry, specs: dict):
    tp = _TP(cfg, geo, specs)
    n_layers = cfg.n_layers
    world = geo.world
    dp_g = geo.group(shr.mesh_dp_axis(geo.mesh))

    def loss_local(p, inputs):
        tokens, labels = inputs["tokens"], inputs["labels"]
        b, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        x = tp.embed(p, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in _layer_params(p, n_layers):
            def block(x, lp=lp):
                return tp.block(lp, x, positions, train=True)

            if cfg.remat:
                x, a = checkpoint(block, x, use_reentrant=False)
            else:
                x, a = block(x)
            aux = aux + a
        z, lo = tp.logits(p, gather_dim(x, 1, tp.g_tp))
        nll = _vocab_nll(tp, z, lo, labels)
        valid = labels >= 0
        s = S // tp.tp
        own = slice(tp.r * s, (tp.r + 1) * s)
        count = sum_over(valid.sum().float(), dp_g).clamp(min=1)
        share = (nll * valid)[:, own].sum() / count + aux / world
        return share, {"aux": aux}

    return loss_local


def _lm_fsdp_train_loss(cfg, geo: Geometry, specs: dict):
    """ZeRO-3: each leaf gathered whole (in the compute dtype) before its
    use, the batch split over all axes; an MoE layer routes this rank's
    tokens as one group."""
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_groups=1))
    model = Transformer(cfg, device="meta")
    g_all = geo.group(geo.axes)
    world = geo.world
    dt = cfg.dtype

    def whole(name, t, cast=True):
        if cast and t.dtype.is_floating_point and not name.endswith("router"):
            t = t.to(dt)                   # pre_cast_layers
        for d, entry in enumerate(specs[name]):
            if entry is not None:
                t = gather_dim(t, d, geo.group(entry))
        return t

    def reduce(counts, psum):
        return sum_over(counts, g_all).detach(), sum_over(psum, g_all), world

    def loss_local(p, inputs):
        tokens, labels = inputs["tokens"], inputs["labels"]
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        emb = whole("embed", p["embed"])
        x = F.embedding(tokens.long(), emb).to(dt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(model.layers):
            names = [k for k in p if k.startswith(f"layers.{i}.")]

            def block(x, *ws, layer=layer, names=names):
                full = {n.split(".", 2)[2]: whole(n, w)
                        for n, w in zip(names, ws)}
                _bind(layer, full)
                return layer.block(x, positions, dropless=False,
                                   aux_reduce=reduce if cfg.moe else None)

            ws = [p[n] for n in names]
            if cfg.remat:
                x, a = checkpoint(block, x, *ws, use_reentrant=False)
            else:
                x, a = block(x, *ws)
            aux = aux + a
        x = L.rms_norm(x, whole("final_norm", p["final_norm"], cast=False))
        head = emb.T if cfg.tie_embeddings else whole("lm_head", p["lm_head"])
        with L.exact_f32_products(x):
            z = x.float() @ head.to(dt).float()
        if cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(cfg.vocab_padded, device=z.device) >= cfg.vocab
            z = z.masked_fill(pad, L.NEG_INF)
        valid = labels >= 0
        logz = torch.logsumexp(z, dim=-1)
        gold = torch.gather(z, -1, labels.long().clamp(min=0)[..., None])[..., 0]
        count = sum_over(valid.sum().float(), g_all).clamp(min=1)
        share = ((logz - gold) * valid).sum() / count + aux / world
        return share, {"aux": aux}

    return loss_local


def _heads_split(tp: _TP, what: str):
    """Serving runs on this rank's heads: they must split over 'model' (as
    on the H100 meshes, for every arch)."""
    if not tp.heads:
        raise ValueError(f"{what}: {tp.cfg.n_heads} heads do not split over "
                         f"{tp.tp} model ranks")


def _lm_decode(cfg, geo: Geometry, specs: dict):
    """One token over a cache [L, b, S, Hkv', hd] of this rank's kv heads:
    the reference's `decode_step` with the flash-decode kernel on this
    rank's heads; row-parallel products all-reduced over 'model'; logits
    gathered whole."""
    tp = _TP(cfg, geo, specs)
    dt = cfg.dtype

    @torch.no_grad()
    def step(params, state, inputs):
        _heads_split(tp, "decode")
        p = local(params)
        cache, tokens = {"k": inputs["k"], "v": inputs["v"]}, inputs["tokens"]
        cur_len = cache["k"].shape[2] - 1     # the last slot: a full cache
        b = tokens.shape[0]
        emb = p["embed"]
        lo, hi = tp.vocab_range("embed", emb.shape[0])
        tok = tokens.long()[:, None]
        inside = (tok >= lo) & (tok < hi)
        x = F.embedding(torch.where(inside, tok - lo, 0), emb)
        x = x * inside[..., None].to(x.dtype)
        if hi - lo != cfg.vocab_padded:
            x = sum_over(x, tp.g_tp)
        x = x.to(dt)                                         # [b, 1, D]
        pos = torch.full((b, 1), cur_len, dtype=torch.int32,
                         device=tokens.device)
        kv_len = torch.full((b,), cur_len + 1, dtype=torch.int32,
                            device=tokens.device)
        slot = min(max(cur_len, 0), cache["k"].shape[2] - 1)
        for i, lp in enumerate(_layer_params(p, cfg.n_layers)):
            layer = tp.bind(lp)
            q, k, v = layer.qkv(x, pos)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            o = L.decode_attention(q[:, 0], *tp.read_kv(ck, cv), kv_len,
                                   impl="flash")
            x = x + sum_over(layer.out(o[:, None]), tp.g_tp)
            y, _ = tp.mlp_partial(layer, lp, L.rms_norm(x, layer.ln2),
                                  train=False)
            x = x + sum_over(y, tp.g_tp)
        return tp.full_logits(p, x[:, 0]), cache

    return step


def _lm_prefill(cfg, geo: Geometry, specs: dict):
    """The Megatron forward (sequence split, no backward) that fills this
    rank's cache of its kv heads and gives the last position's logits."""
    tp = _TP(cfg, geo, specs)

    @torch.no_grad()
    def step(params, state, inputs):
        _heads_split(tp, "prefill")
        p = local(params)
        tokens = inputs["tokens"]
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        ks, vs = inputs["k"], inputs["v"]
        x = tp.embed(p, tokens)
        for i, lp in enumerate(_layer_params(p, cfg.n_layers)):
            def keep(k, v, i=i):
                ks[i].copy_(k)
                vs[i].copy_(v)

            x, _ = tp.block(lp, x, positions, train=False, kv_out=keep)
        last = gather_dim(x, 1, tp.g_tp)[:, -1]
        return tp.full_logits(p, last), {"k": ks, "v": vs}

    return step


def _lm_cell(arch_id, shape_name, shape, geo: Geometry, smoke, layout):
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    kind = shape["kind"]
    B, S = shape["global_batch"], shape["seq_len"]
    shapes = _lm_shapes(cfg)
    mesh = geo.mesh
    meta = _lm_meta(cfg, B, S)
    fsdp = layout == "fsdp" and kind == "train"
    specs = shr.transformer_param_specs(cfg, mesh, "fsdp" if fsdp else "2d",
                                        shapes=shapes)
    params = {k: Leaf(s, cfg.param_dtype if not k.endswith("router")
                      else torch.float32, specs[k]) for k, s in shapes.items()}
    if kind == "train":
        if fsdp:
            if B % geo.world:
                raise ValueError(f"fsdp: global batch {B} does not split "
                                 f"over {geo.world} ranks")
            bspec = (geo.axes, None)
            loss = _lm_fsdp_train_loss(cfg, geo, specs)
        else:
            bspec = shr.transformer_batch_specs(mesh)["tokens"]
            if S % geo.n("model"):
                raise ValueError(f"sequence {S} does not split over 'model'")
            loss = _lm_2d_train_loss(cfg, geo, specs)
        inputs = {"tokens": Leaf((B, S), torch.int32, bspec),
                  "labels": Leaf((B, S), torch.int32, bspec)}
        step = _train_step(specs, geo, loss)
        meta["layout"] = layout if fsdp else "2d"
        return Cell(arch_id, shape_name, "train", geo, params, inputs, step,
                    True, meta)
    tp_n = geo.n("model") if "model" in geo.axes else 1
    hkv = cfg.n_kv_heads // tp_n if cfg.n_kv_heads % tp_n == 0 \
        else cfg.n_kv_heads
    kv_spec = "model" if cfg.n_kv_heads % tp_n == 0 and tp_n > 1 else None
    cache_spec = shr.transformer_cache_specs(cfg, mesh, B)["k"]
    cache_spec = cache_spec[:3] + (kv_spec, None)
    cache = Leaf((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd), cfg.dtype,
                 cache_spec)
    meta["cache"] = ("kv heads split on 'model'" if kv_spec else
                     "kv heads whole") + f", {hkv} a rank"
    if kind == "prefill":
        inputs = {"tokens": Leaf((B, S), torch.int32, (cache_spec[1], None)),
                  "k": cache, "v": cache}
        return Cell(arch_id, shape_name, "prefill", geo, params, inputs,
                    _lm_prefill(cfg, geo, specs), False, meta)
    inputs = {"k": cache, "v": cache,
              "tokens": Leaf((B,), torch.int32, (cache_spec[1],))}
    meta["cur_len"] = S - 1
    return Cell(arch_id, shape_name, "decode", geo, params, inputs,
                _lm_decode(cfg, geo, specs), False, meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def gnn_cell_config(arch_id: str, shape: dict, smoke: bool = False):
    spec = get_arch(arch_id)
    base = spec.make_smoke_config() if smoke else spec.make_config()
    return dataclasses.replace(base, d_feat=shape["d_feat"],
                               n_classes=shape["n_classes"],
                               graph_readout=shape["kind"] == "train_graphs")


def _gnn_cell(arch_id, shape_name, shape, geo: Geometry, smoke) -> Cell:
    cfg = gnn_cell_config(arch_id, shape, smoke)
    model = gnn_m.GIN(cfg, device="meta")
    shapes = shr.leaf_shapes(model)
    params = {k: Leaf(s, torch.float32 if k.endswith("eps")
                      else cfg.param_dtype, (None,) * len(s))
              for k, s in shapes.items()}
    world = geo.world
    kind = shape["kind"]
    if kind == "train_minibatch":
        seeds = shape["batch_nodes"]
        f_prod, N = 1, seeds
        for f in shape["fanout"]:
            f_prod *= f
            N += seeds * f_prod
        E = N - seeds
    elif kind == "train_graphs":
        N = shape["batch"] * shape["n_nodes"]
        E = shape["batch"] * shape["n_edges"]
    else:
        N, E = shape["n_nodes"], shape["n_edges"]
    meta_edges = E
    N = -(-N // world) * world          # pad to the mesh: even row splits
    E = -(-E // world) * world
    ax = shr.gnn_dp_axis(geo.mesh)
    rows = (ax,)
    inputs = {"nodes": Leaf((N, shape["d_feat"]), torch.float32, (ax, None)),
              "src": Leaf((E,), torch.int32, rows),
              "dst": Leaf((E,), torch.int32, rows),
              "edge_mask": Leaf((E,), torch.bool, rows),
              "labels": Leaf((N,), torch.int32, rows),
              "label_mask": Leaf((N,), torch.bool, rows),
              "node_mask": Leaf((N,), torch.bool, rows)}
    n_graphs = None
    if kind == "train_graphs":
        n_graphs = shape["batch"]
        lab = rows if n_graphs % world == 0 else (None,)
        inputs["labels"] = Leaf((n_graphs,), torch.int32, lab)
        inputs["label_mask"] = Leaf((n_graphs,), torch.bool, lab)
        inputs["graph_id"] = Leaf((N,), torch.int32, rows)
    g_all = geo.group(geo.axes)

    def loss_local(p, batch):
        _bind(model, p)
        return gnn_m.edge_partitioned_loss_fn(model, dict(batch), g_all,
                                              n_graphs=n_graphs)

    meta = {"params": cfg.param_count(), "n_nodes": N, "n_edges": meta_edges,
            "d_feat": shape["d_feat"], "d_hidden": cfg.d_hidden,
            "n_layers": cfg.n_layers}
    specs = {k: v.spec for k, v in params.items()}
    return Cell(arch_id, shape_name, kind, geo, params, inputs,
                _train_step(specs, geo, loss_local), True, meta)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

class RowShardedRecSys(rec.RecSysModel):
    """A `RecSysModel` whose tables (`table`, `item_table`, `w_lin`) hold
    this rank's block of rows, starting at `row_lo[name]`: a lookup
    all-gathers the ids over the dp axes (the 'model' ranks of a dp rank
    hold the same ids), takes the rows this rank holds (zeros elsewhere;
    FM's bags through `ops.segment_bag` with the other ids as -1), sums
    the partial rows over 'model' and reduce-scatters them over the dp
    axes, so each rank gets its own ids' rows summed over every rank that
    holds some."""

    def __init__(self, cfg, geo: Geometry, row_lo: dict):
        super().__init__(cfg, device="meta")
        self.geo, self.row_lo = geo, row_lo
        dp = shr.mesh_dp_axis(geo.mesh)
        self.g_dp, self.g_model = geo.group(dp), geo.group("model")

    def _local_ids(self, name, idx):
        ids = gather_dim(idx.contiguous(), 0, self.g_dp)
        lo = self.row_lo[name]
        n = getattr(self, name).shape[0]
        inside = (ids >= lo) & (ids < lo + n)
        return torch.where(inside, ids - lo, -1), inside

    def _own(self, partial):
        return scatter_sum_dim(sum_over(partial, self.g_model), 0, self.g_dp)

    def take(self, name, idx):
        ids, inside = self._local_ids(name, idx)
        rows = rec._take(getattr(self, name), ids.clamp(min=0))
        return self._own(rows * inside[..., None].to(rows.dtype))

    def bag(self, name, rows):
        ids, _ = self._local_ids(name, rows)
        return self._own(ops.segment_bag(getattr(self, name), ids))

    def bind(self, params: dict, device) -> "RowShardedRecSys":
        """Point the parameters at this rank's blocks (and the field
        offsets at `device`)."""
        _bind(self, params)
        if self.offsets.device != torch.device(device):
            self._buffers["offsets"] = self.cfg.field_offsets(device)
        return self


def _recsys_cell(arch_id, shape_name, shape, geo: Geometry, smoke) -> Cell:
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    mesh = geo.mesh
    shapes = shr.leaf_shapes(rec.RecSysModel(cfg, device="meta"))
    specs = shr.recsys_param_specs(cfg, mesh, shapes=shapes)
    params = {k: Leaf(s, cfg.param_dtype, specs[k]) for k, s in shapes.items()}
    row_lo = {k: shr.local_block(s, specs[k], mesh, geo.coord)[1][0]
              for k, s in shapes.items() if k in ("table", "item_table",
                                                  "w_lin")}
    model = RowShardedRecSys(cfg, geo, row_lo)
    B = shape["batch"]
    kind = shape["kind"]
    dp = shr.mesh_dp_axis(mesh)
    n_dp = geo.n(dp)
    split = B % n_dp == 0 and B >= n_dp
    bdim = dp if split else None
    bspec = shr.recsys_batch_specs(cfg, mesh, retrieval=kind == "retrieval")
    inputs = {"ids": Leaf((B, cfg.n_fields), torch.int32, (bdim, None))}
    if kind == "train":
        inputs["label"] = Leaf((B,), torch.int32, (bdim,))
    if cfg.model in ("bst", "mind"):
        inputs["hist"] = Leaf((B, cfg.seq_len), torch.int32, (bdim, None))
        inputs["target"] = Leaf((B,), torch.int32, (bdim,))
    meta = {"params": cfg.param_count(), "batch": B, "model": cfg.model,
            "embed_dim": cfg.embed_dim, "n_fields": cfg.n_fields,
            "lookup": "row-split tables: ids all-gathered over dp, partial "
                      "rows summed over model, reduce-scattered over dp"}
    replicas = geo.world // (n_dp if split else 1)   # ranks with these rows
    if kind == "train":
        def loss_local(p, batch):
            model.bind(p, batch["ids"].device)
            loss, m = rec.loss_fn(model, batch)
            return loss * (batch["ids"].shape[0] / B) / replicas, m
        if cfg.model == "mind":
            meta["in_batch"] = "softmax over the dp rank's rows"
        return Cell(arch_id, shape_name, "train", geo, params, inputs,
                    _train_step(specs, geo, loss_local), True, meta)
    if kind == "serve":
        @torch.no_grad()
        def serve(params, state, batch):
            model.bind(local(params), batch["ids"].device)
            return rec.serve_scores(model, batch)
        return Cell(arch_id, shape_name, "serve", geo, params, inputs, serve,
                    False, meta)
    C = shape["n_candidates"]
    inputs["cand"] = Leaf((C,), torch.int32, bspec["cand"] or (None,))
    meta["n_candidates"] = C
    c_split = C % n_dp == 0
    meta["candidates"] = "split over dp" if c_split else "whole on every rank"

    @torch.no_grad()
    def retrieve(params, state, batch):
        model.bind(local(params), batch["ids"].device)
        cand = batch["cand"]
        c0 = 0
        if c_split:
            c = C // n_dp
            c0 = geo.index(dp) * c
            cand = cand[c0:c0 + c]
        scores = rec.retrieval_scores(model, dict(batch, cand=cand))
        vals, idx = _top_k(scores)
        if not c_split:
            return vals, idx
        g = geo.group(dp)
        vals = gather_dim(vals.contiguous(), 1, g)
        idx = gather_dim((idx + c0).contiguous(), 1, g)
        top, at = _top_k(vals)
        return top, torch.gather(idx, 1, at)

    return Cell(arch_id, shape_name, "retrieval", geo, params, inputs,
                retrieve, False, meta)


# ---------------------------------------------------------------------------
# search cells
# ---------------------------------------------------------------------------

def search_cell_config(arch_id: str, shape: dict, smoke: bool = False):
    spec = get_arch(arch_id)
    base = spec.make_smoke_config() if smoke else spec.make_config()
    return dataclasses.replace(
        base, queries=shape.get("queries", base.queries),
        postings_pad=shape.get("postings_pad", base.postings_pad),
        n_basic=shape.get("n_basic", base.n_basic),
        n_expanded=shape.get("n_expanded", base.n_expanded),
        n_stop=shape.get("n_stop", base.n_stop),
        n_multi=shape.get("n_multi", base.n_multi),
        ranked=shape.get("ranked", base.ranked))


def _search_cell(arch_id, shape_name, shape, geo: Geometry, smoke) -> Cell:
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.serve import search_serve as ss
    cfg = search_cell_config(arch_id, shape, smoke)
    dp = shr.mesh_dp_axis(geo.mesh)
    dp_n = geo.n(dp)
    arenas = ss.arena_specs(cfg, dp_n)
    inputs = {k: Leaf(s, dt, (_tuple(dp),) + (None,) * (len(s) - 1))
              for k, (s, dt) in arenas.items()}
    queries = ss.query_table_specs(cfg)
    inputs.update({"q." + k: Leaf(s, dt, (None,) * len(s))
                   for k, (s, dt) in queries.items()})
    host = HostMesh(data=dp_n, model=geo.n("model"), dp_rank=geo.index(dp),
                    dp_size=dp_n, device=torch.device("cpu"),
                    dp_group=geo.group(dp))
    serve = ss.make_search_serve_step(cfg, host)

    def step(params, state, inputs):
        arena = {k: inputs[k][0] for k in arenas}
        tables = {k[2:]: v for k, v in inputs.items() if k.startswith("q.")}
        return serve(arena, tables)

    step.serve = serve
    meta = {"queries": cfg.queries, "groups": cfg.groups,
            "postings_pad": cfg.postings_pad, "arena_per_shard": cfg.n_arena,
            "n_shards": dp_n, "ranked": cfg.ranked}
    return Cell(arch_id, shape_name, "search_serve", geo, {}, inputs, step,
                False, meta)


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh, smoke: bool = False,
               layout: str = "2d", shape: Optional[dict] = None) -> Cell:
    """The cell of (arch, shape) on `mesh` (a `DeviceMesh` this process is
    a rank of, or a `MeshShape`), "2d" or "fsdp" for the LM train cells;
    `smoke` takes the arch's smoke config and `shape` replaces the
    registry's shape parameters (tests)."""
    spec = get_arch(arch_id)
    shape = shape or spec.shapes[shape_name]
    geo = geometry(mesh)
    if spec.family == "lm":
        return _lm_cell(arch_id, shape_name, shape, geo, smoke, layout)
    if spec.family == "gnn":
        return _gnn_cell(arch_id, shape_name, shape, geo, smoke)
    if spec.family == "recsys":
        return _recsys_cell(arch_id, shape_name, shape, geo, smoke)
    if spec.family == "search":
        return _search_cell(arch_id, shape_name, shape, geo, smoke)
    raise ValueError(spec.family)
