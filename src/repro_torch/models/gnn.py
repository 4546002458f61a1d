"""GIN (Graph Isomorphism Network, arXiv:1810.00826): the port of
src/repro/models/gnn.py.

Message passing is a gather of the sources' rows and an `index_add_` of
them into a zeroed [N, d] tensor at their destinations (the reference's
`jax.ops.segment_sum` over an explicit edge index: the scatter is the
SpMM).  On the card `index_add_` adds with float atomics, in no fixed
order, so card and CPU agree to the float32 tolerance, not bit for bit.
The masked messages are made once, in place on the gathered rows (a
[E, d] tensor a layer: 24.7 GB at ogb_products' first layer), and nothing
of them is kept for the backward (`_Aggregate`: the transpose, gather at
the destinations and add at the sources, needs only the edge index and
mask).  One forward serves all four assigned shapes:

  * full-graph node classification (full_graph_sm / ogb_products),
  * fanout-sampled minibatch training (minibatch_lg; sampler in
    data/graph_data.py produces padded subgraphs),
  * batched small molecule graphs with sum-pool readout (molecule).

h' = MLP((1 + eps) * h + sum_{j in N(i)} h_j), eps learnable per layer.

`GIN` holds the parameters under the reference dict's names
(`layers.{i}.eps/w1/b1/w2/b2`, `head_w`, `head_b`; `eps` float32, the
rest in `param_dtype`), made without `requires_grad` (the training step
turns it on); the forwards are plain functions of the model.  The
halo-exchange variant (`halo_layer`, `halo_loss_fn`) runs one rank per
node shard of `data.graph_data.partition_for_halo`, its boundary rows
exchanged by `dist.collectives.all_gather` and its loss summed by
`dist.collectives.psum`, both under autograd.  The edge-partitioned
variant (`edge_partitioned_loss_fn`, the dry-run's GIN step) splits node
rows and edges over every rank of a group: each layer all-gathers the
node rows, this rank's edges make their messages into all N rows, and
the sums are reduce-scattered back to their owners
(`dist.collectives.gather_dim` / `scatter_sum_dim`, under autograd).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.dist import collectives
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 40
    graph_readout: bool = False     # molecule: sum-pool per graph
    message_dtype: Any = None       # cast h for the gather/scatter step
                                    # (bf16 halves the cross-shard volume)
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def param_count(self) -> int:
        mlp0 = self.d_feat * self.d_hidden + self.d_hidden
        mlp = 2 * (self.d_hidden * self.d_hidden + self.d_hidden)
        per = mlp + 1
        return mlp0 + self.d_hidden * self.d_hidden + self.d_hidden + \
            (self.n_layers - 1) * per + self.n_layers + \
            self.d_hidden * self.n_classes + self.n_classes


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, dtype, device):
        super().__init__()
        self.eps = _param((), torch.float32, device)
        self.w1 = _param((d_in, d_hidden), dtype, device)
        self.b1 = _param((d_hidden,), dtype, device)
        self.w2 = _param((d_hidden, d_hidden), dtype, device)
        self.b2 = _param((d_hidden,), dtype, device)


class GIN(nn.Module):
    """The parameters of one GIN, created uninitialised on `device` (the
    card unless the caller asks for the CPU); `init_params` or
    `carry.gnn_params_from_reference` fill them."""

    def __init__(self, cfg: GINConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        pd = cfg.param_dtype
        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
        self.layers = nn.ModuleList(GINLayer(d, cfg.d_hidden, pd, device)
                                    for d in dims)
        self.head_w = _param((cfg.d_hidden, cfg.n_classes), pd, device)
        self.head_b = _param((cfg.n_classes,), pd, device)

    @property
    def device(self) -> torch.device:
        return self.head_w.device


@torch.no_grad()
def init_params(cfg: GINConfig, generator: torch.Generator,
                device=None) -> GIN:
    """A model with the reference's initial scales: eps and biases 0,
    weight matrices N(0, fan_in ** -0.5), drawn from `generator` (a
    generator on `device`) on `device`: each layer's w1, then w2, then
    the head."""
    model = GIN(cfg, device)
    for layer in model.layers:
        layer.eps.zero_()
        layer.b1.zero_()
        layer.b2.zero_()
        for w in (layer.w1, layer.w2):
            w.copy_(dense_init(generator, w.shape, cfg.param_dtype,
                               device=model.device))
    model.head_w.copy_(dense_init(generator, model.head_w.shape,
                                  cfg.param_dtype, device=model.device))
    model.head_b.zero_()
    return model


def _gather_scatter(x: torch.Tensor, rows_from: torch.Tensor,
                    rows_to: torch.Tensor, emask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """segment_sum(x[rows_from] * emask[:, None], rows_to, n), in x's
    dtype: the masked rows made once, in place on the gather."""
    rows = x.index_select(0, rows_from)
    rows.mul_(emask.to(rows.dtype)[:, None])
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows_to, rows)


class _Aggregate(torch.autograd.Function):
    """`apply(table, src, dst, emask, n)`: segment_sum(table[src] *
    emask[:, None], dst, num_segments=n) in table's dtype, the message
    passing under autograd.  Its backward is its transpose, the gather of
    the output gradient at the destinations, masked, added at the
    sources.  It keeps only the edge index and mask (autograd through
    `index_add_` would keep the [E, d] masked rows of every layer: 15.8
    GB a layer at ogb_products)."""

    @staticmethod
    def forward(ctx, table, src, dst, emask, n):
        ctx.save_for_backward(src, dst, emask)
        ctx.rows = table.shape[0]
        return _gather_scatter(table, src, dst, emask, n)

    @staticmethod
    def backward(ctx, grad):
        src, dst, emask = ctx.saved_tensors
        d_table = None
        if ctx.needs_input_grad[0]:
            d_table = _gather_scatter(grad.contiguous(), dst, src, emask,
                                      ctx.rows)
        return d_table, None, None, None, None


def _mlp(layer: GINLayer, h: torch.Tensor, msg: torch.Tensor,
         dt) -> torch.Tensor:
    z = (1.0 + layer.eps).to(dt) * h + msg
    z = torch.relu(z @ layer.w1.to(dt) + layer.b1.to(dt))
    return torch.relu(z @ layer.w2.to(dt) + layer.b2.to(dt))


def forward(model: GIN, batch: dict) -> torch.Tensor:
    """batch: nodes [N, F], src [E], dst [E], edge_mask [E] bool, and for
    the readout graph_id [N], node_mask [N] bool and n_graphs (a Python
    int, or a 0-d tensor read on the host).

    Returns float32 logits: [N, C] (node) or [G, C] (graph readout)."""
    cfg = model.cfg
    dt = cfg.dtype
    h = batch["nodes"].to(dt)
    src, dst, emask = batch["src"], batch["dst"], batch["edge_mask"]
    N = h.shape[0]
    for layer in model.layers:
        if cfg.message_dtype:
            hm = h.to(cfg.message_dtype)
            msg = _Aggregate.apply(hm, src, dst, emask, N).to(dt)
        else:
            msg = _Aggregate.apply(h, src, dst, emask, N)
        h = _mlp(layer, h, msg, dt)
    if cfg.graph_readout:
        G = int(batch["n_graphs"])
        pooled = torch.zeros((G, h.shape[1]), dtype=dt, device=h.device)
        h = pooled.index_add_(0, batch["graph_id"],
                              h * batch["node_mask"].to(dt)[:, None])
    logits = h @ model.head_w.to(dt) + model.head_b.to(dt)
    return logits.float()


def _nll_and_hits(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
    """Per-row masked NLL and masked top-1 hits of float32 logits."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1,
                        torch.clamp(labels, min=0).long()[:, None])[:, 0]
    hits = (logits.argmax(-1) == labels).float() * mask
    return (logz - gold) * mask, hits


def loss_fn(model: GIN, batch: dict):
    """(loss, {"acc"}): the mean NLL over the rows label_mask selects
    (nodes, or graphs with the readout; e.g. a minibatch's seeds)."""
    logits = forward(model, batch)
    mask = batch["label_mask"].float()
    nll, hits = _nll_and_hits(logits, batch["labels"], mask)
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom, {"acc": hits.sum() / denom}


# ---------------------------------------------------------------------------
# halo-exchange variant: one rank per node shard
# ---------------------------------------------------------------------------
#
# Locality-aware partition: nodes are split into contiguous shards (cluster-
# sorted, so most edges are intra-shard); each layer exchanges ONLY the
# boundary rows other shards reference, in message_dtype, via one
# all_gather of [n_shards, B, d].  Edge sources index [local || boundary].

def halo_layer(h, layer: GINLayer, src_local, dst, emask, send_idx, group,
               dt, msg_dt):
    """h: [Nl, d]; send_idx: [B] local rows contributed to the exchange
    (-1: an empty slot, sent as zeros)."""
    sends = (h * 1.0).to(msg_dt)[torch.clamp(send_idx, min=0)]
    sends = sends * (send_idx >= 0).to(msg_dt)[:, None]
    bnd = collectives.all_gather(sends, group)             # [S, B, d]
    table = torch.cat([h.to(msg_dt), bnd.reshape(-1, h.shape[1])], dim=0)
    msg = _Aggregate.apply(table, src_local, dst, emask,
                           h.shape[0]).to(dt)
    return _mlp(layer, h, msg, dt)


def halo_loss_fn(model: GIN, shard: dict, group=None):
    """This rank's loss of the halo-exchange GIN over `group` (one rank
    per shard).  `shard` holds this rank's block of `partition_for_halo`'s
    arrays, with a leading singleton: nodes [1, Nl, F], src/dst/edge_mask
    [1, El], send_idx [1, B], labels/label_mask [1, Nl].  Returns (loss,
    {"acc"}), the same on every rank: the NLL summed over every shard's
    labelled nodes over their count.  Each rank's parameter gradient is its
    share; the ranks' gradients sum to the dense loss's."""
    cfg = model.cfg
    dt = cfg.dtype
    msg_dt = cfg.message_dtype or dt
    h = shard["nodes"][0].to(dt)
    for layer in model.layers:
        h = halo_layer(h, layer, shard["src"][0], shard["dst"][0],
                       shard["edge_mask"][0], shard["send_idx"][0], group,
                       dt, msg_dt)
    logits = (h @ model.head_w.to(dt) + model.head_b.to(dt)).float()
    mask = shard["label_mask"][0].float()
    nll, hits = _nll_and_hits(logits, shard["labels"][0], mask)
    denom = torch.clamp(collectives.all_reduce_sum(mask.sum(), group), min=1.0)
    loss = collectives.psum(nll.sum(), group) / denom
    acc = collectives.all_reduce_sum(hits.sum(), group) / denom
    return loss, {"acc": acc}


# ---------------------------------------------------------------------------
# edge-partitioned variant: rows and edges split over every rank
# ---------------------------------------------------------------------------

def edge_partitioned_loss_fn(model: GIN, shard: dict, group=None,
                             n_graphs=None):
    """This rank's share of the loss of the edge-partitioned GIN over
    `group` (the reference's SPMD `loss_fn` with `gin_batch_specs`: rows
    and edges split over all axes).  `shard`: this rank's contiguous
    blocks of nodes [N/n, F], labels / label_mask / node_mask [N/n] (or
    [n_graphs] whole, the readout's labels), graph_id [N/n], and of src /
    dst / edge_mask [E/n] (global node ids).  Each layer gathers the node
    rows whole, adds this rank's edges' messages into [N, d] and
    reduce-scatters the sums to their owners.  Returns (share, {"acc"}):
    the shares of the ranks sum to the whole graph's mean NLL, so each
    rank's gradient is its share of the whole loss's (the caller sums
    the gradients over the group); acc is the whole batch's."""
    from repro_torch.dist.collectives import gather_dim, scatter_sum_dim, \
        sum_over
    cfg = model.cfg
    dt = cfg.dtype
    msg_dt = cfg.message_dtype or dt
    h = shard["nodes"].to(dt)
    src, dst, emask = shard["src"].long(), shard["dst"].long(), \
        shard["edge_mask"]
    for layer in model.layers:
        table = gather_dim(h.to(msg_dt), 0, group)
        part = _Aggregate.apply(table, src, dst, emask, table.shape[0])
        msg = scatter_sum_dim(part, 0, group).to(dt)
        h = _mlp(layer, h, msg, dt)
    labels, mask = shard["labels"], shard["label_mask"]
    if cfg.graph_readout:
        G = int(n_graphs)
        pooled = torch.zeros((G, h.shape[1]), dtype=dt, device=h.device)
        pooled = pooled.index_add(0, shard["graph_id"].long(),
                                  h * shard["node_mask"].to(dt)[:, None])
        h = sum_over(pooled, group)
        n, r = _group_size(group), _group_rank(group)
        k = labels.shape[0]
        if k == G:              # labels whole: this rank takes its graphs
            k = -(-G // n)
            lo, hi = min(r * k, G), min(r * k + k, G)
            labels, mask = labels[lo:hi], mask[lo:hi]
        else:                   # labels split: this rank's block of graphs
            lo, hi = r * k, r * k + k
        h = h[lo:hi]
    logits = (h @ model.head_w.to(dt) + model.head_b.to(dt)).float()
    mask = mask.float()
    nll, hits = _nll_and_hits(logits, labels, mask)
    denom = torch.clamp(sum_over(mask.sum(), group).detach(), min=1.0)
    acc = sum_over(hits.sum(), group).detach() / denom
    return nll.sum() / denom, {"acc": acc}


def _group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _group_rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group) if dist.is_initialized() else 0
