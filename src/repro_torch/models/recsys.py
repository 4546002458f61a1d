"""RecSys architectures over a shared sparse-embedding substrate: the port
of src/repro/models/recsys.py, serving and training (`loss_fn`).

fm      — Factorization Machine (Rendle ICDM'10): O(nk) sum-square trick.
autoint — self-attention over field embeddings (arXiv:1810.11921).
bst     — Behavior Sequence Transformer (arXiv:1905.06874).
mind    — Multi-Interest Network with Dynamic (capsule) Routing
          (arXiv:1904.08030): B2I routing -> K interest capsules,
          label-aware attention for training, max-dot for retrieval.

Substrate: all categorical fields share ONE concatenated embedding table
([table_rows, dim]) with per-field row offsets.  Lookups are
`index_select`; FM's two bag reductions (the field embeddings' sum and the
linear term) go through `kernels.ops.segment_bag`, the hand-written
embedding-bag kernel on the card, as the reference module's docstring
says bag reductions do; under autograd the kernel runs inside
`ops.SegmentBagFn`, whose backward is the scatter-add of the reference's
gradient of `take`.  Everything else is plain tensor code, as it is jnp
outside any Pallas kernel in the reference.

`RecSysModel` holds the parameters under the reference dict's names
(`table`, `w_lin`, `attn.{i}.wq`, `blocks.{i}.ff1`, `mlp.{i}.w`,
`head_w`, ...), stored in `param_dtype` and cast to `dtype` at use as the
reference does, made without `requires_grad` (the training step turns it
on); the forwards are plain functions of the model.  Products
the reference asks in float32 (`preferred_element_type`) take float32
operands here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    model: str                       # fm | autoint | bst | mind
    field_vocabs: tuple              # rows per categorical field
    embed_dim: int
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # bst
    seq_len: int = 20
    n_blocks: int = 1
    bst_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    item_vocab: int = 1_000_000      # bst/mind behavior item vocabulary
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.field_vocabs)

    @property
    def total_rows(self) -> int:
        return int(sum(self.field_vocabs))

    @property
    def table_rows(self) -> int:
        """Rows padded to 256, as the reference's (which row-shards them)."""
        return ((self.total_rows + 255) // 256) * 256

    def field_offsets(self, device=None) -> torch.Tensor:
        """int64 [n_fields]: the first table row of each field."""
        off = torch.zeros(self.n_fields, dtype=torch.int64, device=device)
        off[1:] = torch.tensor(self.field_vocabs[:-1],
                               dtype=torch.int64).cumsum(0).to(off.device)
        return off

    def param_count(self) -> int:
        n = self.total_rows * self.embed_dim
        if self.model == "fm":
            n += self.total_rows + 1
        if self.model in ("bst", "mind"):
            n += self.item_vocab * self.embed_dim
        return n


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Params(nn.Module):
    """A named group of parameters: one AutoInt layer, BST block or MLP
    layer of the reference's lists."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, dtype, device))


class RecSysModel(nn.Module):
    """The parameters of one recsys model, created uninitialised on
    `device` (the card unless the caller asks for the CPU); `init_params`
    or `carry.recsys_params_from_reference` fill them."""

    def __init__(self, cfg: RecSysConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        pd, d = cfg.param_dtype, cfg.embed_dim

        def p(*shape):
            return _param(shape, pd, device)

        self.table = p(cfg.table_rows, d)
        if cfg.model == "fm":
            self.w_lin = p(cfg.table_rows, 1)
            self.b = p()
        elif cfg.model == "autoint":
            layers, d_in = [], d
            for _ in range(cfg.n_attn_layers):
                h = cfg.n_heads * cfg.d_attn
                layers.append(_Params({k: (d_in, h) for k in
                                       ("wq", "wk", "wv", "wres")}, pd, device))
                d_in = h
            self.attn = nn.ModuleList(layers)
            self.head_w = p(cfg.n_fields * d_in, 1)
            self.head_b = p()
        elif cfg.model == "bst":
            self.item_table = p(cfg.item_vocab, d)
            self.pos_embed = p(cfg.seq_len + 1, d)
            self.blocks = nn.ModuleList(_Params({
                "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                "ln1": (d,), "ln2": (d,), "ff1": (d, 4 * d),
                "ff2": (4 * d, d)}, pd, device) for _ in range(cfg.n_blocks))
            dims = ((cfg.seq_len + 1) * d + cfg.n_fields * d,) + cfg.mlp_dims
            self.mlp = nn.ModuleList(
                _Params({"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)},
                        pd, device) for i in range(len(cfg.mlp_dims)))
            self.head_w = p(cfg.mlp_dims[-1], 1)
            self.head_b = p()
        elif cfg.model == "mind":
            self.item_table = p(cfg.item_vocab, d)
            self.s_matrix = p(d, d)       # B2I shared bilinear map
            self.out_w = p(d, d)          # interest transform
        else:
            raise ValueError(cfg.model)
        self.register_buffer("offsets", cfg.field_offsets(device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.table.device


@torch.no_grad()
def init_params(cfg: RecSysConfig, generator: torch.Generator,
                device=None) -> RecSysModel:
    """A model with the reference's initial scales (`init_params`): tables
    and positions N(0, 0.01), weight matrices N(0, fan_in ** -0.5), norm
    scales 1, biases 0; drawn tensor by tensor from `generator` (a
    generator on `device`) on `device`."""
    model = RecSysModel(cfg, device)
    small = {"table", "w_lin", "item_table", "pos_embed"}
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2"):
            w.fill_(1)
        elif w.dim() < 2:                 # b, head_b, mlp.{i}.b
            w.zero_()
        else:
            w.copy_(dense_init(generator, w.shape, cfg.param_dtype,
                               scale=0.01 if leaf in small else None,
                               device=model.device))
    return model


# ---------------------------------------------------------------------------
# shared substrate
# ---------------------------------------------------------------------------

def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table rows at idx [...] -> [..., D] (`jnp.take(table, idx, axis=0)`
    for in-range idx)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        *idx.shape, table.shape[1])


def _rows(model: RecSysModel, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F] per-field local ids -> int64 rows of the one big table."""
    return ids.long() + model.offsets[None, :]


def field_embed(model: RecSysModel, ids: torch.Tensor) -> torch.Tensor:
    """ids: [B, F] per-field local ids -> [B, F, d]."""
    return _take(model.table, _rows(model, ids))


def _ln(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


# ---------------------------------------------------------------------------
# model forwards: logits for CTR models, (interests, item_emb) for mind
# ---------------------------------------------------------------------------

def fm_forward(model: RecSysModel, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F] -> float32 logits [B].  The sum of the field embeddings
    and the linear term are bag sums (the embedding-bag kernel on the
    card); the square term gathers the rows themselves."""
    dt = model.cfg.dtype
    rows = _rows(model, ids)
    v = _take(model.table, rows).to(dt)                        # [B, F, d]
    lin = ops.segment_bag(model.w_lin, rows)[:, 0].to(dt)      # [B]
    s = ops.segment_bag(model.table, rows).to(dt)              # [B, d]
    pair = 0.5 * (s * s - (v * v).sum(dim=1)).sum(-1)          # sum-square trick
    return (model.b.to(dt) + lin + pair).float()


def autoint_forward(model: RecSysModel, ids: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    dt = cfg.dtype
    x = field_embed(model, ids).to(dt)                         # [B, F, d]
    B, nf, _ = x.shape
    H, da = cfg.n_heads, cfg.d_attn
    for lp in model.attn:
        q = (x @ lp.wq.to(dt)).reshape(B, nf, H, da)
        k = (x @ lp.wk.to(dt)).reshape(B, nf, H, da)
        v = (x @ lp.wv.to(dt)).reshape(B, nf, H, da)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                       k.float()), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a.to(dt), v).reshape(B, nf, H * da)
        x = torch.relu(o + x @ lp.wres.to(dt))
    flat = x.reshape(B, -1)
    return ((flat @ model.head_w.to(dt))[:, 0]
            + model.head_b.to(dt)).float()


def bst_forward(model: RecSysModel, ids: torch.Tensor, hist: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """ids: [B, F] profile fields; hist: [B, S] item ids (-1 pad); target: [B]."""
    cfg = model.cfg
    dt, d = cfg.dtype, cfg.embed_dim
    B, S = hist.shape
    seq_ids = torch.cat([hist, target[:, None]], dim=1)            # [B, S+1]
    valid = seq_ids >= 0
    seq = _take(model.item_table, seq_ids.clamp(min=0)).to(dt)
    seq = seq * valid[..., None].to(dt) + model.pos_embed.to(dt)[None]
    nh = cfg.bst_heads
    hd = d // nh
    for bp in model.blocks:
        h = _ln(seq, bp.ln1.to(dt))
        q = (h @ bp.wq.to(dt)).reshape(B, S + 1, nh, hd)
        k = (h @ bp.wk.to(dt)).reshape(B, S + 1, nh, hd)
        v = (h @ bp.wv.to(dt)).reshape(B, S + 1, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) / (hd ** 0.5)
        logits = torch.where(valid[:, None, None, :], logits, -1e30)
        a = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S + 1, d)
        seq = seq + o @ bp.wo.to(dt)
        h = _ln(seq, bp.ln2.to(dt))
        seq = seq + torch.relu(h @ bp.ff1.to(dt)) @ bp.ff2.to(dt)
    other = field_embed(model, ids).to(dt).reshape(B, -1)
    x = torch.cat([seq.reshape(B, -1), other], dim=-1)
    for m in model.mlp:
        x = F.leaky_relu(x @ m.w.to(dt) + m.b.to(dt), 0.01)
    return ((x @ model.head_w.to(dt))[:, 0]
            + model.head_b.to(dt)).float()


def mind_interests(model: RecSysModel, hist: torch.Tensor) -> torch.Tensor:
    """Dynamic (B2I) capsule routing: hist [B, S] -> interests [B, K, d]."""
    cfg = model.cfg
    dt = cfg.dtype
    B, S = hist.shape
    K = cfg.n_interests
    valid = hist >= 0
    e = _take(model.item_table, hist.clamp(min=0)).to(dt)
    e = e * valid[..., None].to(dt)
    u = e @ model.s_matrix.to(dt)                                  # behavior caps
    # routing logits b_ks: zeros, then iterate (the reference's choice)
    blog = torch.zeros((B, K, S), dtype=torch.float32, device=hist.device)
    interests = torch.zeros((B, K, cfg.embed_dim), dtype=dt,
                            device=hist.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(valid[:, None, :], blog, -1e30), dim=1)
        z = torch.einsum("bks,bsd->bkd", w.to(dt), u)              # [B, K, d]
        # squash
        n2 = z.float().square().sum(-1, keepdim=True)
        interests = z * (n2 / (1 + n2) / torch.sqrt(n2 + 1e-9)).to(dt)
        blog = blog + torch.einsum("bkd,bsd->bks", interests.float(),
                                   u.float())
    return torch.einsum("bkd,de->bke", interests, model.out_w.to(dt))


def mind_train_logits(model: RecSysModel, hist: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Label-aware attention + in-batch sampled softmax logits [B, B]."""
    dt = model.cfg.dtype
    interests = mind_interests(model, hist)                        # [B, K, d]
    tgt = _take(model.item_table, target.clamp(min=0)).to(dt)
    att = torch.softmax(torch.einsum("bkd,bd->bk", interests.float(),
                                     tgt.float()) * 2.0, dim=-1)   # pow~2
    user = torch.einsum("bk,bkd->bd", att.to(dt), interests)       # [B, d]
    return torch.einsum("bd,cd->bc", user.float(), tgt.float())


def mind_retrieval_scores(model: RecSysModel, hist: torch.Tensor,
                          cand: torch.Tensor) -> torch.Tensor:
    """hist [B, S]; cand [C] -> scores [B, C] = max over interests."""
    interests = mind_interests(model, hist)
    ce = _take(model.item_table, cand).to(model.cfg.dtype)
    s = torch.einsum("bkd,cd->bkc", interests.float(), ce.float())
    return s.amax(dim=1)


# ---------------------------------------------------------------------------
# train loss / serve / retrieval
# ---------------------------------------------------------------------------

def loss_fn(model: RecSysModel, batch: dict):
    """(loss, metrics), the reference's `loss_fn`: MIND's in-batch softmax
    over `mind_train_logits` (target b is row b's label) with its top-1
    accuracy `acc`; the CTR models' numerically stable binary cross
    entropy on `label` with `auc_proxy`, the Pearson correlation of
    sigmoid(logit) and the label (`jnp.corrcoef`)."""
    if model.cfg.model == "mind":
        logits = mind_train_logits(model, batch["hist"], batch["target"])
        labels = torch.arange(logits.shape[0], device=logits.device)
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, 1, labels[:, None])[:, 0]
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll.mean(), {"acc": acc}
    logit = serve_scores(model, batch)
    y = batch["label"].float()
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
    auc = torch.corrcoef(torch.stack([torch.sigmoid(logit), y]))[0, 1]
    return loss, {"auc_proxy": auc}


def serve_scores(model: RecSysModel, batch: dict) -> torch.Tensor:
    """float32 [B]: CTR logits, or MIND's label-aware score of the target
    (the diagonal of its [B, B] in-batch logits, as the reference)."""
    kind = model.cfg.model
    if kind == "fm":
        return fm_forward(model, batch["ids"])
    if kind == "autoint":
        return autoint_forward(model, batch["ids"])
    if kind == "bst":
        return bst_forward(model, batch["ids"], batch["hist"], batch["target"])
    if kind == "mind":
        return mind_train_logits(model, batch["hist"],
                                 batch["target"]).diagonal()
    raise ValueError(kind)


def retrieval_scores(model: RecSysModel, batch: dict) -> torch.Tensor:
    """Score n_candidates items for one (or few) users -> [B, C] fp32."""
    cfg = model.cfg
    cand = batch["cand"]                                   # [C]
    if cfg.model == "mind":
        return mind_retrieval_scores(model, batch["hist"], cand)
    C = cand.shape[0]
    if cfg.model in ("fm", "autoint"):
        # vary the last categorical field over the candidates
        ids = batch["ids"]                                 # [B, F]
        B, nf = ids.shape
        idsC = ids[:, None, :].expand(B, C, nf).clone()
        idsC[:, :, -1] = (cand % cfg.field_vocabs[-1]).to(ids.dtype)[None, :]
        f = fm_forward if cfg.model == "fm" else autoint_forward
        return f(model, idsC.reshape(B * C, nf)).reshape(B, C)
    if cfg.model == "bst":
        ids, hist = batch["ids"], batch["hist"]
        B = ids.shape[0]
        idsC = ids[:, None, :].expand(B, C, ids.shape[1]).reshape(B * C, -1)
        histC = hist[:, None, :].expand(B, C, hist.shape[1]).reshape(B * C, -1)
        tgtC = cand[None, :].expand(B, C).reshape(B * C)
        return bst_forward(model, idsC, histC, tgtC).reshape(B, C)
    raise ValueError(cfg.model)
