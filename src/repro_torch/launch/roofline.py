"""Roofline accounting of the dry-run (launch/dryrun.py) on H100 meshes.

The port's own copy of what the reference's dry-run takes from
benchmarks/roofline.py: the analytic model flops per family (copied from
its `lm_model_flops`, `gnn_model_flops`, `recsys_model_flops`,
`search_model_bytes` and `model_flops_for`) and `roofline_terms`, with the
constants of an H100 SXM instead of a TPU's, and a collective term per
link class instead of one link:

    compute    = sum over operand types of their flops per device / the
                 type's peak: bf16 and fp16 989e12 (tensor cores, dense),
                 TF32 495e12 (float32 products that run with TF32 allowed,
                 as the port's `exact_f32_products` runs its float32
                 products of bf16 values), float32 67e12 (outside the
                 tensor cores: every other float32 op)
    memory     = bytes per device / 3.35e12         (HBM3)
    collective = sum over mesh axes of that axis's collective bytes per
                 device / the axis's link rate

The "model" axis lies inside one node (8 GPUs over NVLink 4: 450 GB/s
each way per GPU); "data" and "pod" cross nodes, one 400 Gb/s NDR
InfiniBand NIC per GPU (50 GB/s each way), as in a DGX H100.  An
operation over several axes takes the slowest of their links.  A device
"fits" when its peak is at most HBM_BYTES.  The peaks are NVIDIA's data
sheet for the H100 SXM (dense rates, without sparsity, at its 700 W
limit).
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"bfloat16": 989e12,   # per H100 SXM, dense, by operand type
              "float16": 989e12,
              "tf32": 495e12,       # float32 products with TF32 allowed
              "float32": 67e12}     # float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per H100 SXM (HBM3)
HBM_BYTES = 80e9             # device memory of an H100 SXM
LINK_BW = {"model": 450e9,   # NVLink 4, each way per GPU, inside a node
           "data": 50e9,     # one 400 Gb/s NDR NIC per GPU (DGX H100)
           "pod": 50e9}


def link_bw(axes) -> float:
    """The rate of a collective over `axes` (a name or a tuple of names):
    the slowest of their links."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return min(LINK_BW[a] for a in axes)


# ---------------------------------------------------------------------------
# analytic model flops (copied from benchmarks/roofline.py)
# ---------------------------------------------------------------------------

def lm_model_flops(meta: dict, kind: str) -> float:
    Np = meta["active_params"]
    B, S, Lr = meta["global_batch"], meta["seq_len"], meta["n_layers"]
    Hq, hd = meta["n_heads"], meta["hd"]
    if kind == "train":
        dense = 6.0 * Np * B * S
        attn = 3 * 2.0 * B * S * S * Hq * hd * Lr   # causal half, fwd+bwd(2x)
        return dense + attn
    if kind == "prefill":
        return 2.0 * Np * B * S + 2.0 * B * S * S * Hq * hd * Lr
    # decode: one token
    return 2.0 * Np * B + 4.0 * B * S * Hq * hd * Lr


def gnn_model_flops(meta: dict) -> float:
    N, E = meta["n_nodes"], meta["n_edges"]
    d, L, f = meta["d_hidden"], meta["n_layers"], meta["d_feat"]
    agg = 2.0 * E * d * L
    mlp = 2.0 * N * (f * d + d * d) + (L - 1) * 2.0 * N * (d * d * 2)
    return 3.0 * (agg + mlp)     # train fwd+bwd


def recsys_model_flops(meta: dict, kind: str) -> float:
    B = meta.get("n_candidates", meta["batch"]) if kind == "retrieval" \
        else meta["batch"]
    d, F = meta["embed_dim"], meta["n_fields"]
    model = meta["model"]
    if model == "fm":
        core = 4.0 * B * F * d
    elif model == "autoint":
        core = B * (3 * 2.0 * F * d * 64 + 4.0 * F * F * 64) * 3
    elif model == "bst":
        core = B * (21 * (4 * 2.0 * 32 * 32 + 2 * 2.0 * 32 * 128)
                    + 4.0 * 21 * 21 * 32) + B * 2.0 * 1500 * 1000
    else:  # mind
        core = B * 3 * (2.0 * 50 * d * d + 4.0 * 4 * 50 * d)
    mult = 3.0 if kind == "train" else 1.0
    return core * mult


def search_model_bytes(meta: dict) -> float:
    """The search step is memory-bound: useful bytes = postings streamed
    (~5.2 B a packed posting plus its near-stop slots)."""
    Q, G, Pp = meta["queries"], meta["groups"], meta["postings_pad"]
    per_shard = Q * G * Pp * 5.2 + Q * meta.get("ns_k", 20) * Pp * 4
    return float(per_shard * meta["n_shards"])


def model_flops_for(cell_meta: dict, family: str, kind: str) -> float:
    if family == "lm":
        return lm_model_flops(cell_meta, kind)
    if family == "gnn":
        return gnn_model_flops(cell_meta)
    if family == "recsys":
        return recsys_model_flops(cell_meta, kind)
    if family == "search":
        # compare+search ops over the gathered postings (small by design)
        Q, G, Pp = (cell_meta["queries"], cell_meta["groups"],
                    cell_meta["postings_pad"])
        return float(Q * (G - 1) * Pp * 2 * max(math.log2(Pp), 1)
                     * cell_meta["n_shards"])
    return 0.0


# ---------------------------------------------------------------------------

def roofline_terms(flops_by_type: dict, bytes_per_dev: float,
                   coll_bytes_by_axes: dict, chips: int) -> dict:
    """The three terms of one step on `chips` devices, per device.
    `flops_by_type` maps an operand type (a key of PEAK_FLOPS; another
    type counts at the float32 rate) to its flops per device, each timed
    at its peak.  `coll_bytes_by_axes` maps the axes of a collective
    ("model", "data", ("pod", "data"), ...: a name or a tuple) to its
    bytes per device; each is timed at `link_bw` of its axes and the
    collective term is their sum."""
    flops_per_dev = sum(flops_by_type.values())
    t_c = sum(n / PEAK_FLOPS.get(k, PEAK_FLOPS["float32"])
              for k, n in flops_by_type.items())
    t_m = bytes_per_dev / HBM_BW
    per_link = {}
    for axes, nbytes in coll_bytes_by_axes.items():
        key = axes if isinstance(axes, str) else "+".join(axes)
        per_link[key] = nbytes / link_bw(axes)
    t_l = sum(per_link.values())
    coll = sum(coll_bytes_by_axes.values())
    dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))
    return {"hlo_flops_global": flops_per_dev * chips,
            "hlo_bytes_global": bytes_per_dev * chips,
            "collective_bytes_global": coll * chips,
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_l,
            "t_collective_by_link_s": per_link,
            "dominant": dom[1], "t_dominant_s": dom[0]}
