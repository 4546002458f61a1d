"""Graph generation + fanout neighbor sampling (GraphSAGE-style).

The port's own copy of src/repro/data/graph_data.py, pure numpy: on the
same seeds every array equals the reference's bit for bit.  The generator
builds homophilous cluster graphs (labels = clusters, features = noisy
prototypes, edges mostly intra-cluster) so GIN training actually learns;
the sampler produces fixed-shape padded subgraphs; `partition_for_halo`
lays a graph out for the halo-exchange GIN (`models/gnn.py`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphData:
    features: np.ndarray     # [N, F] float32
    labels: np.ndarray       # [N] int32
    src: np.ndarray          # [E] int32 (directed; both directions present)
    dst: np.ndarray          # [E] int32
    adj_offsets: np.ndarray  # [N + 1] CSR over dst-sorted edges
    adj_nbrs: np.ndarray     # [E] neighbor ids (sources) per node

    @property
    def n_nodes(self) -> int:
        return len(self.features)

    @property
    def n_edges(self) -> int:
        return len(self.src)


def generate_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                   homophily: float = 0.85, seed: int = 0) -> GraphData:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    protos = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = protos[labels] + 0.8 * rng.normal(size=(n_nodes, d_feat)).astype(np.float32)

    m = n_edges // 2
    u = rng.integers(0, n_nodes, m)
    same = rng.random(m) < homophily
    # intra-cluster partner: random node of the same label (via per-label pools)
    order = np.argsort(labels, kind="stable")
    label_sorted = labels[order]
    starts = np.searchsorted(label_sorted, np.arange(n_classes))
    ends = np.searchsorted(label_sorted, np.arange(n_classes), side="right")
    lu = labels[u]
    span = np.maximum(ends[lu] - starts[lu], 1)
    v_same = order[starts[lu] + rng.integers(0, 1 << 62, m) % span]
    v_rand = rng.integers(0, n_nodes, m)
    v = np.where(same, v_same, v_rand).astype(np.int32)
    keep = u != v
    u, v = u[keep].astype(np.int32), v[keep]

    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    adj_offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=adj_offsets[1:])
    return GraphData(features=feats, labels=labels, src=src, dst=dst,
                     adj_offsets=adj_offsets, adj_nbrs=src)


def full_graph_batch(g: GraphData, train_frac: float = 0.6, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = rng.random(g.n_nodes) < train_frac
    return {
        "nodes": g.features,
        "src": g.src, "dst": g.dst,
        "edge_mask": np.ones(g.n_edges, bool),
        "labels": g.labels,
        "label_mask": mask,
        "node_mask": np.ones(g.n_nodes, bool),
    }


def sample_subgraph(g: GraphData, seeds: np.ndarray, fanouts: tuple,
                    rng: np.random.Generator) -> dict:
    """Fanout-sampled padded subgraph.  Local node order: seeds first, then
    each hop's sampled frontier (with duplicates merged).  Edges point
    sampled-neighbor -> target, both endpoints local."""
    max_nodes = len(seeds)
    f_prod = 1
    for f in fanouts:
        f_prod *= f
        max_nodes += len(seeds) * f_prod
    max_edges = max_nodes - len(seeds)

    local = {int(s): i for i, s in enumerate(seeds)}
    nodes = list(seeds)
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for t in frontier:
            lo, hi = g.adj_offsets[t], g.adj_offsets[t + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = rng.integers(0, deg, size=min(f, int(deg)))
            for j in np.unique(take):
                nbr = int(g.adj_nbrs[lo + j])
                if nbr not in local:
                    local[nbr] = len(nodes)
                    nodes.append(nbr)
                src_l.append(local[nbr])
                dst_l.append(local[t])
                nxt.append(nbr)
        frontier = nxt
    n, e = len(nodes), len(src_l)
    nodes_arr = np.asarray(nodes, dtype=np.int64)
    feats = np.zeros((max_nodes, g.features.shape[1]), np.float32)
    feats[:n] = g.features[nodes_arr]
    src = np.zeros(max_edges, np.int32)
    dst = np.zeros(max_edges, np.int32)
    src[:e], dst[:e] = src_l, dst_l
    emask = np.zeros(max_edges, bool)
    emask[:e] = True
    labels = np.zeros(max_nodes, np.int32)
    labels[:n] = g.labels[nodes_arr]
    lmask = np.zeros(max_nodes, bool)
    lmask[: len(seeds)] = True          # supervise seeds only
    nmask = np.zeros(max_nodes, bool)
    nmask[:n] = True
    return {"nodes": feats, "src": src, "dst": dst, "edge_mask": emask,
            "labels": labels, "label_mask": lmask, "node_mask": nmask}


def partition_for_halo(g: GraphData, n_shards: int,
                       order_by_label: bool = True) -> dict:
    """Locality-aware partition for the halo-exchange GIN.

    Nodes are relabeled (cluster/label-sorted) and split into contiguous
    shards; each edge is assigned to its dst's shard; sources outside the
    shard go through the boundary exchange.  Returns stacked padded arrays
    (leading dim = n_shards) + the measured edge-cut fraction.
    """
    N = g.n_nodes
    order = np.argsort(g.labels, kind="stable") if order_by_label \
        else np.arange(N)
    new_id = np.empty(N, np.int64)
    new_id[order] = np.arange(N)
    Nl = (N + n_shards - 1) // n_shards
    src = new_id[g.src]
    dst = new_id[g.dst]
    shard_of = dst // Nl
    cut = float((src // Nl != dst // Nl).mean())

    El = int(np.bincount(shard_of, minlength=n_shards).max())
    # per-shard boundary lists: remote sources needed, deduped
    feats = np.zeros((n_shards, Nl, g.features.shape[1]), np.float32)
    labels = np.zeros((n_shards, Nl), np.int32)
    lmask = np.zeros((n_shards, Nl), bool)
    srcs = np.zeros((n_shards, El), np.int32)
    dsts = np.zeros((n_shards, El), np.int32)
    emask = np.zeros((n_shards, El), bool)
    halos = []
    feats_sorted = g.features[order]
    labels_sorted = g.labels[order]
    for s in range(n_shards):
        lo, hi = s * Nl, min((s + 1) * Nl, N)
        feats[s, : hi - lo] = feats_sorted[lo:hi]
        labels[s, : hi - lo] = labels_sorted[lo:hi]
        lmask[s, : hi - lo] = True
        esel = np.nonzero(shard_of == s)[0]
        e_src, e_dst = src[esel], dst[esel] - lo
        remote = e_src[(e_src < lo) | (e_src >= hi)]
        halo_nodes = np.unique(remote)
        halos.append(halo_nodes)
        srcs[s, : len(esel)] = 0   # filled after B is known
        dsts[s, : len(esel)] = e_dst
        emask[s, : len(esel)] = True
    B = max(int(max((len(h) for h in halos), default=1)), 1)
    send_idx = np.full((n_shards, B), -1, np.int32)
    # shard s needs halo_nodes; the OWNER shard must send them.  Build the
    # global boundary table as the union per owner, then point edge sources
    # at [local || all_gather(sends)] positions.
    need_by_owner: list[set] = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        for nid in halos[s]:
            need_by_owner[int(nid // Nl)].add(int(nid))
    slot_of = {}
    for o in range(n_shards):
        rows = sorted(need_by_owner[o])[:B]
        for j, nid in enumerate(rows):
            send_idx[o, j] = nid - o * Nl
            slot_of[nid] = o * B + j
    for s in range(n_shards):
        lo, hi = s * Nl, min((s + 1) * Nl, N)
        esel = np.nonzero(shard_of == s)[0]
        e_src = src[esel]
        local = (e_src >= lo) & (e_src < hi)
        out = np.where(local, e_src - lo,
                       np.array([slot_of.get(int(x), 0) for x in e_src]) + Nl)
        srcs[s, : len(esel)] = out
        # drop edges whose remote source overflowed the boundary budget
        ok = local | np.array([int(x) in slot_of for x in e_src])
        emask[s, : len(esel)] &= ok
    return {"nodes": feats, "src": srcs, "dst": dsts, "edge_mask": emask,
            "labels": labels, "label_mask": lmask, "send_idx": send_idx,
            "cut_fraction": cut, "n_local": Nl, "boundary": B}


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int = 0) -> dict:
    """Batched disjoint small graphs with graph-level labels (sum readout)."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    glabels = rng.integers(0, n_classes, batch).astype(np.int32)
    feats = rng.normal(size=(N, d_feat)).astype(np.float32)
    feats += glabels.repeat(n_nodes)[:, None] * 0.5
    base = np.arange(batch).repeat(n_edges) * n_nodes
    src = (rng.integers(0, n_nodes, E) + base).astype(np.int32)
    dst = (rng.integers(0, n_nodes, E) + base).astype(np.int32)
    return {"nodes": feats, "src": src, "dst": dst,
            "edge_mask": np.ones(E, bool),
            "labels": glabels, "label_mask": np.ones(batch, bool),
            "node_mask": np.ones(N, bool),
            "graph_id": np.arange(batch).repeat(n_nodes).astype(np.int32),
            "n_graphs": batch}
