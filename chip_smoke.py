#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--docs N] [--seed S] [--segment-docs D]
                          [--lm-arch A] [--lm-batch B] [--lm-prompt P]
                          [--lm-steps T]
    python3 chip_smoke.py --ab PARENT . . PARENT     # see run_ab
    python3 chip_smoke.py --ab-attention PARENT . . PARENT
                                                     # see run_ab_attention
    python3 chip_smoke.py --ab-kernels PARENT . . PARENT
                                                     # see run_ab_kernels
    (each A/B runs each checkout in a spawned process: see ab_runs)

Phases, each reported on its own lines:

1. device and build — the card's name and power limit (nvidia-smi), then
   every CUDA kernel source in src/repro_torch/kernels/csrc built at once
   (one nvcc per source, in parallel) and its build seconds;
2. index — a corpus of `--docs` documents (default lexicon, mean length
   800 words, seeded) and its additional + ordinary indexes, built on the
   host and moved to the card;
3. kernels — each search kernel against its plain PyTorch version on the
   card, on seeded edge cases (for min delta also the fence's edge cases
   of kernels/edge_cases.py, at row widths whose planned strides reach
   every path of its search; for intersect and delta mask the regime edge
   cases there, at widths that reach the staged row and the fence) and
   on the largest inputs the main path gives it, exact equality required
   (the unpack,
   banded-intersect, min-delta and delta-mask kernels; the delta-mask
   launch on both its outputs, the mask and its window scan against
   `delta_mask_t_bits` of the plain mask); times with CUDA events (L2
   flushed before each launch) beside the least time the card could take
   and a launch floor (a one-element zero_() on the same timer); the
   min-delta, intersect and delta-mask kernels' designs at those inputs
   (regime, fence, window, registers, spills, shared memory);
4. main path — the paper's query stream (phrase + every-other-word near
   queries of 3-5 words) in batches through `AdditionalIndexEngine(...,
   device="cuda").search_batch` and the `OrdinaryEngine` baseline, plus a
   stop-heavy near batch; then, after one warm-up batch each, two ranked
   batches of the paper stream (rank=True, top_k=10), one ranked
   stop-heavy near batch, and two K-word batches (K in {3, 4, 5}, ~10%
   with windows wider than 15 that ride the flexible path; the second
   ranked).  Every response is checked field by field (scores included)
   against the same engine on the CPU (a job per batch in the forked
   workers, one torch thread each);
   the first 16 unranked ones and the
   first 8 of every new batch against the brute-force oracles; all four
   kernels' launch counters must rise in this phase; every intersect and
   delta-mask call of the phase is logged (no copies, no launches) and
   printed as a `kernel_calls` histogram of its b width, a width and band
   and its share of sentinel a entries;
4b. serve tier — `SearchServe` over the same index on a one-rank NCCL
   process group at veretennikov's serve_batch caps (configs/
   veretennikov.py): every batch of phase 4 through `search_batch`, each
   response equal to the additional engine's on the card field by field
   (a ranked response with one score's last bit flipped must be refused),
   the four search kernels' launch counters rising, one all_reduce a step
   and two a ranked step; QPS and batch p50 / p99 per kind beside the
   engine's, the executor's phase split, its slab's live share, the tier
   ladder, the arena's device bytes and peak memory; then the search
   launcher's closed loop (`launch/serve.py --mode search`, unranked and
   `--ranked`);
4c. front door and segments — (a) `FrontDoor(index, device="cuda")` over
   the same index, one shard: every batch of phase 4 through
   `search_batch`, each response SERVED_EXACT and equal to the additional
   engine's field by field (`subplan_pos_hits` too), one batch again from
   the cache; (b) four doc shards with replicas (`build_doc_shards`, a
   host build made while phase 4's CPU check runs in the workers): the
   same batches, equal with `postings_read`, then `ChaosShard` faults on
   a few requests of each kind (primary down with a replica: exact; shard
   dead: degraded to the live doc ranges; shard stalled: degraded, then
   backfilled into the cache; all down: no_shards) and a control (a merge
   that lost a hit is refused); (c) the launcher's open loop (`--qps 50
   --duration 5`, unranked and ranked), then (a)'s shard under Poisson
   arrivals at half the engine's unranked QPS for 10 s (deadline 1000 ms,
   cache off): offered QPS, p50 / p95 / p99, exact / degraded / shed;
   (d) a `SegmentManager` over the first `--segment-docs` documents
   (1000; a cut depth, printed with its reason): the union and the merge
   equal a one-shot engine, the merged index equals the one-shot build
   array by array, and a front over the manager sees a 4th ingest.  Every
   run that injects no fault must be all SERVED_EXACT with no failed or
   re-dispatched shard call, and the four search kernels' counters must
   rise;
5. LM kernels — with the search phases' memory handed back, `--lm-arch`
   (llama3-8b) at full width in bf16 with random weights from --seed; each
   kernel's design at the path's shapes (the decode's split of the cache;
   registers, shared memory and tiles of the compiled kernels); the
   flash-decode and flash-prefill kernels against their plain versions on
   seeded edge cases (kv_len 0, 1, S and odd, one row past a chunk of the
   split, on one, shorter than one beside long rows; S below a tile and
   ragged; G 1, 4, 5, 8; D 32, 64, 128; f32 to 2e-5, bf16 to 5e-2 and to
   one bf16 ulp of each output row's largest value) and at the path's
   real shapes (decode over the
   [B, 32768, 8, 128] cache at kv_len = the prompt, with random rows and
   with needle rows at both ends; prefill on the prompt's first 4096
   positions at batch 1), each check shown to refuse a zeroed output, a
   decode that drops the last row or half the cache and a prefill whose
   mask is one row late; timed beside their bound, plain version and
   `scaled_dot_product_attention`; the flash prefill also at the served
   prompt length beside the chunked attention, and the logits' head;
6. LM main path — `forward_with_cache` on B x P prompt tokens (the chunked
   attention branch), the k/v copied into a 32768-position cache,
   `--lm-steps` greedy `decode_step`s through the flash-decode kernel
   (every layer's attention output within one bf16 ulp of a row's scale
   of the plain version on the same q and cache; exactly layers x steps
   launches), the same steps teacher-forced through the plain version
   (logits equal to 5e-2 at every step), and the flash-prefill kernel on
   every layer's q, k, v of a prefill of the prompt's first 4096 positions
   against that layer's own attention (four bf16 ulps of a row's scale;
   one launch per layer); prefill tokens/s, decode ms per step, peak
   memory; then two more flash steps under torch.profiler: the device's
   busy ms per step, its idle share and the kernels that lead;
6b. MoE serving — with the LM phases' memory handed back, each MoE arch
   at full width in bf16 with random weights from --seed (MOE_RUNS):
   granite-moe-1b-a400m at full depth (4 x 4096 prompt tokens, a
   32768-slot cache, 16 steps) and moonshot-v1-16b-a3b (2 x 1024 prompt
   tokens, 8 steps, at full depth with its cache cut to what the run
   writes, printed with the reason).  Each: the
   flash-decode kernel at the arch's (G, D), G = 2, D = 64 and G = 1, D =
   128, against its plain version on phase 5's edge cases in bf16 and f32
   and at the path's cache (flat and with needle rows), refusing a zeroed
   output and a decode at kv_len - 1, timed beside bound, plain version
   and SDPA, its design printed; then `forward_with_cache`, greedy flash
   `decode_step`s (every layer's attention within one bf16 ulp of a row's
   scale of the plain version; launches = layers x steps) and the same
   steps teacher-forced through the plain attention, each on the cache its
   flash step read: the two passes' routing compared layer by layer (every difference must be a near tie:
   a K-th / (K+1)-th probability gap no wider than the two passes'
   difference; each is printed), the logits within 5e-2 at every (step,
   row) no layer routed differently; the MoE layer on captured prefill and
   decode inputs of its first, middle and last layer against the same
   function on the CPU in float32 from the same bf16 values (routing equal
   but at near ties; outputs within 5e-2 and MOE_LAYER_ULPS of a row's
   scale; a K - 1 experts control refused); prefill tokens/s, decode ms
   per step, the device's busy ms per step under torch.profiler, the
   dispatch's padded share (1 - K/E), peak memory.  Then `serve_lm` of
   both archs on the card: its first 10 tokens equal the CPU's;
7. recsys kernel — with the LM phases' memory handed back, the
   embedding-bag kernel against its plain version on seeded edge cases (D
   1 to 128, B = 1, F = 1, all-pad bags, ids past the table, sum and mean,
   weighted or not, f32 and bf16, the tile edges of
   kernels/edge_cases.py, also on ids off 16-byte boundaries, and a 4.6 GB
   table; exact on unweighted f32 bags, else 2e-5 / one bf16 ulp of a
   row's scale) and at the real shapes, each with its
   tile and compiled resources (FM's
   [5349120, 10] table and [.., 1] linear term with serve_bulk ids, the
   table with the 1,000,000 retrieval rows, MIND's [1000000, 64] item
   table pooling 262144 histories of 50 with ~10% pads, mean and
   weighted), each check shown to refuse a zeroed output, the last field
   dropped and a pad read as row 0; timed beside its bound, plain version
   and `embedding_bag`;
8. recsys main path — FM at full width (random weights from --seed)
   through `recsys_serve_step` at serve_p99 and serve_bulk and
   `recsys_retrieval_step` at retrieval_cand on ClickLog batches: every
   `segment_bag` call held against the plain version on the same inputs
   (exact; launches = calls), scores against the port on the CPU within
   2e-5 at serve_p99 and retrieval, the top 128 equal where the scores are
   apart; then AutoInt, BST and MIND at full width (serve_p99 against the
   CPU, serve_bulk for AutoInt and BST, retrieval: MIND at 1,000,000
   candidates, AutoInt and BST cut to 65,536; MIND's serve_bulk is cut,
   each cut printed with its reason); QPS and step p50 / p99 per shape,
   peak memory;
8b. training — (a) one `loss_fn` + AdamW step of the llama3-8b and
   granite-moe-1b-a400m smoke configs (float32, remat) on the card
   against the same step of the port on the CPU from the same weights and
   `lm_batches` batch: the loss and every gradient within 2e-5 of its
   largest magnitude, AdamW on the card from the CPU's gradients within
   2e-5 of the CPU's new parameters, every routing difference a near tie
   (printed); remat on against off on the card the same way; (b)
   granite-moe-1b-a400m at full width and depth (bf16 compute, float32
   params and AdamW state, remat) at train_4k's sequence, batch cut to 4
   (printed with its reason), 6 steps on one fixed batch: losses, aux and
   grad norms finite, the last loss below the first; step p50, tokens/s,
   MFU (its counts on the line), peak memory and one traced step's device
   busy ms against its wall ms; (c) FM at full width and train_batch, its
   bag sums through the segment-bag kernel under `ops.SegmentBagFn`: the
   first step's loss and gradients against the plain bag under autograd
   on the card (2e-5), 3 AdamW steps with the kernel's launches counted
   (2 a forward), steps/s and examples/s; (d) AutoInt and BST at
   train_batch and MIND at 16384 (cut printed with its reason), 2 steps
   each, finite; (e) `launch/train.py --arch fm --steps 6` with no
   `--device` (the card): finite, 12 bag launches;
8c. data-parallel training and the GIN — on a one-rank NCCL process
   group (the one card; NCCL refuses two ranks on one device): (a) the
   least-squares problem of tests/test_dist.py through
   `make_sharded_train_step` bit for bit equal to `make_train_step` for
   DP_LSQ_STEPS steps, and its int8 run converged (loss < 1e-2 after 150
   steps); FM at full width and train_batch: the dp step's loss,
   gradients and new parameters within 2e-5 of their largest magnitude
   of the one-device step's (the bag backward's atomics; the elements
   whose gradients lie under NEAR_EPS AdamW eps counted and printed:
   AdamW's first update there follows the gradients' last bits), the dp
   step from the one-device step's
   own gradients equal to its update bit for bit, DP_FM_STEPS timed dp
   steps beside phase 8b (c)'s step (all_reduce calls = (leaves + 1) x
   steps), then DP_INT8_STEPS int8 steps: on the last (a nonzero
   residual) every leaf's sum and new residual equal
   dequantize(quantize(g + r)) and x - deq of the plain functions on the
   card, and the same check refuses the sum without the residual; the bag
   kernel's launches in the dp steps counted; (b) gin-tu at full width (5
   layers, d_hidden 64) on every GNN_SHAPES entry: full_graph_sm's
   loss_fn and gradients on the card within 2e-5 of their largest
   magnitude of the port on the CPU from the same weights; molecule (128
   graphs, the readout), ogb_products at full size (2,449,029 nodes,
   61,859,140 edges; step p50, edges/s, peak memory, one traced step) and
   minibatch_lg (3 subgraphs of 1024 seeds at fanout (15, 10) from the
   full 114.6 M-edge graph) GNN_STEPS AdamW steps each: finite, and on
   ogb_products' full graph the last loss below the first;
   the two large graphs are built on the host by
   forked workers started before phase 2; (c) the halo-exchange loss at
   full_graph_sm's shape on the group (`partition_for_halo`, one
   all_gather a layer), forward and backward: within 1e-4 of the dense
   loss, its accuracy equal, its gradients within 1e-4 of their scale;
   (d) `launch/train.py --arch gin-tu --shape molecule --steps 6` with no
   `--device`: finite;
9. dry-run — (a) `python -m repro_torch.launch.dryrun` on
   llama3-8b/train_4k, llama3-8b/decode_32k and veretennikov/serve_batch
   on the single 32 x 8 H100 mesh, a fake-tensor pass of one rank's
   program in a subprocess started in phase 1 (no allocation, no launch);
   (b) rank 0's program of each of those cells run for real on the card
   under the fake process group (`make_production_mesh`: collectives
   return at once; random weights and caches from --seed, tokens in the
   vocabulary, zero arenas and tables): its peak memory above the phase's
   baseline within 10% of the pass's prediction (the prediction without
   the AdamW state refused), its kernel launches equal to the kernel ops
   the pass saw and its collective calls by type to the pass's counts
   (one step), then timed steps beside the pass's roofline terms, then
   one recorded step whose kernels are held against their plain versions
   at the shapes it gave them: every layer's flash-decode output on the
   rank's [4, 32768, 1, 128] random cache (a bf16 ulp of each row's
   scale; attention over half the cache must be refused), the unpack and
   intersect kernels exactly on a random arena and random rows at the
   per-shard shapes of serve_batch;
10. examples — examples/torch_quickstart.py, torch_search_serve.py,
   torch_distributed_search.py (one NCCL rank per card) and
   torch_train_lm.py (300 steps of a ~100M-parameter LM), each a
   subprocess on the card at its default size, all at once: each must
   exit 0; their seconds.

Any failed check exits non-zero.  Before the last line it prints one
`kernels` JSON line for all seven kernels (the search kernels' `launches`
count phases 4, 4b and 4c, `serve_launches` phase 4b alone,
`front_launches` phase 4c alone; flash decode's count phases 6 and 6b,
and its `moe_shapes` hold its numbers at the two MoE shapes; the segment
bag's `launches` count phase 8, its `train_launches` phase 8b (c)'s
steps, its `dp_launches` phase 8c (a)'s dp steps; a kernel that phase 9
launches counts those launches too, its `dryrun_launches` holds them and
its `dryrun_max_abs_err` phase 9's hold);
the last
line of
standard output
is `{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
repository's sources beside it, the script fails without a result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 33.5e12        # 67 TFLOP/s f32 outside the tensor cores,
                               # counted per instruction (int32 runs at
                               # the f32 instruction rate)
FLOPS_PER_S = {"torch.bfloat16": 989e12,   # tensor cores, dense
               "torch.float32": 67e12}     # outside the tensor cores
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: callers find the arena cold
HOST_HEADSTART_CYCLES = 200_000  # ~0.1 ms of device spin before each timed
                                 # call: longer than a kernel wrapper's host
                                 # work on a loaded host
SEGMENT = "corpus reduced from the paper's ~130k docs by host build time"
LM_CUT = ("decode_32k (configs/registry.py: seq 32768, batch 128) with the "
          "batch cut to --lm-batch so that one card holds the bf16 cache; "
          "full width, random weights from --seed")
PREFILL_REAL_S = 4096          # the flash-prefill kernel's real-shape check:
                               # the first positions of the prompt, batch 1
ROW_ULP = 2.0 ** -7            # one bf16 ulp of a row's largest value: a
                               # kernel against its plain version, both of
                               # which round one float32 result
RETRIEVAL_CUT = 65536          # AutoInt and BST retrieval candidates
RETRIEVAL_CUT_WHY = (
    "retrieval_cand (configs/registry.py: 1 x 1,000,000 candidates) cut to "
    "65,536: at 1,000,000 AutoInt's q, k, v and residual are 10 GB each "
    "([1M, 39, 64] float32) and its scores 12 GB ([1M, 2, 39, 39]); BST's "
    "logits 14 GB ([1M, 8, 21, 21]) plus the softmax copies: 55-60 GB of "
    "transient activations in one shot, as the reference computes them")
MODEL_ULPS = 2.0 ** -5         # four: against the model's attention, which
                               # rounds its probabilities to bf16 before the
                               # product with v (one ulp from the plain
                               # version on its own)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_cuda_ms(torch, fn, iters=20):
    """Mean device ms of `fn()` over `iters` launches, L2 flushed before
    each one (CUDA events around the call only).  A spin of the device
    after the flush gives the host a head start, so that a host slower
    than the flush to enqueue `fn` never leaves the device idle between
    the events."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_HEADSTART_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


# ---------------------------------------------------------------------------
# query streams (seeded)
# ---------------------------------------------------------------------------

def paper_stream(np, corpus, n, seed):
    """The paper's experiment: a random indexed document; 2.1 consecutive
    words (phrase), 2.2 every other word (near); 3..5 words per query."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        if len(toks) < 2 * k + 2:
            continue
        st = int(rng.integers(0, len(toks) - 2 * k))
        out.append((toks[st:st + k].tolist(), "phrase"))
        if len(out) < n:
            out.append((toks[st:st + 2 * k:2].tolist(), "near"))
    return out


def stop_near_stream(np, corpus, lex, ana, n, seed):
    """Near queries sampled at strides 1..3, each made to contain a stop
    form (one word replaced by a stop surface when it has none)."""
    rng = np.random.default_rng(seed)
    stop_surfaces = [s for s in range(400)
                     if bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())][:8]
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        stride = int(rng.integers(1, 4))
        span = stride * (k - 1) + 1
        if len(toks) <= span:
            continue
        st = int(rng.integers(0, len(toks) - span))
        q = toks[st:st + span:stride].tolist()
        if not any(bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())
                   for s in q):
            q[int(rng.integers(k))] = int(rng.choice(stop_surfaces))
        out.append((q, "near"))
    return out


def kword_stream(np, corpus, lex, ana, n, seed):
    """K-word proximity queries drawn like the reference's test suite
    (tests/conftest.py::kword_queries): K in {3, 4, 5} words sampled at
    strides 1..3, ~70% with a stop surface injected, window = the sampled
    span plus jitter in [2, 15], ~10% with W in [16, 31] (the flexible
    path's range).  Returns (surface_ids, window) pairs."""
    rng = np.random.default_rng(seed)
    stop_surfaces = [s for s in range(400)
                     if bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())][:8]
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        stride = int(rng.integers(1, 4))
        span = stride * (k - 1) + 1
        if len(toks) <= span:
            continue
        st = int(rng.integers(0, len(toks) - span))
        q = toks[st:st + span:stride].tolist()
        if rng.random() < 0.7:
            q[int(rng.integers(k))] = int(rng.choice(stop_surfaces))
        if rng.random() < 0.1:
            window = 16 + int(rng.integers(0, 16))
        else:
            window = max(2, min(span - 1 + int(rng.integers(0, 4)), 15))
        out.append((q, window))
    return out


# ---------------------------------------------------------------------------
# kernel phase helpers
# ---------------------------------------------------------------------------

def width_class_store(np, PackedPostings, BLOCK, PACK_WIDTHS, rng):
    """A packed store with one block per width class per field, negative
    anchors, a full-int32-range block and a constant (width-0) tail block
    whose lane word lies past the end of `lanes`."""
    cols = {"doc": [], "pos": [], "dist": []}
    for w in PACK_WIDTHS:
        hi = 0 if w == 0 else (1 << min(w, 31)) - 1
        for f in cols:
            anchor = int(rng.integers(-1000, 1000))
            vals = anchor + rng.integers(0, hi + 1, BLOCK, dtype=np.int64)
            vals[0], vals[-1] = anchor, anchor + hi
            if w == 32:
                vals[0], vals[-1] = -(1 << 31), (1 << 31) - 1
            cols[f].append(vals)
    for f in cols:
        cols[f].append(np.full(BLOCK, 7))
    return PackedPostings.from_columns(
        {f: np.concatenate(v).astype(np.int32) for f, v in cols.items()},
        fields=("doc", "pos", "dist"))


def rebased_rows(np, rng, n_rows, pa, pb):
    """Rows in the rebased int32 key domain: unsorted a with sentinel pads,
    ascending b with sentinel tails and a duplicate run straddling a
    128-block, bands 0..8 (0 and the near window 8 included), one
    all-sentinel a row and one all-sentinel b row."""
    i32max = np.iinfo(np.int32).max
    a = np.full((n_rows, pa), i32max, np.int32)
    b = np.full((n_rows, pb), i32max, np.int32)
    for r in range(n_rows):
        keys = (rng.integers(0, 64, pb) << 17) | rng.integers(64, 4000, pb)
        nb = int(rng.integers(pb // 2, pb + 1))
        b[r, :nb] = np.sort(keys[:nb])
        if nb > 140:
            b[r, 120:136] = b[r, 120]
            b[r, :nb] = np.sort(b[r, :nb])
        na = int(rng.integers(pa // 2, pa + 1))
        near = b[r, rng.integers(0, nb, na)].astype(np.int64) \
            + rng.integers(-9, 10, na)
        a[r, :na] = np.where(rng.random(na) < 0.5, near,
                             (rng.integers(0, 64, na) << 17)
                             | rng.integers(64, 4000, na))
    a[min(1, n_rows - 1)] = i32max
    b[min(2, n_rows - 1)] = i32max
    bands = rng.choice([0, 0, 1, 2, 5, 8], n_rows).astype(np.int32)
    bands[0] = 0
    bands[-1] = 8
    return a, b, bands


def unpack_bound(torch, arena, idx):
    """Least bytes and int ops of an unpack call on these inputs: each
    ordinal read, each touched metadata row and lane word read once, three
    int32 outputs written."""
    meta_t, n = arena["blk_meta"], idx.numel()
    blk = (idx.reshape(-1) >> 7).clamp(0, meta_t.shape[0] - 1).long()
    off = (idx.reshape(-1) & 127).long()
    meta = meta_t[blk].long()
    ws = [meta[:, 1] & 63, (meta[:, 1] >> 6) & 63, (meta[:, 1] >> 12) & 63]
    fb = meta[:, 0]
    words = []
    for w in ws:
        live = w > 0
        words.append((fb + ((off * w) >> 5))[live])
        fb = fb + (w << 2)
    n_words = torch.cat(words).unique().numel()
    n_rows = blk.unique().numel()
    nbytes = 4 * n + 20 * n_rows + 4 * n_words + 12 * n
    return nbytes, 40 * n


def scored_rows(np, rng, n_rows, pa, pb, delta_bits):
    """Min-delta rows: `rebased_rows` folded onto four docs (dense, so bands
    hold several keys and equal-key runs), a delta in [0, 15] beside every
    key — band > 0 rows included, outside the plan's domain: the general
    minimum — each row sorted by (key, delta) as the (key << delta_bits |
    delta) composite, sentinel pads with delta 0, bands 0, 1, 8 and 15."""
    i32max = np.iinfo(np.int32).max
    a, b, _ = rebased_rows(np, rng, n_rows, pa, pb)
    a = np.where(a == i32max, a, a & ((4 << 17) - 1))
    b = np.sort(np.where(b == i32max, b, b & ((4 << 17) - 1)), axis=1)
    bands = np.resize(np.array([0, 1, 8, 15], np.int32), n_rows)
    bd = rng.integers(0, 16, b.shape)
    bd[b == i32max] = 0
    comp = np.sort((b.astype(np.int64) << delta_bits) | bd, axis=1)
    return (a, (comp >> delta_bits).astype(np.int32),
            (comp & ((1 << delta_bits) - 1)).astype(np.int32), bands)


def band_bound(torch, a, b, bands, out_bytes, delta_plane=False,
               walk=False, max_band=None):
    """Least bytes and int ops of a banded row kernel (intersect, min delta,
    delta mask) on these inputs.  Bytes: a read and the output written
    (`out_bytes` per a element), bands read, and of b only the 32-byte
    sectors holding what the answer depends on — per live a element the
    b keys inside its band (capped at `max_band`) and the one on each side
    that closes it, plus, with `delta_plane`, the deltas inside the band;
    each sector once per row.  Ops: a lower-bound search per a element,
    and with `walk` three per in-band b entry (the walk these inputs
    need)."""
    N, pa = a.shape
    pb = b.shape[1]
    band = bands.long()[:, None]
    if max_band is not None:
        band = band.clamp(max=max_band)
    b64 = b.long().contiguous()
    live = a != 2**31 - 1
    lo = torch.searchsorted(b64, (a.long() - band).contiguous())
    hi = torch.searchsorted(b64, (a.long() + band).contiguous(), side="right")

    def sectors(start, end):
        """Distinct 32-byte sectors of an int32 [N, Pb] plane covered by
        the per-element ranges [start, end), summed over rows."""
        start = torch.where(live, start.clamp(0, pb), 0)
        end = torch.where(live, end.clamp(0, pb), 0).clamp(min=start)
        cover = torch.zeros((N, pb + 1), dtype=torch.int64, device=a.device)
        ones = torch.ones_like(start)
        cover.scatter_add_(1, start, ones)
        cover.scatter_add_(1, end, -ones)
        used = cover.cumsum(1)[:, :pb] > 0
        used = torch.cat([used, used.new_zeros((N, -pb % 8))], dim=1)
        return int(used.reshape(N, -1, 8).any(-1).sum())

    b_sectors = sectors(lo - 1, hi + 1)
    if delta_plane:
        b_sectors += sectors(lo, hi)
    nbytes = N * pa * (4 + out_bytes) + 4 * N + 32 * b_sectors
    ops = N * pa * (2 + 3 * max(1, pb.bit_length()))
    if walk:
        ops += 3 * int(((hi - lo).clamp(min=0) * live).sum())
    return nbytes, ops


def bound_ms(nbytes, ops, ops_per_s=INT_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the brute-force oracle runs in forked workers, which inherit this state
# instead of receiving the multi-GB corpus and index by pickle
_ORACLE = {}


def _oracle(i):
    """The brute-force oracle's answer for oracle request i:
    brute_force_search's or brute_force_kword's (positional set, doc-level
    set), or brute_force_ranked's / brute_force_kword_ranked's (anchor
    scores, doc scores, doc-level set) for a ranked request."""
    from repro_torch.core import (brute_force_kword, brute_force_kword_ranked,
                                  brute_force_ranked, brute_force_search)
    corpus, index, r = _ORACLE["corpus"], _ORACLE["index"], \
        _ORACLE["requests"][i]
    if r.mode == "kword":
        fn = brute_force_kword_ranked if r.rank else brute_force_kword
        return fn(corpus, index, r.surface_ids, r.window)
    fn = brute_force_ranked if r.rank else brute_force_search
    return fn(corpus, index, r.surface_ids, mode=r.mode, window=r.window)


_CPU_ENGINES = {}     # a forked worker's engines on the CPU, by kind


def _cpu_answers(kind, batch):
    """The `kind` engine (additional or ordinary) over the oracle's index on
    the CPU, one torch thread, answering `batch` (a forked worker runs it
    and keeps the engine; the card's answers are held to these)."""
    import torch
    from repro_torch.core import AdditionalIndexEngine, OrdinaryEngine
    if kind not in _CPU_ENGINES:
        torch.set_num_threads(1)
        cls = AdditionalIndexEngine if kind == "additional" else OrdinaryEngine
        _CPU_ENGINES[kind] = cls(_ORACLE["index"], device="cpu")
    return _CPU_ENGINES[kind].search_batch(batch)


def oracle_mismatch(r, resp, want, rtol=1e-4) -> bool:
    """True when response `resp` to request `r` disagrees with the oracle's
    answer `want`: anchor (or doc-level) sets exactly, ranked anchor and
    doc scores to `rtol` (the engines accumulate float32, the oracle
    float64), ranked docs in (score desc, doc asc) order, `top_k` docs."""
    if not r.rank:
        positional, doc_level = want
        if resp.doc_only:
            return set(resp.doc.tolist()) != doc_level
        return set(zip(resp.doc.tolist(), resp.pos.tolist())) != positional
    a_sc, d_sc, d_lvl = want
    if resp.doc_only:
        return set(resp.doc.tolist()) != d_lvl
    got = dict(zip(zip(resp.doc.tolist(), resp.pos.tolist()),
                   resp.anchor_scores.tolist()))
    if set(got) != set(a_sc):
        return True
    if any(abs(v - a_sc[k]) > rtol * max(1.0, abs(a_sc[k]))
           for k, v in got.items()):
        return True
    if len(resp.doc_ids) != min(r.top_k or len(d_sc), len(d_sc)):
        return True
    if any(abs(s - d_sc[d]) > rtol * max(1.0, abs(d_sc[d]))
           for d, s in zip(resp.doc_ids.tolist(), resp.doc_scores.tolist())):
        return True
    s, d = resp.doc_scores, resp.doc_ids
    return not bool(((s[:-1] > s[1:])
                     | ((s[:-1] == s[1:]) & (d[:-1] < d[1:]))).all())


class Recorder:
    """Wraps a kernel entry point of the batch executor and keeps a copy of
    the inputs of its largest call, and of the largest call of each b
    width (used only before the main path run)."""

    def __init__(self, fn, size):
        self.fn, self.size, self.best, self.best_size = fn, size, None, -1
        self.by_pb = {}            # Pb -> (calls, size, inputs of largest)

    def __call__(self, *args):
        s = self.size(*args)
        # the b width of a row kernel's call (unpack's arena is a dict)
        pb = None if isinstance(args[0], dict) else args[1].shape[1]
        n, s_pb, kept = self.by_pb.get(pb, (0, -1, None))
        if s > s_pb or s > self.best_size:
            # the arena dict is never written: keep it, copy the rest
            copy = tuple(x if isinstance(x, dict) else x.clone()
                         for x in args)
            if s > self.best_size:
                self.best_size, self.best = s, copy
            if s > s_pb:
                s_pb, kept = s, copy
        self.by_pb[pb] = (n + 1, s_pb, kept)
        return self.fn(*args)


class CallLog:
    """Wraps a row kernel's entry point of the batch executor (a, b, bands,
    ...) and keeps every call's a, b width and bands: references, not
    copies (the executor never writes them after the call), so logging
    costs the timed run no launch."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append((args[0], args[1].shape[1], args[2]))
        return self.fn(*args)

    def summary(self, torch):
        """Histograms of the calls: b width (calls), a width (calls), band
        (rows), and the share of a entries that are the sentinel."""
        pb, pa, band = {}, {}, {}
        n_a = n_sent = 0
        for a, w, bands in self.calls:
            pb[w] = pb.get(w, 0) + 1
            pa[a.shape[1]] = pa.get(a.shape[1], 0) + 1
            v, c = torch.unique(bands, return_counts=True)
            for vi, ci in zip(v.tolist(), c.tolist()):
                band[vi] = band.get(vi, 0) + ci
            n_a += a.numel()
            n_sent += int((a == 2**31 - 1).sum())
        return {"calls": len(self.calls),
                "rows": sum(int(b.numel()) for _, _, b in self.calls),
                "pb": json.dumps(dict(sorted(pb.items())), separators=(",", ":")),
                "pa": json.dumps(dict(sorted(pa.items())), separators=(",", ":")),
                "band": json.dumps(dict(sorted(band.items())),
                                   separators=(",", ":")),
                "sentinel_share": f"{n_sent / max(n_a, 1):.4f}"}


def kernel_count(torch, fn):
    """CUDA kernels that one call of `fn` launches, by torch.profiler (the
    device idle before and after); None when the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == DeviceType.CUDA and "emcpy" not in e.name
            and "emset" not in e.name for e in prof.events())
    return n or None


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------

PHASE_ENDS = []                # (phase, wall-clock end), in run order


def phase_done(name, t_start):
    say("phase", name=name, seconds=f"{time.perf_counter() - t_start:.1f}")
    PHASE_ENDS.append((name, time.time()))
    return time.perf_counter()


def run(args) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this smoke run needs an "
                           "NVIDIA GPU")
    from repro_torch.kernels import build

    t_run = time.perf_counter()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device_kind = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(device_kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    say("build", seconds=f"{build_s:.2f}", sources=",".join(logs))
    t_phase = time.perf_counter()
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                say("ptxas", source=name, info=json.dumps(line.strip()))

    with contextlib.ExitStack() as graph_stack:  # ends the graph workers
        # phase 8c's two large graphs, built on the host meanwhile
        graphs = start_gnn_graphs(graph_stack, args.seed)
        # phase 9's fake pass, meanwhile (it needs no card)
        dry = start_dryrun(graph_stack)
        with contextlib.ExitStack() as stack:  # ends the oracle's workers
            kernels = search_phases(args, stack, np, torch, t_phase)
        # the search phases' index, engines and tensors are gone with their
        # frame; hand their device memory back before the model is built
        gc.unfreeze()
        gc.collect()
        torch.cuda.empty_cache()
        kernels += lm_phases(args, np, torch)
        gc.collect()
        torch.cuda.empty_cache()
        moe_shapes = moe_phases(args, np, torch)
        decode = next(k for k in kernels if k["name"] == "flash_decode")
        decode["launches"] += sum(m["launches"] for m in moe_shapes)
        decode["max_abs_err"] = max([decode["max_abs_err"]]
                                    + [m["max_abs_err"] for m in moe_shapes])
        decode["moe_shapes"] = moe_shapes
        gc.collect()
        torch.cuda.empty_cache()
        kernels += recsys_phases(args, np, torch)
        gc.collect()
        torch.cuda.empty_cache()
        bag = next(k for k in kernels if k["name"] == "segment_bag")
        bag["train_launches"], fm_step_ms = train_phases(args, np, torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        bag["dp_launches"] = dp_gnn_phases(args, np, torch, card, graphs,
                                           fm_step_ms)
        gc.collect()
        torch.cuda.empty_cache()
        dryrun_phase(args, np, torch, dry, kernels)
        gc.collect()
        torch.cuda.empty_cache()
    example_phase()
    say("phase", name="total", seconds=f"{time.perf_counter() - t_run:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"platform": "gpu", "kind": device_kind,
            "count": torch.cuda.device_count()}


def search_batches(np, corpus, lex, ana, args):
    """The main path's request batches from --seed: `batches` (1 warm-up
    and --batches timed batches of the paper's stream), one stop-heavy near
    batch, and the ranked and K-word kinds, one warm-up batch each before
    their timed batches (`ranked`: three ranked batches of the paper's
    stream; `kw`: a batch alternating unranked and ranked K-word requests,
    then an unranked and a ranked one)."""
    from repro_torch.core import SearchRequest
    n_b, bs = args.batches, args.batch_size
    stream = paper_stream(np, corpus, (n_b + 1) * bs, args.seed + 1)
    batches = [[SearchRequest(q, mode=m) for q, m in stream[i * bs:(i + 1) * bs]]
               for i in range(n_b + 1)]
    stop_batch = [SearchRequest(q, mode=m) for q, m in
                  stop_near_stream(np, corpus, lex, ana, bs, args.seed + 2)]
    ranked = paper_stream(np, corpus, 3 * bs, args.seed + 3)
    ranked = [[SearchRequest(q, mode=m, rank=True, top_k=10)
               for q, m in ranked[i * bs:(i + 1) * bs]] for i in range(3)]
    kw = kword_stream(np, corpus, lex, ana, 3 * bs, args.seed + 5)
    ranks = [[j % 2 == 1 for j in range(bs)], [False] * bs, [True] * bs]
    kw = [[SearchRequest(q, mode="kword", window=w, rank=rk)
           for (q, w), rk in zip(kw[i * bs:(i + 1) * bs], ranks[i])]
          for i in range(3)]
    return batches, stop_batch, ranked, kw


def search_phases(args, stack, np, torch, t_phase) -> list:
    """Phases 2-4 (index, search kernels, search main path); returns the
    four search kernels' entries of the `kernels` line."""
    import repro_torch.core.batch_executor as bx
    from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                                  LexiconConfig, OrdinaryEngine,
                                  SearchRequest, build_all, generate_corpus,
                                  make_lexicon_and_analyzer)
    from repro_torch.core.postings import BLOCK, PACK_WIDTHS, PackedPostings
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_cases import (MD_EDGE_CASES, MD_EDGE_WIDTHS,
                                                ROW_EDGE_CASES,
                                                ROW_EDGE_WIDTHS, md_edge_case,
                                                row_edge_case)
    from repro_torch.kernels.intersect import (banded_delta_mask_rows_info,
                                               banded_intersect_rows_info,
                                               banded_min_delta_rows_info)
    from repro_torch.serve.front import build_doc_shards

    # -- 2. index -------------------------------------------------------------
    t0 = time.perf_counter()
    lc = LexiconConfig(seed=args.seed)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=args.docs,
                                              mean_doc_len=800.0,
                                              seed=args.seed))
    index = build_all(corpus, lex, ana)
    host_build_s = time.perf_counter() - t0

    n_b, bs = args.batches, args.batch_size
    batches, stop_batch, ranked, kw = search_batches(np, corpus, lex, ana,
                                                     args)
    warmups = [ranked[0], kw[0]]
    kinds = {
        "ranked": ranked[1:],
        "ranked_stop_near": [[SearchRequest(q, mode=m, rank=True, top_k=10)
                              for q, m in stop_near_stream(
                                  np, corpus, lex, ana, bs, args.seed + 4)]],
        "kword": [kw[1]],
        "kword_ranked": [kw[2]],
    }
    timed = [r for b in batches[1:] for r in b] + stop_batch
    # the O(corpus) oracle for the first 16 timed unranked requests and the
    # first 8 of every new batch runs in forked workers (numpy only; forked
    # before any tensor exists) while the card phases below proceed; it is
    # collected before the timed main path
    oracle_reqs = timed[:16] + [r for bl in kinds.values() for b in bl
                                for r in b[:8]]
    _ORACLE.update(corpus=corpus, index=index, requests=oracle_reqs)
    pool = stack.enter_context(ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("fork")))
    # phase 4c's one-shot index over the segments' documents, built here
    # while the card phases run and collected with the oracle
    seg_future = pool.submit(_head_index,
                             min(args.segment_docs, corpus.n_docs - 1))
    oracle_futures = [pool.submit(_oracle, i) for i in range(len(oracle_reqs))]

    torch.cuda.reset_peak_memory_stats()
    engines = {"additional": AdditionalIndexEngine(index, device="cuda"),
               "ordinary": OrdinaryEngine(index, device="cuda")}
    for eng in engines.values():
        eng.batch_executor.dev.device_arena      # arenas onto the card now
    torch.cuda.synchronize()
    dev_bytes = engines["additional"].batch_executor.dev.device_nbytes()
    say("index", docs=corpus.n_docs, tokens=corpus.n_tokens,
        host_build_s=f"{host_build_s:.1f}", arena_device_bytes=dev_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("index", cut=json.dumps(SEGMENT))
    t_phase = phase_done("index", t_phase)

    # record the inputs the main path gives each kernel (the additional
    # engine's warm-up batches)
    names = ("unpack_postings", "banded_intersect_rows",
             "banded_min_delta_rows", "banded_delta_mask_rows")
    rec = {"unpack_postings": Recorder(bx.unpack_postings,
                                       lambda arena, idx: idx.numel()),
           "banded_intersect_rows": Recorder(
               bx.banded_intersect_rows, lambda a, b, bands: a.numel()),
           "banded_min_delta_rows": Recorder(
               bx.banded_min_delta_rows,
               lambda a, bk, bd, bands: a.numel() + bk.numel()),
           "banded_delta_mask_rows": Recorder(
               bx.banded_delta_mask_rows,
               lambda a, b, bands, windows: a.numel() + b.numel())}
    for name in names:
        setattr(bx, name, rec[name])
    try:
        for batch in [batches[0]] + warmups:
            engines["additional"].search_batch(batch)
    finally:
        for name in names:
            setattr(bx, name, rec[name].fn)
    check(all(r.best is not None for r in rec.values()),
          "the warm-up batches reached not every kernel: "
          f"{[n for n, r in rec.items() if r.best is None]}")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(args.seed)
    err = dict.fromkeys(names, 0)

    def diff(got, want):
        if not got.numel():
            return 0
        return int((got.long() - want.long()).abs().max())

    pp = width_class_store(np, PackedPostings, BLOCK, PACK_WIDTHS, rng)
    arena = {"lanes": torch.from_numpy(pp.lanes).cuda(),
             "blk_meta": torch.from_numpy(pp.meta_matrix()).cuda()}
    idx = torch.arange(pp.n_padded + 500, dtype=torch.int32,
                       device=arena["lanes"].device)
    for arena_c, idx_c in ((arena, idx), rec["unpack_postings"].best):
        got = ops.unpack_postings(arena_c, idx_c)
        want = ops.unpack_postings_plain(arena_c, idx_c)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err["unpack_postings"] = max(err["unpack_postings"], diff(g, w))
    decoded = ops.unpack_postings(arena, idx)
    for f, name in enumerate(("doc", "pos", "dist")):
        check(np.array_equal(decoded[f][:pp.n].cpu().numpy(),
                             pp.decode(name)), f"unpack != codec ({name})")

    shapes = ((128, 128), (256, 1024), (1024, 4096), (1024, 32768))
    cases = {name: [] for name in names[1:]}
    for pa, pb in shapes:
        cases["banded_intersect_rows"].append(
            [torch.from_numpy(x).cuda()
             for x in rebased_rows(np, rng, 8, pa, pb)])
        a, bk, bd, bands = (torch.from_numpy(x).cuda()
                            for x in scored_rows(np, rng, 8, pa, pb,
                                                ops.SCORE_DELTA_BITS))
        cases["banded_min_delta_rows"].append([a, bk, bd, bands])
        cases["banded_delta_mask_rows"].append([a, bk, bands,
                                                bands.flip(0) + 1])
    # the min-delta kernel's fence edge cases (kernels/edge_cases.py), at
    # each case's widths: their planned strides reach every path of the
    # search
    cases["banded_min_delta_rows"] += [
        [torch.from_numpy(x).cuda() for x in md_edge_case(n, pb)]
        for n in MD_EDGE_CASES for pb in MD_EDGE_WIDTHS[n]]
    # the intersect and delta-mask kernels' regime edge cases, at each
    # case's widths: the staged row (16- and 4-byte copies) and the fence
    for n in ROW_EDGE_CASES:
        for pb in ROW_EDGE_WIDTHS[n]:
            a, b, bands, windows = (torch.from_numpy(x).cuda()
                                    for x in row_edge_case(n, pb))
            cases["banded_intersect_rows"].append([a, b, bands])
            cases["banded_delta_mask_rows"].append([a, b, bands, windows])
    n_row_cases = sum(map(len, ROW_EDGE_WIDTHS.values()))

    def delta_mask_plain(a, b, bands, windows):
        mask = ops.banded_delta_mask_rows_plain(a, b, bands)
        return mask, ops.delta_mask_t_bits(mask, windows)

    # (plain version, which outputs are hits) per row kernel; the delta
    # mask's launch is held on both of its outputs, the mask and its
    # window scan
    plain = {"banded_intersect_rows": (ops.banded_intersect_rows_plain,
                                       lambda x: x),
             "banded_min_delta_rows": (ops.banded_min_delta_rows_plain,
                                       lambda x: x != ops.I32_SENTINEL),
             "banded_delta_mask_rows": (delta_mask_plain,
                                        lambda x: x[0] != 0)}
    for name, (fn_plain, hits) in plain.items():
        kernel = getattr(ops, name)
        for i, args_c in enumerate(cases[name] + [list(rec[name].best)]):
            got = kernel(*args_c)
            want = fn_plain(*args_c)
            torch.cuda.synchronize()
            if isinstance(want, tuple):
                for g, w in zip(got, want):
                    err[name] = max(err[name], diff(g, w))
            else:
                err[name] = max(err[name], diff(got, want))
            if i < len(shapes):
                h = hits(want)
                check(bool(h.any()) and not bool(h.all()),
                      f"{name} edge case {shapes[i]} is trivial")
    check(all(v == 0 for v in err.values()), f"kernel != plain version: {err}")
    say("row_edge_cases", cases=n_row_cases,
        kernels="banded_intersect_rows,banded_delta_mask_rows(mask,t_bits)",
        max_abs_err=max(err["banded_intersect_rows"],
                        err["banded_delta_mask_rows"]))

    # times at the largest main-path inputs
    arena_m, idx_m = rec["unpack_postings"].best
    a_m, b_m, bands_m = rec["banded_intersect_rows"].best
    md = rec["banded_min_delta_rows"].best
    dm = rec["banded_delta_mask_rows"].best
    timing = {
        "unpack_postings": (
            time_cuda_ms(torch, lambda: ops.unpack_postings(arena_m, idx_m)),
            time_cuda_ms(torch, lambda: ops.unpack_postings_plain(arena_m, idx_m)),
            bound_ms(*unpack_bound(torch, arena_m, idx_m))),
        "banded_intersect_rows": (
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows(a_m, b_m, bands_m)),
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows_plain(
                a_m, b_m, bands_m)),
            bound_ms(*band_bound(torch, a_m, b_m, bands_m, 1))),
        "banded_min_delta_rows": (
            time_cuda_ms(torch, lambda: ops.banded_min_delta_rows(*md)),
            time_cuda_ms(torch, lambda: ops.banded_min_delta_rows_plain(*md)),
            bound_ms(*band_bound(torch, md[0], md[1], md[3], 4,
                                 delta_plane=True, walk=True))),
        "banded_delta_mask_rows": (
            time_cuda_ms(torch, lambda: ops.banded_delta_mask_rows(*dm)),
            time_cuda_ms(torch, lambda: delta_mask_plain(*dm)),
            # the mask and its window scan written, the windows read
            bound_ms(*(x + y for x, y in zip(
                band_bound(torch, *dm[:3], 8, walk=True, max_band=15),
                (4 * dm[0].shape[0], 0))))),
    }
    one = torch.zeros(1, device="cuda")
    say("launch_floor", ms=f"{time_cuda_ms(torch, one.zero_):.4f}",
        what=json.dumps("a one-element zero_() on the kernels' timer"))
    live = md[0] != ops.I32_SENTINEL
    say("kernel_design", name="banded_min_delta_rows",
        a=tuple(md[0].shape), bk=tuple(md[1].shape), live_a=int(live.sum()),
        rows_with_live_a=int(live.any(1).sum()),
        live_b_per_row=f"{float((md[1] != ops.I32_SENTINEL).sum(1).float().mean()):.1f}",
        **banded_min_delta_rows_info(md[1].shape[1]))
    for name, info, (a_d, b_d) in (
            ("banded_intersect_rows", banded_intersect_rows_info, (a_m, b_m)),
            ("banded_delta_mask_rows", banded_delta_mask_rows_info, dm[:2])):
        say("kernel_design", name=name, a=tuple(a_d.shape),
            b=tuple(b_d.shape),
            live_a=int((a_d != ops.I32_SENTINEL).sum()),
            **info(b_d.shape[1]))
    say("kernel_shapes", unpack_postings=tuple(idx_m.shape),
        banded_intersect_rows=f"a{tuple(a_m.shape)}b{tuple(b_m.shape)}",
        banded_min_delta_rows=f"a{tuple(md[0].shape)}b{tuple(md[1].shape)}",
        banded_delta_mask_rows=f"a{tuple(dm[0].shape)}b{tuple(dm[1].shape)}")
    t_phase = phase_done("kernels", t_phase)
    oracle = [f.result() for f in oracle_futures]
    seg_index = seg_future.result()                  # workers idle from here
    # the index and the oracle's answers are set-up data: collect now and
    # keep the collector off them, so that no full collection over them
    # pauses a timed batch
    gc.collect()
    gc.freeze()
    t_phase = phase_done("oracle_wait", t_phase)

    # -- 4. main path ---------------------------------------------------------
    counters = {"unpack_postings": ops.unpack_postings_cuda,
                "banded_intersect_rows": ops.banded_intersect_rows_cuda,
                "banded_min_delta_rows": ops.banded_min_delta_rows_cuda,
                "banded_delta_mask_rows": ops.banded_delta_mask_rows_cuda}
    for fn in counters.values():
        fn.launches = 0
    n_calls = 0
    # every call of the two row kernels in this phase, per engine, for
    # their `kernel_calls` histograms
    logged = ("banded_intersect_rows", "banded_delta_mask_rows")
    logs = {(k, e): CallLog(getattr(bx, k)) for k in logged for e in engines}

    def run_batch(eng, batch):
        nonlocal n_calls
        t0 = time.perf_counter()
        out = eng.search_batch(batch)
        torch.cuda.synchronize()
        n_calls += 1
        return out, time.perf_counter() - t0

    results, stats, kind_out, kind_lat, kind_split = {}, {}, {}, {}, {}
    for name, eng in engines.items():
        for k in logged:
            setattr(bx, k, logs[k, name])
        ex = eng.batch_executor
        if name != "additional":
            for batch in [batches[0]] + warmups:         # warm-up
                run_batch(eng, batch)
        lat, out = [], []
        for k in ex.timings:
            ex.timings[k] = 0.0
        for batch in batches[1:]:
            o, dt = run_batch(eng, batch)
            out.extend(o)
            lat.append(dt)
        split = dict(ex.timings)
        stop_out, stop_s = run_batch(eng, stop_batch)
        results[name] = out + stop_out
        stats[name] = (lat, split, stop_s)
        for kname, bl in kinds.items():
            for k in ex.timings:
                ex.timings[k] = 0.0
            for batch in bl:
                o, dt = run_batch(eng, batch)
                kind_out.setdefault((name, kname), []).extend(o)
                kind_lat.setdefault((name, kname), []).append(dt)
            kind_split[name, kname] = dict(ex.timings)
    for (k, _), log in logs.items():
        setattr(bx, k, log.fn)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    for k in logged:
        n = sum(len(logs[k, e].calls) for e in engines)
        check(n == launches[k], f"{k}: {n} calls logged, {launches[k]} "
                                f"launches")
    for (k, e), log in logs.items():
        say("kernel_calls", name=k, engine=e, **log.summary(torch))
    del logs
    t_phase = phase_done("main_path", t_phase)

    fields = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
              "subplan_types", "ranked", "anchor_scores", "doc_ids",
              "doc_scores")

    def same(w, g, f):
        wv, gv = getattr(w, f), getattr(g, f)
        if isinstance(wv, np.ndarray) or isinstance(gv, np.ndarray):
            return (isinstance(wv, np.ndarray) and isinstance(gv, np.ndarray)
                    and wv.dtype == gv.dtype and np.array_equal(wv, gv))
        return wv == gv

    # the same batches through each engine on the CPU, a job per batch in
    # the forked workers; the heaviest first: the ordinary engine's (ten
    # times the additional's work), K-word batches leading
    seq = batches[1:] + [stop_batch] + [b for bl in kinds.values() for b in bl]
    t0 = time.perf_counter()
    cpu_jobs = {name: [None] * len(seq) for name in engines}
    for name in ("ordinary", "additional"):
        for i in reversed(range(len(seq))):
            cpu_jobs[name][i] = pool.submit(_cpu_answers, name, seq[i])
    # phase 4c (b)'s four doc shards with replicas: an untimed host build,
    # made here while the workers check the main path (the shard engines
    # hold their flex arenas on the card from here on)
    t1 = time.perf_counter()
    shards = [build_doc_shards(corpus, index, 4, replicate=True,
                               device="cuda")]
    shard_build_s = time.perf_counter() - t1
    mismatches, cpu_s = {}, {}
    for name in engines:
        want = [r for f in cpu_jobs[name] for r in f.result()]
        got = list(results[name])
        for kname in kinds:
            got += kind_out[name, kname]
        check(len(want) == len(got), "response counts differ")
        mismatches[f"{name}_vs_cpu"] = sum(
            not all(same(w, g, f) for f in fields) for w, g in zip(want, got))
        cpu_s[f"{name}_s"] = f"{time.perf_counter() - t0:.1f}"
    say("cpu_check", **cpu_s, jobs=2 * len(seq),
        shard_build_s=f"{shard_build_s:.1f}")
    t_phase = phase_done("cpu_check", t_phase)
    checked = results["additional"][:16] + [
        r for kname, bl in kinds.items()
        for i in range(len(bl))
        for r in kind_out["additional", kname][i * bs:i * bs + 8]]
    mismatches[f"additional_vs_oracle_{len(oracle_reqs)}"] = sum(
        oracle_mismatch(r, resp, w)
        for r, resp, w in zip(oracle_reqs, checked, oracle))
    say("check", **mismatches)
    check(all(v == 0 for v in mismatches.values()),
          f"responses differ: {mismatches}")
    for v in results["additional"]:
        check(len(v.doc) == len(v.pos), "doc/pos length mismatch")
    for (name, kname), out in kind_out.items():
        for v in out:
            check(len(v.doc) == len(v.pos), "doc/pos length mismatch")
            if v.ranked:
                check(v.doc_scores.dtype == np.float32
                      and bool(np.isfinite(v.doc_scores).all())
                      and bool(np.isfinite(v.anchor_scores).all())
                      and len(v.doc_ids) <= (v.request.top_k
                                             or len(v.doc_ids))
                      and len(v.anchor_scores) == len(v.doc),
                      f"bad ranked response ({name}, {kname})")

    for name, (lat, split, stop_s) in stats.items():
        n_req = n_b * bs
        say("main_path", engine=name, batches=n_b, batch_size=bs,
            qps=f"{n_req / sum(lat):.1f}",
            batch_p50_ms=f"{percentile(lat, 50) * 1e3:.2f}",
            batch_p99_ms=f"{percentile(lat, 99) * 1e3:.2f}",
            stop_near_batch_ms=f"{stop_s * 1e3:.2f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in split.items()})
    for (name, kname), lat in kind_lat.items():
        say("main_path_kind", engine=name, kind=kname, batches=len(lat),
            batch_size=bs, qps=f"{len(lat) * bs / sum(lat):.1f}",
            batch_p50_ms=f"{percentile(lat, 50) * 1e3:.2f}",
            batch_p99_ms=f"{percentile(lat, 99) * 1e3:.2f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in kind_split[name, kname].items()})
    post = {name: sum(r.postings_read for r in rs)
            for name, rs in results.items()}
    say("postings", additional=post["additional"], ordinary=post["ordinary"],
        ratio=f"{post['ordinary'] / max(post['additional'], 1):.2f}")
    kw_post = {name: sum(r.postings_read for kname in ("kword", "kword_ranked")
                         for r in kind_out[name, kname]) for name in engines}
    say("postings_kword", additional=kw_post["additional"],
        ordinary=kw_post["ordinary"],
        ratio=f"{kw_post['ordinary'] / max(kw_post['additional'], 1):.2f}")
    say("memory", max_memory_allocated=torch.cuda.max_memory_allocated())
    say("launches", **launches, batches=n_calls)
    t_phase = phase_done("main_path_checks", t_phase)

    # -- 4b. the serve tier ---------------------------------------------------
    lat_a, _, stop_s = stats["additional"]
    engine_lat = {"unranked": lat_a, "stop_near": [stop_s],
                  **{k: kind_lat["additional", k] for k in kinds}}
    want = {"unranked": results["additional"][:n_b * bs],
            "stop_near": results["additional"][n_b * bs:],
            **{k: kind_out["additional", k] for k in kinds}}
    serve_launches = serve_phase(
        np, torch, index, [batches[0]] + warmups,
        {"unranked": batches[1:], "stop_near": [stop_batch], **kinds}, want,
        engine_lat, counters, fields + ("anchor_subplans",), same)
    t_phase = phase_done("serve", t_phase)

    # -- 4c. the front door, its faults and segments ---------------------------
    front_launches = front_phase(
        args, np, torch, corpus, index, engines["additional"],
        [batches[0]] + warmups,
        {"unranked": batches[1:], "stop_near": [stop_batch], **kinds}, want,
        engine_lat, counters, same, seg_index, shards, shard_build_s)
    t_phase = phase_done("front", t_phase)

    replaces = {"unpack_postings": "src/repro/kernels/unpack.py:39",
                "banded_intersect_rows": "src/repro/kernels/intersect.py:58",
                "banded_min_delta_rows": "src/repro/kernels/intersect.py:117",
                "banded_delta_mask_rows": "src/repro/kernels/intersect.py:176"}
    sources = {"unpack_postings": "unpack.cu",
               "banded_intersect_rows": "intersect.cu",
               "banded_min_delta_rows": "min_delta.cu",
               "banded_delta_mask_rows": "delta_mask.cu"}
    kernels = []
    for name in names:
        ms, plain_ms, (b_ms, b_by) = timing[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/"
                                  + sources[name],
                        "replaces": replaces[name],
                        "launches": launches[name] + serve_launches[name]
                        + front_launches[name],
                        "serve_launches": serve_launches[name],
                        "front_launches": front_launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    return kernels


# ---------------------------------------------------------------------------
# the serve tier
# ---------------------------------------------------------------------------

def serve_phase(np, torch, index, warm, kinds, want, engine_lat, counters,
                fields, same) -> dict:
    """Phase 4b: `SearchServe` over phase 4's index on a one-rank NCCL
    process group (a file store in a temporary directory), at the caps of
    veretennikov's serve_batch shape.  Every batch of phase 4 (the
    warm-ups `warm`, then each kind's batches in `kinds`) goes through
    `search_batch`; each response must equal the additional engine's on
    the card (`want`, per kind, already held to the CPU and the oracles),
    field by field, and the comparison must refuse a ranked response whose
    lowest score has its last bit flipped.  The four search kernels'
    launch counters must rise, and the executor's collective count must
    equal the all_reduce calls made: one a step, two a ranked step.  Then
    the search launcher's closed loop, unranked and ranked.  Returns the
    phase's launches per kernel."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    import repro_torch.serve.search_serve as ss
    from repro_torch.configs.veretennikov import SEARCH_SHAPES
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import make_host_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(store, "store"),
            world_size=1, rank=0)
    except Exception as e:          # the run fails: the group is the path
        raise SmokeFailure(f"no NCCL process group: {e!r}") from e
    try:
        shape = SEARCH_SHAPES["serve_batch"]
        cfg = ss.SearchServeConfig(
            name="veretennikov-serve_batch",
            **{k: v for k, v in shape.items() if k != "kind"})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(data=1, model=1)
        check(mesh.distributed and mesh.device.type == "cuda",
              f"the serve mesh is not on a process group on the card: {mesh}")
        t0 = time.perf_counter()
        serve = ss.SearchServe(index, cfg, mesh)
        torch.cuda.synchronize()
        ex = serve.executor
        say("serve_index", config=cfg.name, queries=cfg.queries,
            task_rows=cfg.task_rows, caps=json.dumps(
                [cfg.groups, cfg.fetch_slots, cfg.p_seed, cfg.postings_pad]),
            build_s=f"{time.perf_counter() - t0:.2f}",
            dp=f"{mesh.dp_rank}/{mesh.dp_size}",
            arena_device_bytes=ex.arena_nbytes(),
            docs_per_shard=ex.dev.docs_per_shard, doc_shards=ex.dev.n_shards,
            max_memory_allocated=torch.cuda.max_memory_allocated())

        # every all_reduce the phase makes, every step (ranked or not) and
        # the steps and slab rows of each step shape (T x G x F x P0 x P)
        reduce_calls, steps, shapes = [0], {False: 0, True: 0}, {}
        all_reduce, step_math = dist.all_reduce, ss.bucket_step_math

        def counted_all_reduce(*a, **kw):
            reduce_calls[0] += 1
            return all_reduce(*a, **kw)

        def counted_step_math(arena, t, *, P0, P, ranked=False, **kw):
            steps[ranked] += 1
            T, G, F = t["start"].shape
            n, rows = shapes.get((G, F, P0, P), (0, 0))
            shapes[G, F, P0, P] = (n + 1, rows + T)
            return step_math(arena, t, P0=P0, P=P, ranked=ranked, **kw)

        for fn in counters.values():
            fn.launches = 0
        dist.all_reduce, ss.bucket_step_math = (counted_all_reduce,
                                                counted_step_math)
        lat, got = {}, {}
        try:
            for batch in warm:
                serve.search_batch(batch)
            torch.cuda.synchronize()
            for k in ex.timings:
                ex.timings[k] = 0.0
            split = {}
            for kind, bl in kinds.items():
                t_kind = dict(ex.timings)
                for batch in bl:
                    t0 = time.perf_counter()
                    out = serve.search_batch(batch)
                    torch.cuda.synchronize()
                    lat.setdefault(kind, []).append(time.perf_counter() - t0)
                    got.setdefault(kind, []).extend(out)
                split[kind] = {k: v - t_kind[k] for k, v in ex.timings.items()}
        finally:
            dist.all_reduce, ss.bucket_step_math = all_reduce, step_math
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()

        mismatches = {}
        for kind in kinds:
            check(len(got[kind]) == len(want[kind]),
                  f"serve {kind}: {len(got[kind])} responses, "
                  f"{len(want[kind])} from the engine")
            mismatches[kind] = sum(not all(same(w, g, f) for f in fields)
                                   for w, g in zip(want[kind], got[kind]))
        ranked = next(g for kind in kinds for g in got[kind]
                      if g.ranked and len(g.doc_scores))
        flipped = ranked.doc_scores.copy()
        flipped.view(np.int32)[int(np.argmin(flipped))] ^= 1
        control = dataclasses.replace(ranked, doc_scores=flipped)
        control_refused = not all(same(ranked, control, f) for f in fields)
        say("serve_check", **{f"{k}_mismatches": v
                              for k, v in mismatches.items()},
            flipped_score_refused=control_refused)
        check(all(v == 0 for v in mismatches.values()),
              f"serve responses differ from the engine's: {mismatches}")
        check(control_refused, "the serve comparison took a response whose "
                               "lowest score has its last bit flipped")
        check(all(v > 0 for v in launches.values()),
              f"a search kernel never launched in the serve phase: {launches}")
        n_steps = steps[False] + steps[True]
        check(ex.slab_stats["steps"] == n_steps,
              f"serve steps: {ex.slab_stats['steps']} counted, {n_steps} run")
        check(ex.collectives == reduce_calls[0]
              == steps[False] + 2 * steps[True],
              f"collectives: {ex.collectives} counted, {reduce_calls[0]} "
              f"all_reduce calls, {steps[False]} steps + {steps[True]} "
              f"ranked steps")
        for kind, ls in lat.items():
            n_req = sum(len(b) for b in kinds[kind])
            e = engine_lat[kind]
            say("serve_path", kind=kind, batches=len(ls), requests=n_req,
                qps=f"{n_req / sum(ls):.1f}",
                batch_p50_ms=f"{percentile(ls, 50) * 1e3:.2f}",
                batch_p99_ms=f"{percentile(ls, 99) * 1e3:.2f}",
                engine_batch_p50_ms=f"{percentile(e, 50) * 1e3:.2f}",
                engine_batch_p99_ms=f"{percentile(e, 99) * 1e3:.2f}",
                **{f"{k}_s": f"{v:.4f}" for k, v in split[kind].items()})
        st = ex.slab_stats
        say("serve_slab", **st,
            live_row_share=f"{st['live_rows'] / max(st['slab_rows'], 1):.4f}",
            live_elem_share=f"{st['live_elems'] / max(st['slab_elems'], 1):.4f}",
            tiers=json.dumps(ex._tiers, separators=(",", ":")))
        say("serve_step_shapes", **{
            "x".join(map(str, k)): f"{n}steps/{rows}rows"
            for k, (n, rows) in sorted(shapes.items())})
        say("serve_launches", **launches, collectives=ex.collectives,
            steps=st["steps"], ranked_steps=steps[True])
        say("serve_memory", arena_device_bytes=ex.arena_nbytes(),
            max_memory_allocated=peak)
        del serve, ex

        # the search launcher's closed loop on the card
        for argv in (["--mode", "search", "--queries", "32"],
                     ["--mode", "search", "--queries", "32", "--ranked"]):
            t0 = time.perf_counter()
            launcher.main(argv)
            say("serve_launcher", argv=json.dumps(" ".join(argv)),
                seconds=f"{time.perf_counter() - t0:.1f}")
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------------------
# the front door, its faults and segments
# ---------------------------------------------------------------------------

FRONT_FIELDS = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
                "subplan_types", "subplan_pos_hits", "ranked",
                "anchor_scores", "doc_ids", "doc_scores")
# across doc shards or segments: `subplan_pos_hits` counts a subplan's keys
# before the merge's dedup, and each shard seeds with its own rarest group
# (shard-local list lengths), so the count can differ from the unsharded
# engine's while the answer is the same (in the reference too); the merge
# reads only whether it is zero
SHARD_FIELDS = tuple(f for f in FRONT_FIELDS if f != "subplan_pos_hits")
GENEROUS = dict(default_deadline_ms=600_000.0, shard_timeout_s=600.0)
SEGMENT_CUT = ("segments cut to the first --segment-docs documents of the "
               "corpus: the manager's ingests and merge are two more host "
               "builds of them (a third, the one-shot index, runs in a "
               "worker); on an H100 machine a 6000-doc build took 134-193 s "
               "and, at 1500 documents, the whole run 952.7-1025.4 s of its "
               "1200 s limit")


def doc_range(corpus, lo, hi):
    """Documents [lo, hi) of `corpus` as a corpus of their own."""
    offs = corpus.doc_offsets
    return type(corpus)(doc_offsets=(offs[lo:hi + 1] - offs[lo]).copy(),
                        tokens=corpus.tokens[offs[lo]:offs[hi]].copy())


def _head_index(n):
    """The one-shot index over the first n documents of the oracle's corpus
    (a forked worker builds it while the card phases run)."""
    from repro_torch.core import build_all
    corpus, index = _ORACLE["corpus"], _ORACLE["index"]
    return build_all(doc_range(corpus, 0, n), index.lexicon, index.analyzer,
                     index.params)


def same_tree(np, a, b, path="index"):
    """The path of the first difference between two index objects (arrays
    equal in dtype, shape and value), or None."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        ok = (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
              and a.dtype == b.dtype and a.shape == b.shape
              and np.array_equal(a, b))
        return None if ok else path
    if isinstance(a, (tuple, list)):
        if type(a) is not type(b) or len(a) != len(b):
            return path
        pairs = [(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))]
    elif isinstance(a, dict):
        if list(a) != list(b):
            return path
        pairs = [(a[k], b[k], f"{path}[{k!r}]") for k in a]
    elif hasattr(a, "__dict__"):
        if type(a) is not type(b) or list(vars(a)) != list(vars(b)):
            return path
        pairs = [(getattr(a, k), getattr(b, k), f"{path}.{k}")
                 for k in vars(a)]
    else:
        return None if a == b else path
    for x, y, p in pairs:
        diff = same_tree(np, x, y, p)
        if diff is not None:
            return diff
    return None


def close_front(front):
    """Close a front door and join its dispatcher's pool: no stalled shard
    call outlives its scenario."""
    front.close()
    front.dispatcher._pool.shutdown(wait=True)


def fault_free(front, resps, what):
    """The checks every front-door run that injects no fault must pass (a
    failed kernel launch would otherwise pass as a degraded answer): every
    response exact, no shard call failed or re-dispatched, nothing
    degraded or shed, the ledger balanced."""
    st, ds = front.stats, front.dispatcher.stats
    bad = [(r.status, r.shed_reason) for r in resps
           if r.status != "SERVED_EXACT"]
    check(not bad, f"{what}: {len(bad)} responses not SERVED_EXACT: "
                   f"{bad[:4]}")
    check(ds.failed == 0 and ds.redispatched == 0,
          f"{what}: shard calls failed ({ds})")
    check(st.served_degraded == 0 and st.shed == 0
          and "internal_error" not in st.shed_reasons,
          f"{what}: degraded {st.served_degraded}, shed {st.shed} "
          f"{st.shed_reasons}")
    check(st.submitted == st.responded == st.served_exact > 0,
          f"{what}: {st.submitted} submitted, {st.responded} responded, "
          f"{st.served_exact} exact")


def front_threads(front, backends, batches):
    """`--front-threads` (a diagnostic, off by default): what the
    dispatcher's threads cost on `batches`: each batch with the shards
    called one after another in this thread, and through `front` with a
    0.1 ms switch interval (5 ms by default)."""
    serial, fast_switch = [], []
    for batch in batches:
        t0 = time.perf_counter()
        for b in backends:
            b(batch)
        serial.append(time.perf_counter() - t0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for batch in batches:
            t0 = time.perf_counter()
            front.search_batch(batch)
            fast_switch.append(time.perf_counter() - t0)
    finally:
        sys.setswitchinterval(interval)
    say("front_threads", kind="unranked", batches=len(serial),
        serial_shards_batch_p50_ms=f"{percentile(serial, 50) * 1e3:.2f}",
        switch_0p1ms_batch_p50_ms=f"{percentile(fast_switch, 50) * 1e3:.2f}")


def front_phase(args, np, torch, corpus, index, engine, warm, kinds, want,
                engine_lat, counters, same, seg_index, shards,
                shard_build_s) -> dict:
    """Phase 4c: the front door over phase 2's index, its faults, its open
    loop and segments.  (a) `FrontDoor(index, device="cuda")`, one shard:
    every batch of phase 4 (`kinds`, after the warm-ups `warm`) through
    `search_batch`, each response SERVED_EXACT from shard (0,) and equal
    to the additional engine's on the card (`engine`'s answers `want`)
    field by field; one batch again, all from the cache.  (b)
    `build_doc_shards(corpus, index, 4, replicate=True)` (`shards`, a
    one-element list, built during phase 4's CPU check in
    `shard_build_s`): the same
    batches, equal with `postings_read` (every field but
    `subplan_pos_hits`: SHARD_FIELDS), from shards (0, 1, 2, 3) (and,
    with `--front-threads`, the unranked ones timed again); then
    `ChaosShard` faults on a few requests of each kind — primary 2 fails
    (its replica answers: exact), shard 2 dead with no replica (degraded to
    the live doc ranges), shard 2 stalled past the dispatcher timeout
    (degraded, then backfilled: the same requests come exact from the
    cache), every shard down (no_shards) — and a control: a merge fed a
    shard response with a hit removed must fail the check.  (c) the
    launcher's open loop (`--qps 50 --duration 5`, unranked and ranked),
    then (a)'s shard under Poisson arrivals at half the engine's unranked
    QPS for 10 s, deadline 1000 ms, cache off.  (d) a `SegmentManager`
    over the first `--segment-docs` documents (3 ingests): answers equal
    a one-shot engine's over them (`seg_index`, built by a worker), the
    merge equals the one-shot build array by array, and a front over the
    manager sees a 4th ingest.  Runs that inject no fault must be all
    exact with no failed shard call (the launcher's loops too; only (c)'s
    Poisson loop at half the engine's QPS may shed or answer late under
    load, for no other reason).  Returns the phase's launches
    per search kernel."""
    import dataclasses

    from repro_torch.core import (AdditionalIndexEngine, SearchRequest,
                                  SegmentManager, corpus_batches)
    from repro_torch.dist.chaos import ChaosShard
    from repro_torch.launch import serve as launcher
    from repro_torch.serve.front import (FrontDoor, FrontDoorConfig,
                                         merge_shard_responses)

    def differ(w, g, fields=FRONT_FIELDS):
        return not all(same(w, g, f) for f in fields)

    def shard_differ(w, g):
        return differ(w, g, SHARD_FIELDS)

    def run_kinds(front, tag, differ=differ):
        """Every batch of `kinds` through the front; its responses and
        mismatches against `want` per kind, and a `front_path` line each."""
        lat, got, formed = {}, {}, {}
        for kind, bl in kinds.items():
            b0 = front.stats.batches
            for batch in bl:
                t0 = time.perf_counter()
                out = front.search_batch(batch)
                lat.setdefault(kind, []).append(time.perf_counter() - t0)
                got.setdefault(kind, []).extend(out)
            formed[kind] = front.stats.batches - b0
        check(all(len(got[k]) == len(want[k]) for k in kinds),
              f"{tag}: response counts differ")
        mism = {k: sum(map(differ, want[k], got[k])) for k in kinds}
        for kind, ls in lat.items():
            n_req = len(got[kind])
            req_ms = [r.latency_ms for r in got[kind]]
            e = engine_lat[kind]
            say("front_path", front=tag, kind=kind, batches=len(ls),
                requests=n_req, qps=f"{n_req / sum(ls):.1f}",
                batch_p50_ms=f"{percentile(ls, 50) * 1e3:.2f}",
                batch_p99_ms=f"{percentile(ls, 99) * 1e3:.2f}",
                request_p50_ms=f"{percentile(req_ms, 50):.2f}",
                request_p99_ms=f"{percentile(req_ms, 99):.2f}",
                engine_batch_p50_ms=f"{percentile(e, 50) * 1e3:.2f}",
                engine_batch_p99_ms=f"{percentile(e, 99) * 1e3:.2f}",
                micro_batches=formed[kind],
                cached=sum(r.cached for r in got[kind]))
        return [r for k in kinds for r in got[k]], mism

    for fn in counters.values():
        fn.launches = 0

    # -- (a) one shard, full depth -------------------------------------------
    t_sub = time.perf_counter()
    front = FrontDoor(index, cfg=FrontDoorConfig(**GENEROUS), device="cuda")
    backend = front.backends[0]
    planner = front.planner
    try:
        backend.engine.batch_executor.dev.device_arena    # onto the card now
        for batch in warm:
            front.search_batch(batch)
        torch.cuda.synchronize()
        resps, mism = run_kinds(front, "one_shard")
        check(all(r.shards == (0,) for r in resps),
              "one-shard front: a response not from shard (0,)")
        batch = kinds["unranked"][0]
        hits0 = front.stats.cache_hits
        again = front.search_batch(batch)
        cache_hits = front.stats.cache_hits - hits0
        mism["cache_again"] = sum(map(differ, want["unranked"], again))
        check(cache_hits == len(batch) and all(r.cached for r in again),
              f"one-shard front: {cache_hits} cache hits of {len(batch)}")
        fault_free(front, resps + again, "one-shard front")
        st = front.stats
        say("front_check", front="one_shard",
            **{f"{k}_mismatches": v for k, v in mism.items()},
            cache_hits=cache_hits, submitted=st.submitted,
            served_exact=st.served_exact, micro_batches=st.batches)
        check(all(v == 0 for v in mism.values()),
              f"one-shard front differs from the engine: {mism}")
    finally:
        close_front(front)
    t_sub = phase_done("front_one_shard", t_sub)

    # -- (b) four doc shards with replicas, full depth -----------------------
    backends, replicas = shards.pop()      # the caller keeps no reference
    for b in backends + replicas:
        b.engine.batch_executor.dev.device_arena
    say("front_shards", shards=len(backends), replicas=len(replicas),
        docs=json.dumps([b.n_docs for b in backends]),
        doc_bases=json.dumps([b.doc_base for b in backends]),
        host_build_s=f"{shard_build_s:.1f}",
        max_memory_allocated=torch.cuda.max_memory_allocated())
    front = FrontDoor(index, backends=backends, replicas=replicas,
                      cfg=FrontDoorConfig(cache_capacity=0, **GENEROUS))
    try:
        for batch in warm:
            front.search_batch(batch)
        for r in replicas:
            r(warm[0])
        resps, mism = run_kinds(front, "four_shards", shard_differ)
        check(all(r.shards == (0, 1, 2, 3) for r in resps),
              "four-shard front: a response not from shards (0, 1, 2, 3)")
        fault_free(front, resps, "four-shard front")
        if args.front_threads:
            front_threads(front, backends, kinds["unranked"])
        say("front_check", front="four_shards",
            **{f"{k}_mismatches": v for k, v in mism.items()})
        check(all(v == 0 for v in mism.values()),
              f"four-shard front differs from the engine: {mism}")
    finally:
        close_front(front)

    # faults, on a few requests of each kind (K-word windows the device
    # takes, so that every dispatch rides a batched bucket)
    few, few_want = [], []
    for kind in ("unranked", "ranked", "kword", "kword_ranked"):
        reqs = [r for b in kinds[kind] for r in b]
        pick = [i for i, r in enumerate(reqs)
                if r.mode != "kword" or r.window <= 15][:4]
        few += [reqs[i] for i in pick]
        few_want += [want[kind][i] for i in pick]
    chaos = [ChaosShard(b) for b in backends]
    lo, hi = backends[2].doc_base, backends[2].doc_base + backends[2].n_docs
    faults = {}

    def fault_front(replica_fns=None, **cfg):
        for c in chaos:
            c.set()
        return FrontDoor(index, backends=chaos, replicas=replica_fns,
                         cfg=FrontDoorConfig(**{**GENEROUS,
                                                "cache_capacity": 0, **cfg}))

    # primary 2 fails: its replica answers, exactly
    front = fault_front(replicas)
    try:
        chaos[2].set(fail=True)
        out = front.search_batch(few)
        ds = front.dispatcher.stats
        faults["replica_rescue"] = (
            all(r.status == "SERVED_EXACT" and r.shards == (0, 1, 2, 3)
                for r in out)
            and not any(map(shard_differ, few_want, out))
            and ds.redispatched > 0 and ds.failed == 0 and chaos[2].calls > 0)
    finally:
        close_front(front)
    # shard 2 dead, no replica: degraded to the live doc ranges
    front = fault_front(max_retries=1, retry_backoff_ms=5.0)
    try:
        chaos[2].set(fail=True)
        out = front.search_batch(few)
        ok = all(r.status == "SERVED_DEGRADED" and r.shed_reason == "shards"
                 and r.shards == (0, 1, 3)
                 and not np.any((r.doc >= lo) & (r.doc < hi)) for r in out)
        compared = 0
        for w, g in zip(few_want, out):
            if w.doc_only or g.doc_only:
                continue
            keep = (w.doc < lo) | (w.doc >= hi)
            ok = ok and np.array_equal(w.doc[keep], g.doc) \
                and np.array_equal(w.pos[keep], g.pos) \
                and (not w.ranked
                     or np.array_equal(w.anchor_scores[keep], g.anchor_scores))
            compared += 1
        faults["dead_shard"] = bool(ok) and compared > 0
        faults["dead_shard_compared"] = compared
    finally:
        close_front(front)
    # shard 2 stalls past the dispatcher timeout: degraded, then backfilled
    front = fault_front(cache_capacity=len(few), shard_timeout_s=1.0,
                        max_retries=0)
    try:
        chaos[2].set(stall_s=2.5)
        out = front.search_batch(few)
        ok = all(r.status == "SERVED_DEGRADED" and r.shed_reason == "shards"
                 and r.shards == (0, 1, 3) for r in out)
        time.sleep(2.0)                       # the stalled calls finish
        t_wait = time.monotonic() + 60.0
        while front.stats.backfilled < 1 and time.monotonic() < t_wait:
            time.sleep(0.05)
        faults["backfilled"] = front.stats.backfilled
        again = front.search_batch(few)
        faults["stall_backfill"] = (
            ok and faults["backfilled"] >= 1
            and all(r.status == "SERVED_EXACT" and r.cached
                    and r.shards == (0, 1, 2, 3) for r in again)
            and not any(map(shard_differ, few_want, again)))
    finally:
        close_front(front)
    # every shard down
    front = fault_front(max_retries=1, retry_backoff_ms=5.0)
    try:
        for c in chaos:
            c.set(fail=True)
        out = front.search_batch(few)
        st = front.stats
        faults["all_down"] = st.submitted == st.responded and all(
            r.status == "SERVED_DEGRADED" and r.shed_reason == "no_shards"
            and r.shards == () and len(r.doc) == 0 for r in out)
    finally:
        close_front(front)
        for c in chaos:
            c.set()
    # the control: a merge that lost one hit must fail the check
    i = next(i for i, w in enumerate(few_want)
             if not w.ranked and not w.doc_only and len(w.doc))
    req = few[i]
    plan = planner.plan(list(req.surface_ids), mode=req.mode,
                        window=req.window, ranked=req.rank)
    per_shard = [(s, b([req])[0]) for s, b in enumerate(backends)]
    merged_ok = not shard_differ(few_want[i],
                                 merge_shard_responses(req, plan, per_shard))
    s, r = next((s, r) for s, r in per_shard
                if len(r.doc) and not r.doc_only)
    per_shard[s] = (s, dataclasses.replace(r, doc=r.doc[1:], pos=r.pos[1:]))
    faults["dropped_hit_refused"] = merged_ok and shard_differ(
        few_want[i], merge_shard_responses(req, plan, per_shard))
    say("front_faults", requests=len(few), **faults)
    check(all(faults[k] for k in ("replica_rescue", "dead_shard",
                                  "stall_backfill", "all_down",
                                  "dropped_hit_refused")),
          f"a fault scenario failed: {faults}")
    del backends, replicas, chaos
    t_sub = phase_done("front_four_shards", t_sub)

    # -- (c) the open loop ---------------------------------------------------
    for argv in (["--mode", "search", "--qps", "50", "--duration", "5"],
                 ["--mode", "search", "--qps", "50", "--duration", "5",
                  "--ranked"]):
        t0 = time.perf_counter()
        fault_free(launcher.main(argv), [], f"launcher open loop {argv}")
        say("front_launcher", argv=json.dumps(" ".join(argv)),
            seconds=f"{time.perf_counter() - t0:.1f}")
    stream = [r for b in kinds["unranked"] for r in b]
    qps = 0.5 * len(stream) / sum(engine_lat["unranked"])
    front = FrontDoor(index, backends=[backend],
                      cfg=FrontDoorConfig(default_deadline_ms=1000.0,
                                          cache_capacity=0,
                                          shard_timeout_s=60.0))
    try:
        resps, elapsed = launcher.poisson_open_loop(front, stream, qps, 10.0,
                                                    timeout=120.0)
    finally:
        close_front(front)
    st, ds = front.stats, front.dispatcher.stats
    p50, p95, p99 = np.percentile([r.latency_ms for r in resps],
                                  [50, 95, 99])
    exact_mism = sum(differ(want["unranked"][i % len(stream)], r)
                     for i, r in enumerate(resps)
                     if r.status == "SERVED_EXACT")
    say("front_open_loop", docs=corpus.n_docs, target_qps=f"{qps:.1f}",
        offered_qps=f"{len(resps) / elapsed:.1f}", requests=len(resps),
        deadline_ms=1000, p50_ms=f"{p50:.2f}", p95_ms=f"{p95:.2f}",
        p99_ms=f"{p99:.2f}", exact=st.served_exact,
        degraded=st.served_degraded, shed=st.shed,
        shed_reasons=json.dumps(st.shed_reasons), micro_batches=st.batches,
        exact_mismatches=exact_mism)
    check(st.submitted == st.responded == len(resps),
          f"open loop: {st.submitted} submitted, {st.responded} responded")
    check(ds.failed == 0 and ds.redispatched == 0,
          f"open loop: shard calls failed ({ds})")
    check(all(r.status == "SERVED_EXACT"
              or r.shed_reason in ("late", "deadline", "queue_full")
              for r in resps),
          f"open loop: answers degraded by something else than load: "
          f"{st.shed_reasons}")
    check(exact_mism == 0, f"open loop: {exact_mism} exact answers differ")
    t_sub = phase_done("front_open_loop", t_sub)

    # -- (d) segments, at a cut depth ----------------------------------------
    n = seg_index.n_docs
    n4 = min(corpus.n_docs, n + max(1, n // 3))
    seg_corpus = doc_range(corpus, 0, n)
    say("front_segments", docs=n, fourth_batch=n4 - n,
        cut=json.dumps(SEGMENT_CUT))
    mgr = SegmentManager(index.lexicon, index.analyzer, index.params,
                         auto_merge=False, device="cuda")
    try:
        t0 = time.perf_counter()
        for b in corpus_batches(seg_corpus, 3):
            mgr.ingest(b)
        ingest_s = time.perf_counter() - t0
        reqs = [SearchRequest(q, mode=m) for q, m in
                paper_stream(np, seg_corpus, 32, args.seed + 6)]
        reqs += [SearchRequest(q, mode=m, rank=True, top_k=10) for q, m in
                 paper_stream(np, seg_corpus, 16, args.seed + 7)]
        reqs += [SearchRequest(q, mode="kword", window=w, rank=i % 2 == 1)
                 for i, (q, w) in enumerate(kword_stream(
                     np, seg_corpus, index.lexicon, index.analyzer, 16,
                     args.seed + 8))]
        seg_want = AdditionalIndexEngine(seg_index,
                                         device="cuda").search_batch(reqs)
        seg = {"union_mismatches": sum(map(
            shard_differ, seg_want,
            mgr.search_batch(reqs, plan_index=seg_index)))}
        t0 = time.perf_counter()
        seg["merged"] = mgr.merge_now()
        merge_s = time.perf_counter() - t0
        seg["merged_index_diff"] = same_tree(np, seg_index,
                                             mgr.segments[0].index)
        seg["merged_mismatches"] = sum(map(differ, seg_want,
                                           mgr.search_batch(reqs)))
        # a front over the manager sees a 4th ingest
        d_new = (n + n4) // 2
        req = SearchRequest(corpus.doc(d_new)[4:7].tolist())
        front = FrontDoor(segments=mgr,
                          cfg=FrontDoorConfig(cache_capacity=16, **GENEROUS))
        try:
            before = front.search(req)
            cached = front.search(req)
            t0 = time.perf_counter()
            mgr.ingest(doc_range(corpus, n, n4))
            ingest_s += time.perf_counter() - t0
            fresh = front.search(req)
            full = engine.search_batch([req])[0]
            keep = full.doc < n4
            st = front.stats
            seg.update(
                before_new_docs=bool(np.any(before.doc >= n)),
                cached_before_ingest=cached.cached,
                fresh_after_ingest=not fresh.cached,
                new_doc_found=d_new in set(fresh.doc.tolist()),
                equal_to_engine_below=bool(
                    not full.doc_only and not fresh.doc_only
                    and np.array_equal(full.doc[keep], fresh.doc)
                    and np.array_equal(full.pos[keep], fresh.pos)),
                generation_bumps=st.generation_bumps,
                stale_cache_hits=st.stale_cache_hits)
            fault_free(front, [before, cached, fresh], "segment front")
        finally:
            close_front(front)
    finally:
        mgr.close()
    say("front_segments_check", requests=len(reqs),
        ingest_s=f"{ingest_s:.1f}", merge_s=f"{merge_s:.1f}",
        **{k: json.dumps(v) for k, v in seg.items()})
    check(seg["union_mismatches"] == 0 and seg["merged"]
          and seg["merged_index_diff"] is None
          and seg["merged_mismatches"] == 0,
          f"segments differ from the one-shot engine: {seg}")
    check(not seg["before_new_docs"] and seg["cached_before_ingest"]
          and seg["fresh_after_ingest"] and seg["new_doc_found"]
          and seg["equal_to_engine_below"] and seg["generation_bumps"] >= 1
          and seg["stale_cache_hits"] == 0,
          f"the segment front missed the 4th ingest: {seg}")
    phase_done("front_segments", t_sub)

    launches = {k: fn.launches for k, fn in counters.items()}
    say("front_launches", **launches)
    check(all(v > 0 for v in launches.values()),
          f"a search kernel never launched in the front phase: {launches}")
    return launches


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

def decode_bound(torch, q, k, kv_len):
    """Least bytes and flops of a flash-decode call on these inputs: the k
    and v rows below each kv_len read once, q read and out written; 4 D
    flops per (query head, row)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rows = int(kv_len.clamp(0, S).sum())
    nbytes = 2 * rows * Hkv * D * k.element_size() + 2 * q.numel() * q.element_size()
    return nbytes, 4 * rows * Hq * D


def prefill_bound(q, k):
    """Least bytes and flops of a causal prefill call: q, k, v read and out
    written once; 4 D flops per (query head, q, kv <= q) pair."""
    B, S, Hq, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * B * Hq * D * S * (S + 1) // 2


def attention_cases(np, torch, rng):
    """Seeded edge cases of the two attention kernels: (kind, inputs)."""
    def make(shapes, dtype):
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(device="cuda", dtype=dtype) for s in shapes]
    f32, bf16 = torch.float32, torch.bfloat16
    decode = []
    for B, Hq, Hkv, D, S, kv_len, dt in [
            (2, 4, 4, 32, 96, [1, 96], f32),                 # G = 1
            (3, 8, 2, 64, 1000, [0, 999, 517], f32),         # kv_len 0, odd
            (2, 5, 1, 128, 777, [777, 5000], f32),           # G = 5, > S
            (4, 16, 4, 64, 2048, [1, 2048, 1023, 0], bf16),  # G = 4
            (2, 5, 1, 32, 333, [333, 2], bf16),
            (2, 8, 1, 128, 4096, [4095, 3], bf16),           # G = 8
            # the split's edges (512-row chunks at S 8192, B 4, Hkv 8;
            # 64-row chunks at S 1000, B 3, Hkv 2): one row past a chunk
            # boundary, on one, shorter than a chunk beside long rows
            (4, 32, 8, 128, 8192, [513, 1024, 100, 8192], bf16),
            (4, 32, 8, 128, 8192, [511, 512, 1, 0], bf16),
            (3, 8, 2, 64, 1000, [0, 1000, 5000], bf16),      # 0 beside S
            (3, 8, 2, 64, 1000, [65, 64, 63], f32)]:         # S % 64 != 0
        q, k, v = make([(B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dt)
        decode.append((q, k, v, torch.tensor(kv_len, dtype=torch.int32,
                                             device="cuda")))
    prefill = [make([(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dt)
               for B, S, Hq, Hkv, D, dt in [
                   (1, 128, 4, 1, 32, f32), (2, 200, 8, 2, 64, f32),
                   (1, 77, 5, 1, 128, f32), (1, 300, 12, 3, 64, bf16),
                   (2, 64, 4, 4, 128, bf16), (1, 1000, 8, 1, 32, bf16),
                   # the wgmma route's tile edges: S below one kv tile, not
                   # a multiple of the 128-row q tile; G 1, 5 and 8
                   (1, 1, 1, 1, 64, bf16), (1, 40, 5, 1, 128, bf16),
                   (1, 129, 4, 4, 32, bf16), (2, 333, 8, 1, 128, bf16)]]
    return decode, prefill


def tol_of(torch, x):
    return 2e-5 if x.dtype == torch.float32 else 5e-2


def max_err(torch, got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def row_rel_err(torch, got, want):
    """The error in units of each output row's scale: the largest over rows
    (the last axis) of max|got - want| / max|want|.  A zeroed output reads
    1; a row of zeros in `want` must be matched exactly (inf otherwise)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1)
    r = torch.where(scale > 0, err / scale.clamp_min(1e-30),
                    torch.where(err > 0, torch.full_like(err, float("inf")),
                                torch.zeros_like(err)))
    return float(r.max()) if r.numel() else 0.0


def hold(torch, what, got, want, rel_limit=ROW_ULP):
    """Check `got` against `want`: the absolute tolerance of its dtype and,
    in bf16, `rel_limit` of each row's scale (`row_rel_err`), which a
    near-flat softmax's small outputs cannot hide.  Returns (abs, rel)."""
    e = max_err(torch, got, want)
    check(e < tol_of(torch, got), f"{what}: max abs err {e}")
    r = row_rel_err(torch, got, want)
    check(got.dtype == torch.float32 or r <= rel_limit,
          f"{what}: err {r} of a row's scale > {rel_limit}")
    return e, r


def control(torch, what, got, want, rel_limit):
    """A deliberately wrong output that the check must refuse."""
    r = row_rel_err(torch, got, want)
    check(r > rel_limit, f"control {what} passes the check ({r} <= "
                         f"{rel_limit}): the check cannot see it")
    return r


@contextlib.contextmanager
def recording(module, name, calls):
    """Within the block, `module.name` appends (args, result) of every call
    to `calls`: the model's own inputs and outputs of that function."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, out))
        return out
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def needle_cache(torch, q, k, v, kv_len):
    """Copies of k, v where rows 0 and kv_len - 1 of every (b, kv head)
    draw about a third of the softmax each: k there points along the
    group's summed q, scaled so that the mean score is ln(kv_len) + 1/2,
    about the log of what the other rows (N(0, 1) scores) sum to.  Their v
    stay O(1), so a kernel that drops either end row, or the rows between,
    moves the output by a large share of its scale."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    u = qg.sum(2)
    u = u / u.norm(dim=-1, keepdim=True)                     # [B, Hkv, D]
    proj = (qg * u[:, :, None]).sum(-1).mean(-1)             # [B, Hkv]
    nk = k.clone()
    for b in range(B):
        n = int(kv_len[b])
        c = (math.log(n) + 0.5) * D ** 0.5 / proj[b]
        for r in (0, n - 1):
            nk[b, r] = (c[:, None] * u[b]).to(k.dtype)
    return nk, v.clone()


def decode_steps(torch, tfm, model, cache, logits0, P, T, impl, feed,
                 past=None):
    """T greedy `decode_step`s from cache slot P with attention `impl`,
    the first token the argmax of `logits0`, or the tokens `feed`
    (teacher-forced).  `past`, the k and v of slots P.. that another pass
    wrote, is copied back before each step, so that step t reads the cache
    that pass's step t read.  Returns (logits [T, B, Vp], the tokens fed,
    each step's seconds)."""
    vocab = model.cfg.vocab
    logits, fed, step_s = [], [], []
    tok = torch.argmax(logits0[:, :vocab], dim=-1)
    for t in range(T):
        tok = tok if feed is None else feed[t]
        fed.append(tok)
        if past is not None:
            for f in ("k", "v"):
                cache[f][:, :, P:P + t].copy_(past[f][:, :, :t])
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, _ = tfm.decode_step(model, cache, tok, P + t, attn_impl=impl)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        logits.append(lg)
        tok = torch.argmax(lg[:, :vocab], dim=-1)
    return torch.stack(logits), fed, step_s


def decode_trace(torch, tfm, model, cache, tok, cur_len, steps=2):
    """Wall and device time of `steps` flash decode steps under
    torch.profiler: the device's busy ms per step (the sum of its kernels'
    times), its idle share, the attention kernels' and the products'
    share, and the kernels that take the most time.  A profiler that
    records no device activity gives {"traced": False} and a reason."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(steps):
                tfm.decode_step(model, cache, tok, cur_len + s,
                                attn_impl="flash")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / steps
    except Exception as e:                 # a diagnostic: the run goes on
        return {"traced": False, "reason": json.dumps(f"{type(e).__name__}: {e}")}
    if not by_name:
        return {"traced": False, "reason": "no device activity recorded"}
    busy = sum(by_name.values())
    attn = sum(v for k, v in by_name.items() if "decode_" in k)
    gemm = sum(v for k, v in by_name.items()
               if any(w in k.lower() for w in ("gemm", "gemv", "cutlass", "nvjet")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"traced": True, "steps": steps, "wall_ms_per_step": f"{wall_ms:.3f}",
            "device_busy_ms_per_step": f"{busy:.3f}",
            "device_idle_share": f"{1 - busy / wall_ms:.3f}",
            "flash_decode_ms_per_step": f"{attn:.3f}",
            "matmul_ms_per_step": f"{gemm:.3f}",
            "kernel_kinds": len(by_name),
            "top": json.dumps({k[:60]: round(v, 3) for k, v in top})}


def lm_phases(args, np, torch) -> list:
    """Phases 5-6: the LM serving path of `--lm-arch` at full width (bf16,
    random weights from --seed).  The two attention kernels against their
    plain versions (seeded edge cases; decode at the cache's real shape,
    flat and with needle rows; prefill on the first PREFILL_REAL_S
    positions of the real prompt at batch 1), each check shown to refuse a
    wrong output; then the main path: a prefill of the prompt through
    `forward_with_cache`, `--lm-steps` greedy `decode_step`s through the
    flash-decode kernel (each layer's attention output held against the
    plain version on the same q and cache), the same steps teacher-forced
    through the plain version, and the flash-prefill kernel held against
    the model's own attention in every layer of a prefill of the prompt's
    first PREFILL_REAL_S positions.  Returns the two kernels' entries of
    the `kernels` line."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import LM_SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import forward_with_cache
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    cfg = get_arch(args.lm_arch).make_config()
    check(cfg.dtype == torch.bfloat16, f"{args.lm_arch} is not bf16")
    B, P, T = args.lm_batch, args.lm_prompt, args.lm_steps
    s_max = LM_SHAPES["decode_32k"]["seq_len"]
    check(P + T <= s_max, f"prompt {P} + steps {T} > cache {s_max}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = tfm.init_params(tfm.serving_config(cfg), gen, "cuda")
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_bytes = (2 * cfg.n_layers * B * s_max * cfg.n_kv_heads * cfg.hd
                   * torch.finfo(cfg.dtype).bits // 8)
    say("lm_model", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=str(cfg.dtype).split(".")[-1],
        params=cfg.param_count(), weight_bytes=weight_bytes,
        cache_bytes=cache_bytes, batch=B, prompt=P, steps=T, cache_len=s_max,
        prefill_chunks=cfg.attn_chunk.for_seq(P))
    say("lm_model", cut=json.dumps(LM_CUT))
    t_phase = phase_done("lm_init", t_phase)

    # the two kernels' designs at the path's shapes: the decode's split of
    # the cache and both kernels' compiled resources, as the runtime
    # reports them (the ptxas lines above give the same registers)
    from repro_torch.kernels.flash_decode import decode_split, flash_decode_info
    from repro_torch.kernels.flash_prefill import flash_prefill_info
    chunk, n_split = decode_split(s_max, B, cfg.n_kv_heads)
    say("kernel_design", name="flash_decode",
        cache=f"[{B},{s_max},{cfg.n_kv_heads},{cfg.hd}]", chunk_rows=chunk,
        n_split=n_split, ctas=B * cfg.n_kv_heads * n_split,
        cuda_launches_per_call=2,
        **flash_decode_info(cfg.hd, cfg.dtype, cfg.n_heads // cfg.n_kv_heads))
    say("kernel_design", name="flash_prefill", route="wgmma_bf16",
        pv="P rounded to bf16, one wgmma per k16 step (no hi/lo split)",
        **flash_prefill_info(cfg.hd, cfg.dtype))
    say("kernel_design", name="flash_prefill", route="cuda_cores_f32",
        **flash_prefill_info(cfg.hd, torch.float32))

    # -- 5. the attention kernels against their plain versions ---------------
    rng = np.random.default_rng(args.seed)
    decode_cases, prefill_cases = attention_cases(np, torch, rng)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dq = torch.randn((B, hq, hd), generator=gen, device="cuda").to(cfg.dtype)
    dk, dv = (torch.randn((B, s_max, hkv, hd), generator=gen, device="cuda")
              .to(cfg.dtype) for _ in range(2))
    d_len = torch.full((B,), P, dtype=torch.int32, device="cuda")
    nk, nv = needle_cache(torch, dq, dk, dv, d_len)
    s0 = min(PREFILL_REAL_S, P)
    with torch.no_grad():
        x0 = model.embed[prompt[:1, :s0]]
        pos0 = torch.arange(s0, dtype=torch.int32, device="cuda")[None]
        pq, pk, pv = model.layers[0].qkv(x0, pos0)
    del x0
    err = {"flash_decode": 0.0, "flash_prefill": 0.0}
    rel = {"flash_decode": 0.0, "flash_prefill": 0.0}

    def held(name, what, got, want):
        e, r = hold(torch, f"{name} != plain {what}", got, want)
        err[name], rel[name] = max(err[name], e), max(rel[name], r)

    for q, k, v, kv_len in decode_cases + [(dq, dk, dv, d_len),
                                           (dq, nk, nv, d_len)]:
        held("flash_decode", f"at q{tuple(q.shape)} k{tuple(k.shape)} "
             f"{q.dtype} kv_len {kv_len.tolist()}",
             ops.flash_decode(q, k, v, kv_len),
             ops.flash_decode_plain(q, k, v, kv_len))
    for q, k, v in prefill_cases + [(pq, pk, pv)]:
        held("flash_prefill", f"at q{tuple(q.shape)} k{tuple(k.shape)} "
             f"{q.dtype}", ops.flash_prefill(q, k, v),
             ops.flash_prefill_plain(q, k, v))
    # controls: the real-shape checks refuse a zeroed output, a decode
    # that drops the last cache row (needles) or half of it (flat), and a
    # prefill whose causal mask is off by one row
    want_flat = ops.flash_decode_plain(dq, dk, dv, d_len)
    want_needle = ops.flash_decode_plain(dq, nk, nv, d_len)
    want_pre = ops.flash_prefill_plain(pq, pk, pv)
    shifted = [torch.cat([t[:, :1], t[:, :-1]], dim=1) for t in (pk, pv)]
    controls = {
        "decode_zero": control(torch, "zeroed decode", torch.zeros_like(
            want_flat), want_flat, ROW_ULP),
        "decode_half_cache": control(torch, "decode of half the cache",
                                     ops.flash_decode(dq, dk, dv, d_len // 2),
                                     want_flat, ROW_ULP),
        "decode_kv_len_minus_1": control(
            torch, "decode at kv_len - 1",
            ops.flash_decode(dq, nk, nv, d_len - 1), want_needle, ROW_ULP),
        "prefill_zero": control(torch, "zeroed prefill",
                                torch.zeros_like(want_pre), want_pre, ROW_ULP),
        "prefill_mask_off_by_one": control(
            torch, "prefill with the mask one row late",
            ops.flash_prefill(pq, *shifted), want_pre, ROW_ULP)}
    del decode_cases, prefill_cases, want_flat, want_needle, want_pre, shifted
    del nk, nv
    say("lm_kernel_check", flash_decode_max_abs_err=f"{err['flash_decode']:.4g}",
        flash_decode_row_rel_err=f"{rel['flash_decode']:.4g}",
        flash_prefill_max_abs_err=f"{err['flash_prefill']:.4g}",
        flash_prefill_row_rel_err=f"{rel['flash_prefill']:.4g}",
        limit=ROW_ULP, controls=json.dumps(
            {k: round(v, 4) for k, v in controls.items()}))

    def sdpa_decode():
        mask = (torch.arange(s_max, device="cuda")[None] < d_len[:, None])
        return F.scaled_dot_product_attention(
            dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
            attn_mask=mask[:, None, None], enable_gqa=True)[:, :, 0]

    def sdpa_prefill():
        return F.scaled_dot_product_attention(
            pq.transpose(1, 2), pk.transpose(1, 2), pv.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    lib_err = {"flash_decode": max_err(torch, sdpa_decode(),
                                       ops.flash_decode_plain(dq, dk, dv, d_len)),
               "flash_prefill": max_err(torch, sdpa_prefill(),
                                        ops.flash_prefill_plain(pq, pk, pv))}
    rate = FLOPS_PER_S[str(cfg.dtype)]
    timing = {
        "flash_decode": (
            time_cuda_ms(torch, lambda: ops.flash_decode(dq, dk, dv, d_len)),
            time_cuda_ms(torch, lambda: ops.flash_decode_plain(dq, dk, dv, d_len)),
            bound_ms(*decode_bound(torch, dq, dk, d_len), rate),
            time_cuda_ms(torch, sdpa_decode)),
        "flash_prefill": (
            time_cuda_ms(torch, lambda: ops.flash_prefill(pq, pk, pv)),
            time_cuda_ms(torch, lambda: ops.flash_prefill_plain(pq, pk, pv)),
            bound_ms(*prefill_bound(pq, pk), rate),
            time_cuda_ms(torch, sdpa_prefill))}
    say("lm_kernel_shapes",
        flash_decode=f"q{tuple(dq.shape)}k{tuple(dk.shape)}kv_len{P}",
        flash_prefill=f"q{tuple(pq.shape)}k{tuple(pk.shape)}",
        sdpa_vs_plain=json.dumps(lib_err))
    del dq, dk, dv, pq, pk, pv
    torch.cuda.empty_cache()

    # the flash-prefill kernel at the served prompt length (batch 1, layer
    # 0) beside the chunked attention the prefill runs there; and the
    # logits' head, which turns the bf16 lm_head into float32 every call
    with torch.no_grad():
        pos = torch.arange(P, dtype=torch.int32, device="cuda")[None]
        sq, sk, sv = model.layers[0].qkv(model.embed[prompt[:1]], pos)
        cq, ckv = cfg.attn_chunk.for_seq(P)
        s_want = L.causal_attention(sq, sk, sv, chunk_q=cq, chunk_kv=ckv)
        _, s_rel = hold(torch, "flash_prefill != causal_attention at the "
                        "served length", ops.flash_prefill(sq, sk, sv), s_want,
                        MODEL_ULPS)
        served_ms = time_cuda_ms(torch, lambda: ops.flash_prefill(sq, sk, sv),
                                 iters=2)
        chunked_ms = time_cuda_ms(torch, lambda: L.causal_attention(
            sq, sk, sv, chunk_q=cq, chunk_kv=ckv), iters=2)
        del sq, sk, sv, s_want
        xh = model.embed[prompt[:, -1]]
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        logits_ms = time_cuda_ms(torch, lambda: model.logits(xh))
        head_cast_ms = time_cuda_ms(torch, lambda: head.float())
    say("lm_prefill_at_served_len", shape=f"q[1,{P},{hq},{hd}]",
        flash_prefill_ms=f"{served_ms:.3f}",
        chunked_causal_attention_ms=f"{chunked_ms:.3f}",
        row_rel_err=f"{s_rel:.4g}", limit=MODEL_ULPS)
    say("lm_head", batch=B, logits_ms=f"{logits_ms:.4f}",
        head_to_float32_ms=f"{head_cast_ms:.4f}")
    torch.cuda.empty_cache()
    t_phase = phase_done("lm_kernels", t_phase)

    # -- 6. main path: prefill, greedy decode, plain decode, prefill check ---
    counters = {"flash_decode": ops.flash_decode_cuda,
                "flash_prefill": ops.flash_prefill_cuda}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits0, pcache = forward_with_cache(model, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    cache = tfm.init_cache(cfg, B, s_max, device="cuda")
    for f in ("k", "v"):
        cache[f][:, :, :P].copy_(pcache[f])
    del pcache
    torch.cuda.empty_cache()

    def decode(impl, feed):
        return decode_steps(torch, tfm, model, cache, logits0, P, T, impl,
                            feed)

    with recording(ops, "flash_decode", []) as dec_calls:
        flash_logits, fed, flash_s = decode("flash", None)
    flash_launches = ops.flash_decode_cuda.launches
    # each layer's attention output of the flash pass against the plain
    # version on the same q and cache: later steps write only later slots,
    # so the cache still holds what every call read
    dec_rel = 0.0
    for (q, ck, cv, kv_len), o in dec_calls:
        dec_rel = max(dec_rel, row_rel_err(
            torch, o, ops.flash_decode_plain(q, ck, cv, kv_len)))
    last = dec_calls[-cfg.n_layers:]
    path_controls = {
        "decode_zero": max(control(
            torch, "zeroed attention", torch.zeros_like(o), o, ROW_ULP)
            for _, o in last),
        "decode_half_cache": min(control(
            torch, "attention over half the cache",
            ops.flash_decode_plain(q, ck, cv, kv_len // 2), o, ROW_ULP)
            for (q, ck, cv, kv_len), o in last)}
    del dec_calls, last
    plain_logits, _, plain_s = decode("xla", fed)

    # the flash-prefill kernel against the model's own attention, layer by
    # layer, in a prefill of the prompt's first PREFILL_REAL_S positions
    with recording(L, "causal_attention", []) as pre_calls:
        px_logits, _ = forward_with_cache(model, prompt[:1, :s0])
    pre_rel = 0.0
    for (q, k, v), o in pre_calls:
        pre_rel = max(pre_rel, row_rel_err(torch, ops.flash_prefill(q, k, v), o))
    (q, k, v), o = pre_calls[0]
    shifted = [torch.cat([t[:, :1], t[:, :-1]], dim=1) for t in (k, v)]
    path_controls["prefill_zero"] = control(
        torch, "zeroed prefill attention", torch.zeros_like(o), o, MODEL_ULPS)
    path_controls["prefill_mask_off_by_one"] = control(
        torch, "prefill attention with the mask one row late",
        ops.flash_prefill_plain(q, *shifted), o, MODEL_ULPS)
    del pre_calls, q, k, v, o, shifted
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    t_phase = phase_done("lm_main_path", t_phase)
    # where a flash decode step's time goes: two more steps (cache slots
    # past the checked ones) under torch.profiler, after the counts are read
    say("lm_decode_trace", **decode_trace(torch, tfm, model, cache, fed[-1],
                                          P + T))

    logit_err = max_err(torch, flash_logits, plain_logits)
    agree = int((flash_logits[..., :cfg.vocab].argmax(-1)
                 == plain_logits[..., :cfg.vocab].argmax(-1)).sum())
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (logits0, flash_logits, plain_logits, px_logits))
    step_err = (flash_logits - plain_logits).abs().flatten(1).amax(1)
    say("lm_check_steps", logits_std=f"{float(plain_logits.std()):.4g}",
        diff_std=f"{float((flash_logits - plain_logits).std()):.4g}",
        decode_logits_max_abs_err_per_step=",".join(
            f"{e:.3g}" for e in step_err.tolist()))
    say("lm_check", decode_attention_row_rel_err=f"{dec_rel:.4g}",
        decode_limit=ROW_ULP, prefill_attention_row_rel_err=f"{pre_rel:.4g}",
        prefill_limit=MODEL_ULPS, controls=json.dumps(
            {k: round(v, 4) for k, v in path_controls.items()}),
        decode_logits_max_abs_err=f"{logit_err:.4g}",
        argmax_agree=f"{agree}/{B * T}", finite=finite,
        flash_decode_launches_in_flash_pass=flash_launches, **launches)
    check(finite, "non-finite logits")
    check(dec_rel <= ROW_ULP, f"flash decode on the main path differs from "
          f"its plain version by {dec_rel} of a row's scale")
    check(pre_rel <= MODEL_ULPS, f"flash prefill differs from the model's "
          f"attention by {pre_rel} of a row's scale")
    check(logit_err < 5e-2, f"flash and plain decode logits differ by "
          f"{logit_err}")
    check(flash_launches == cfg.n_layers * T
          and launches["flash_decode"] == cfg.n_layers * T,
          f"flash_decode launched {flash_launches} times in the flash pass, "
          f"{launches['flash_decode']} in all; want {cfg.n_layers * T}")
    check(launches["flash_prefill"] == cfg.n_layers,
          f"flash_prefill launched {launches['flash_prefill']} times; want "
          f"{cfg.n_layers}")
    say("lm_memory", weight_bytes=weight_bytes, cache_bytes=cache_bytes,
        prefill_peak_bytes=prefill_peak,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("lm_prefill", tokens=B * P, seconds=f"{prefill_s:.3f}",
        tokens_per_s=f"{B * P / prefill_s:.1f}")
    for impl, step_s in (("flash", flash_s), ("xla", plain_s)):
        say("lm_decode", attn=impl, steps=T, batch=B,
            step_p50_ms=f"{percentile(step_s, 50) * 1e3:.3f}",
            step_p99_ms=f"{percentile(step_s, 99) * 1e3:.3f}",
            tokens_per_s=f"{B * T / sum(step_s):.1f}")

    replaces = {"flash_decode": "src/repro/kernels/flash_decode.py:67",
                "flash_prefill": "src/repro/kernels/flash_prefill.py:70"}
    kernels = []
    for name in ("flash_decode", "flash_prefill"):
        ms, plain_ms, (b_ms, b_by), lib_ms = timing[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})
    return kernels


# ---------------------------------------------------------------------------
# the MoE serving path
# ---------------------------------------------------------------------------

# (arch, batch, prompt tokens, greedy decode steps, cache slots or None):
# granite-moe at full depth with decode_32k's 32768-slot cache, as the
# dense LM phase; moonshot with its cache cut to what the run writes
MOE_RUNS = (("granite-moe-1b-a400m", 4, 4096, 16, 32768),
            ("moonshot-v1-16b-a3b", 2, 1024, 8, None))
MOE_TRACE_STEPS = 2            # flash steps under torch.profiler, after
                               # the checked ones
MOE_CACHE_CUT = (
    "decode_32k's 32768-slot cache cut to prompt + steps + the traced "
    "steps: at 32768 slots the bf16 cache is 48 x 32768 x 16 x 128 x 2 x 2 "
    "B = 12.9 GB a batch row, which does not fit beside the 56.1 GB of "
    "weights")
MOE_CHECK_TOKENS = 128         # prefill tokens of each checked layer (the
                               # CPU runs them in float32)
MOE_LAYER_ULPS = 2.0 ** -5     # the MoE layer on the card (bf16) against
                               # the CPU in float32 from the same bf16
                               # values, in units of a row's scale: h, u,
                               # their product, the expert output, the gate
                               # product and the K adds each round to bf16
                               # (one ulp, 2^-7, does not hold: ~1.6 ulps
                               # on the CPU at both widths)


def decode_cases_at(np, torch, rng, G, D):
    """Phase 5's flash-decode edge cases at query group G and head dim D:
    kv_len 0, 1, S, odd and past S; 64-row tiles with S % 64 != 0; one row
    past a 512-row chunk of the split, on one, shorter than one beside long
    rows (S 8192, B 4, 8 kv heads); float32 and bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for B, Hkv, S, kv_len, dt in [
            (2, 4, 96, [1, 96], f32),
            (3, 2, 1000, [0, 999, 517], f32),
            (2, 1, 777, [777, 5000], f32),
            (4, 4, 2048, [1, 2048, 1023, 0], bf16),
            (4, 8, 8192, [513, 1024, 100, 8192], bf16),
            (4, 8, 8192, [511, 512, 1, 0], bf16),
            (3, 2, 1000, [0, 1000, 5000], bf16),
            (3, 2, 1000, [65, 64, 63], f32)]:
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(device="cuda", dtype=dt)
                   for s in ((B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        cases.append((q, k, v, torch.tensor(kv_len, dtype=torch.int32,
                                            device="cuda")))
    return cases


def moe_layer_check(torch, moe, layer, x, mcfg):
    """The MoE layer on captured tokens x [T, D] (bf16, on the card) against
    the same function on the CPU in float32 from the same bf16 values (the
    router cast to bf16, as `route` casts it).  Returns the routing's
    (differs, gap, near_tie) per token and the row-relative and absolute
    errors on the tokens routed alike, with a control: the CPU's layer with
    K - 1 experts, which the check must refuse."""
    import dataclasses
    probs_c, _, idx_c = moe.route(x[None], layer.router, mcfg)
    y_c, _ = moe.moe_ffn(x, layer.router, layer.wg, layer.wu, layer.wd, mcfg,
                         x.dtype, dropless=True)
    xr = x.float().cpu()
    wr = [w.to(x.dtype).float().cpu() for w in
          (layer.router, layer.wg, layer.wu, layer.wd)]
    probs_r, _, idx_r = moe.route(xr[None], wr[0], mcfg)
    y_r, _ = moe.moe_ffn(xr, *wr, mcfg, torch.float32, dropless=True)
    y_k1, _ = moe.moe_ffn(xr, *wr, dataclasses.replace(
        mcfg, top_k=mcfg.top_k - 1), torch.float32, dropless=True)
    differs, gap, near = moe.routing_differences(probs_r, idx_r,
                                                 probs_c.cpu(), idx_c.cpu())
    alike = ~differs[0]
    y_c = y_c.cpu()
    return {"differs": differs[0], "gap": gap[0], "near": near[0],
            "rel": row_rel_err(torch, y_c[alike], y_r[alike]),
            "abs": max_err(torch, y_c[alike], y_r[alike]),
            "control_k_minus_1": control(
                torch, "MoE layer with K - 1 experts", y_k1[alike],
                y_r[alike], MOE_LAYER_ULPS)}


def moe_arch_phase(args, np, torch, arch, B, P, T, s_max) -> dict:
    """One MoE arch at full width and depth in bf16 (random weights from
    --seed): the flash-decode kernel at the arch's (G, D) against its plain
    version (edge cases; the path's real cache, flat and with needle rows;
    refused controls; timed beside bound, plain and SDPA), then the main
    path (`forward_with_cache`, T greedy flash `decode_step`s, the same
    steps teacher-forced through the plain attention), each layer's
    attention held against the plain version, the routing of the two
    passes compared (every difference a near tie), the logits compared
    where no layer routed differently, and the MoE layer itself held
    against its float32 counterpart on the CPU.  Returns the kernel's
    numbers at this arch."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import decode_split, flash_decode_info
    from repro_torch.launch.steps import forward_with_cache
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    t_start = t_phase = time.perf_counter()
    cfg = get_arch(arch).make_config()
    check(cfg.dtype == torch.bfloat16 and cfg.moe is not None,
          f"{arch} is not a bf16 MoE model")
    cut = None
    if s_max is None:
        s_max = P + T + MOE_TRACE_STEPS
        cut = MOE_CACHE_CUT
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = tfm.init_params(tfm.serving_config(cfg), gen, "cuda")
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    torch.cuda.synchronize()
    Lx, mcfg = cfg.n_layers, cfg.moe
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = hq // hkv
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_bytes = 2 * Lx * B * s_max * hkv * hd * 2
    padded = 1 - mcfg.top_k / mcfg.n_experts
    say("moe_model", arch=arch, layers=Lx, d_model=cfg.d_model, heads=hq,
        kv_heads=hkv, head_dim=hd, group=G, experts=mcfg.n_experts,
        top_k=mcfg.top_k, d_expert=mcfg.d_expert, vocab=cfg.vocab,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        weight_bytes=weight_bytes, cache_bytes=cache_bytes, batch=B,
        prompt=P, steps=T, cache_len=s_max,
        dispatch_padded_share=f"{padded:.4f}")
    if cut:
        say("moe_model", arch=arch, cut=json.dumps(cut))
    chunk, n_split = decode_split(s_max, B, hkv)
    say("kernel_design", name="flash_decode", arch=arch, group=G,
        cache=f"[{B},{s_max},{hkv},{hd}]", chunk_rows=chunk, n_split=n_split,
        ctas=B * hkv * n_split, cuda_launches_per_call=2,
        **flash_decode_info(hd, cfg.dtype, G))
    t_phase = phase_done(f"moe_init_{arch}", t_phase)

    # -- the flash-decode kernel at this arch's (G, D) ------------------------
    rng = np.random.default_rng(args.seed + G * hd)
    dq = torch.randn((B, hq, hd), generator=gen, device="cuda").to(cfg.dtype)
    dk, dv = (torch.randn((B, s_max, hkv, hd), generator=gen, device="cuda")
              .to(cfg.dtype) for _ in range(2))
    d_len = torch.full((B,), P, dtype=torch.int32, device="cuda")
    nk, nv = needle_cache(torch, dq, dk, dv, d_len)
    err = rel = 0.0
    for q, k, v, kv_len in decode_cases_at(np, torch, rng, G, hd) + [
            (dq, dk, dv, d_len), (dq, nk, nv, d_len)]:
        e, r = hold(torch, f"flash_decode != plain at q{tuple(q.shape)} "
                    f"k{tuple(k.shape)} {q.dtype} kv_len {kv_len.tolist()}",
                    ops.flash_decode(q, k, v, kv_len),
                    ops.flash_decode_plain(q, k, v, kv_len))
        err, rel = max(err, e), max(rel, r)
    want_needle = ops.flash_decode_plain(dq, nk, nv, d_len)
    controls = {
        "decode_zero": control(torch, "zeroed decode", torch.zeros_like(
            want_needle), want_needle, ROW_ULP),
        "decode_kv_len_minus_1": control(
            torch, "decode at kv_len - 1",
            ops.flash_decode(dq, nk, nv, d_len - 1), want_needle, ROW_ULP)}
    del nk, nv, want_needle

    def sdpa_decode():
        mask = (torch.arange(s_max, device="cuda")[None] < d_len[:, None])
        return F.scaled_dot_product_attention(
            dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
            attn_mask=mask[:, None, None], enable_gqa=True)[:, :, 0]

    b_ms, b_by = bound_ms(*decode_bound(torch, dq, dk, d_len),
                          FLOPS_PER_S[str(cfg.dtype)])
    kernel = {"arch": arch, "shape": f"q{tuple(dq.shape)}k{tuple(dk.shape)}"
              f"kv_len{P}", "group": G, "head_dim": hd,
              "ms": time_cuda_ms(torch, lambda: ops.flash_decode(
                  dq, dk, dv, d_len)),
              "plain_ms": time_cuda_ms(torch, lambda: ops.flash_decode_plain(
                  dq, dk, dv, d_len)),
              "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": time_cuda_ms(torch, sdpa_decode),
              "max_abs_err": err, "row_rel_err": rel}
    say("moe_kernel_check", arch=arch, flash_decode_max_abs_err=f"{err:.4g}",
        flash_decode_row_rel_err=f"{rel:.4g}", limit=ROW_ULP,
        controls=json.dumps({k: round(v, 4) for k, v in controls.items()}),
        **{k: (f"{v:.5f}" if isinstance(v, float) else v)
           for k, v in kernel.items() if k.endswith("ms")},
        bound_share=f"{kernel['bound_ms'] / kernel['ms']:.3f}")
    del dq, dk, dv
    torch.cuda.empty_cache()
    t_phase = phase_done(f"moe_kernel_{arch}", t_phase)

    # -- main path: prefill, greedy flash decode, plain decode ---------------
    ops.flash_decode_cuda.launches = 0
    with recording(moe, "route", []) as pre_routes:
        t0 = time.perf_counter()
        logits0, pcache = forward_with_cache(model, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    check_layers = sorted({0, Lx // 2, Lx - 1})    # first, middle, last
    pre_x = {li: pre_routes[li][0][0][0, :MOE_CHECK_TOKENS].clone()
             for li in check_layers}
    del pre_routes
    cache = tfm.init_cache(cfg, B, s_max, device="cuda")
    for f in ("k", "v"):
        cache[f][:, :, :P].copy_(pcache[f])
    del pcache
    torch.cuda.empty_cache()

    def decode(impl, feed, past=None):
        return decode_steps(torch, tfm, model, cache, logits0, P, T, impl,
                            feed, past)

    with recording(ops, "flash_decode", []) as dec_calls, \
            recording(moe, "route", []) as flash_routes:
        flash_logits, fed, flash_s = decode("flash", None)
    launches = ops.flash_decode_cuda.launches
    dec_rel = 0.0
    for (q, ck, cv, kv_len), o in dec_calls:
        dec_rel = max(dec_rel, row_rel_err(
            torch, o, ops.flash_decode_plain(q, ck, cv, kv_len)))
    last = dec_calls[-Lx:]
    path_controls = {
        "decode_zero": max(control(
            torch, "zeroed attention", torch.zeros_like(o), o, ROW_ULP)
            for _, o in last),
        "decode_half_cache": min(control(
            torch, "attention over half the cache",
            ops.flash_decode_plain(q, ck, cv, kv_len // 2), o, ROW_ULP)
            for (q, ck, cv, kv_len), o in last)}
    dec_x = {li: flash_routes[li][0][0][0].clone() for li in check_layers}
    del dec_calls, last
    # teacher-forced through the plain attention, each step on the cache
    # the flash step read: the two passes differ only within a step
    flash_past = {f: cache[f][:, :, P:P + T].clone() for f in ("k", "v")}
    with recording(moe, "route", []) as plain_routes:
        plain_logits, _, plain_s = decode("xla", fed, flash_past)
    del flash_past

    # the two passes' routing, layer by layer: a row routed differently in
    # a layer feeds the later layers of its step other inputs, so it is
    # compared no further in that step and its logits are left out there
    check(len(flash_routes) == len(plain_routes) == Lx * T,
          f"{len(flash_routes)} / {len(plain_routes)} routings, want {Lx * T}")
    compared = torch.ones((T, B), dtype=torch.bool)
    ties = []
    for i, ((_, fo), (_, po)) in enumerate(zip(flash_routes, plain_routes)):
        t, li = divmod(i, Lx)
        differs, gap, near = (a[0].cpu() for a in moe.routing_differences(
            fo[0], fo[2], po[0], po[2]))
        new = differs & compared[t]
        for b in torch.nonzero(new).flatten().tolist():
            check(bool(near[b]), f"{arch}: step {t} layer {li} row {b} "
                  f"routed differently by flash and plain decode with a gap "
                  f"of {float(gap[b]):.3g} between its K-th and (K+1)-th "
                  f"expert, wider than the two passes' difference")
            ties.append({"step": t, "layer": li, "row": b,
                         "gap": float(f"{float(gap[b]):.3g}")})
        compared[t] &= ~new
    del flash_routes, plain_routes
    step_err = (flash_logits - plain_logits).abs().amax(-1).cpu()   # [T, B]
    logit_err = float(step_err[compared].max()) if compared.any() else 0.0
    finite = all(bool(torch.isfinite(x).all())
                 for x in (logits0, flash_logits, plain_logits))
    agree = int((flash_logits[..., :cfg.vocab].argmax(-1)
                 == plain_logits[..., :cfg.vocab].argmax(-1)).sum())
    torch.cuda.synchronize()
    t_phase = phase_done(f"moe_main_path_{arch}", t_phase)
    say("moe_decode_trace", arch=arch, **decode_trace(
        torch, tfm, model, cache, fed[-1], P + T, steps=MOE_TRACE_STEPS))

    # -- the MoE layer itself against float32 on the CPU ----------------------
    layer_checks = {}
    for li in check_layers:
        for kind, x in (("prefill", pre_x[li]), ("decode", dec_x[li])):
            layer_checks[(kind, li)] = moe_layer_check(
                torch, moe, model.layers[li], x, mcfg)
    del pre_x, dec_x
    layer_ties = [{"layer": li, "kind": kind, "token": j,
                   "gap": float(f"{float(c['gap'][j]):.3g}")}
                  for (kind, li), c in layer_checks.items()
                  for j in torch.nonzero(c["differs"]).flatten().tolist()]
    layer_rel = max(c["rel"] for c in layer_checks.values())
    layer_abs = max(c["abs"] for c in layer_checks.values())
    layer_control = min(c["control_k_minus_1"] for c in layer_checks.values())
    layer_faults = [(k, j) for k, c in layer_checks.items()
                    for j in torch.nonzero(c["differs"] & ~c["near"])
                    .flatten().tolist()]
    t_phase = phase_done(f"moe_layer_check_{arch}", t_phase)

    say("moe_check", arch=arch, decode_attention_row_rel_err=f"{dec_rel:.4g}",
        decode_limit=ROW_ULP, controls=json.dumps(
            {k: round(v, 4) for k, v in path_controls.items()}),
        decode_logits_max_abs_err=f"{logit_err:.4g}",
        logits_compared=f"{int(compared.sum())}/{T * B}",
        routing_near_ties=json.dumps(ties), argmax_agree=f"{agree}/{B * T}",
        finite=finite, flash_decode_launches=launches)
    say("moe_layer_check", arch=arch, layers=",".join(map(str, check_layers)),
        tokens=f"{MOE_CHECK_TOKENS} prefill + {B} decode a layer",
        row_rel_err=f"{layer_rel:.4g}", limit=MOE_LAYER_ULPS,
        max_abs_err=f"{layer_abs:.4g}", abs_limit=5e-2,
        control_k_minus_1=f"{layer_control:.4g}",
        near_ties=json.dumps(layer_ties), faults=len(layer_faults))
    check(finite, f"{arch}: non-finite logits")
    check(dec_rel <= ROW_ULP, f"{arch}: flash decode on the main path "
          f"differs from its plain version by {dec_rel} of a row's scale")
    check(logit_err < 5e-2, f"{arch}: flash and plain decode logits differ "
          f"by {logit_err} where every layer routed alike")
    check(launches == Lx * T, f"{arch}: flash_decode launched {launches} "
          f"times in the flash pass; want {Lx * T}")
    check(not layer_faults, f"{arch}: the MoE layer on the card routes "
          f"{layer_faults} differently from float32, not at a near tie")
    check(layer_abs < 5e-2 and layer_rel <= MOE_LAYER_ULPS,
          f"{arch}: the MoE layer differs from float32 by {layer_abs} "
          f"({layer_rel} of a row's scale)")
    say("moe_memory", arch=arch, weight_bytes=weight_bytes,
        cache_bytes=cache_bytes, prefill_peak_bytes=prefill_peak,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("moe_prefill", arch=arch, tokens=B * P, seconds=f"{prefill_s:.3f}",
        tokens_per_s=f"{B * P / prefill_s:.1f}")
    for impl, step_s in (("flash", flash_s), ("xla", plain_s)):
        say("moe_decode", arch=arch, attn=impl, steps=T, batch=B,
            step_p50_ms=f"{percentile(step_s, 50) * 1e3:.3f}",
            step_p99_ms=f"{percentile(step_s, 99) * 1e3:.3f}",
            tokens_per_s=f"{B * T / sum(step_s):.1f}")
    phase_done(f"moe_{arch}", t_start)
    kernel["launches"] = launches
    return kernel


def moe_phases(args, np, torch) -> list:
    """Phase 6b: MoE serving, each arch of MOE_RUNS in turn with the memory
    of the one before handed back (`moe_arch_phase`), then the launcher
    `serve_lm` of both on the card against the port on the CPU (the same
    smoke weights: the first 10 tokens must be equal).  Returns the
    flash-decode kernel's numbers at each arch."""
    from repro_torch.launch.serve import serve_lm
    t_start = time.perf_counter()
    out = []
    for arch, B, P, T, s_max in MOE_RUNS:
        out.append(moe_arch_phase(args, np, torch, arch, B, P, T, s_max))
        gc.collect()
        torch.cuda.empty_cache()
    for arch, *_ in MOE_RUNS:
        card = serve_lm(arch, 10, device="cuda")
        cpu = serve_lm(arch, 10, device="cpu")
        say("moe_launcher", arch=arch, card=card, cpu=cpu)
        check(card == cpu, f"{arch}: serve_lm's first 10 tokens on the card "
              f"{card} differ from the CPU's {cpu}")
    phase_done("moe", t_start)
    return out


# ---------------------------------------------------------------------------
# the recsys serving path
# ---------------------------------------------------------------------------

def bag_bound(torch, table, ids, weighted):
    """Least bytes and flops of an embedding-bag call on these inputs: of
    the table only the 32-byte sectors of the distinct rows that the valid
    ids name (ids >= V read the last row), each once; the int32 ids, the
    weights when given and the float32 output once.  Two flops (multiply,
    add) per valid id and column."""
    V, D = table.shape
    valid = ids >= 0
    rows = torch.unique(ids[valid].clamp(max=V - 1).long())
    row_bytes = D * table.element_size()
    first, last = rows * row_bytes // 32, ((rows + 1) * row_bytes - 1) // 32
    n_sectors = 0
    if rows.numel():
        span = int((last - first).max()) + 1
        sec = first[:, None] + torch.arange(span, device=rows.device)
        n_sectors = int(torch.unique(sec[sec <= last[:, None]]).numel())
    B, F = ids.shape
    nbytes = (32 * n_sectors + 4 * B * F + 4 * B * D
              + (B * F * table.element_size() if weighted else 0))
    return nbytes, 2 * int(valid.sum()) * D


def bag_ok(torch, got, want, exact):
    """The embedding-bag check: equal where `exact` (unweighted float32
    bags: the kernel adds in the plain version's order), else the
    absolute tolerance of the dtype and, in bf16, one bf16 ulp of each
    output row's largest value."""
    if exact:
        return torch.equal(got, want)
    return (max_err(torch, got, want) < tol_of(torch, got)
            and (got.dtype == torch.float32
                 or row_rel_err(torch, got, want) <= ROW_ULP))


def bag_cases(np, torch, rng):
    """Seeded edge cases of the embedding-bag kernel: (table, ids, weights,
    combine) on the card.  The kernel's tile edges (kernels/edge_cases.py:
    a ragged last tile, tiles off 16-byte boundaries, fields in stages, D
    = 1, all-pad bags at tile edges) in float32 and bf16, and in float32
    again with ids and weights as views 4 bytes past a 16-byte boundary;
    a float32 table of 4.6 GB read past its first 4 GiB; then D in {1, 10,
    16, 32, 64, 128}; B = 1 and F = 1; ~10% pads, an all-pad bag, an id
    past the table; sum and mean; with and without weights; float32 and
    bf16."""
    from repro_torch.kernels.edge_cases import (BAG_EDGE_CASES, bag_edge_case,
                                                bag_past_4gib, offset_view)
    cases = []
    for name in BAG_EDGE_CASES:
        table, ids, w, _ = bag_edge_case(name)
        for dt in (torch.float32, torch.bfloat16):
            cases.append((torch.from_numpy(table).to("cuda", dt),
                          torch.from_numpy(ids).to("cuda"),
                          None if w is None else torch.from_numpy(w).to("cuda"),
                          "sum"))
        t, i, w_, c = cases[-2]
        cases.append((t, offset_view(i),
                      None if w_ is None else offset_view(w_), c))
    big, ids = bag_past_4gib("cuda")
    check(bool((ids.long() * big.shape[1] * 4 >= 2**32).any()),
          "the 4.6 GB bag case reads no row past 4 GiB")
    cases.append((big, ids, None, "sum"))
    shapes = [(1, 1), (7, 13), (300, 39), (2, 50)]
    for i, D in enumerate((1, 10, 16, 32, 64, 128)):
        for dt in (torch.float32, torch.bfloat16):
            for j, (weighted, combine) in enumerate(
                    ((False, "sum"), (True, "mean"), (False, "mean"),
                     (True, "sum"))):
                B, F = shapes[(i + j) % len(shapes)]
                V = int(rng.integers(5, 3000))
                ids = rng.integers(0, V, (B, F)).astype(np.int32)
                ids[rng.random((B, F)) < 0.1] = -1
                if B > 1:
                    ids[0] = -1
                ids[-1, -1] = V + int(rng.integers(0, 9))
                table = rng.normal(size=(V, D)).astype(np.float32)
                w = (torch.from_numpy(rng.normal(size=(B, F)).astype(np.float32))
                     .to("cuda") if weighted else None)
                cases.append((torch.from_numpy(table).to("cuda", dt),
                              torch.from_numpy(ids).to("cuda"), w, combine))
    return cases


def recsys_batch(torch, batch, device="cuda"):
    """A numpy ClickLog batch as torch tensors on `device`, labels dropped."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k != "label"}


def timed_steps(torch, step, model, batch, reps):
    """One warm-up step, then `reps` steps: (last output, host seconds per
    step, each ending in a synchronize)."""
    out = step(model, batch)
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step(model, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def report_qps(arch, shape, rows, secs, candidates=0):
    """Queries (batch rows) per second over the steps and step p50 / p99;
    for retrieval also candidates scored per second."""
    extra = ({"candidates_per_s": f"{candidates * len(secs) / sum(secs):.1f}"}
             if candidates else {})
    say("recsys_qps", model=arch, shape=shape, batch=rows, steps=len(secs),
        qps=f"{rows * len(secs) / sum(secs):.1f}",
        p50_ms=f"{percentile(secs, 50) * 1e3:.3f}",
        p99_ms=f"{percentile(secs, 99) * 1e3:.3f}", **extra)


def score_err(torch, got, want):
    """(max abs error, that error over the largest |want|): scores on the
    card against the CPU's.  MIND's scores are ~1e-4, where an absolute
    2e-5 alone would pass zeros, so both are held to 2e-5."""
    e = max_err(torch, got.cpu(), want)
    return e, e / max(float(want.abs().max()), 1e-30)


def same_top(torch, idx, want_scores, tol=2e-5):
    """The retrieval step's top-k indices `idx` [1, k] against scores
    computed elsewhere (the CPU's), `want_scores` [1, C]: at every rank the
    candidate's score there equals the score of that rank there within
    `tol`, and where that rank's score is more than `tol` from its
    neighbours the index is the same.  Returns (ranks apart, of them
    equal, ranks whose index is equal in all)."""
    ws = want_scores[0].double()
    order = torch.sort(want_scores[0], descending=True, stable=True)
    k = idx.shape[1]
    full = order.values.double()
    gap = torch.minimum(
        torch.cat([full[:1].new_full((1,), math.inf), full[:-1] - full[1:]]),
        torch.cat([full[:-1] - full[1:], full[:1].new_full((1,), math.inf)]))
    apart = (gap > tol)[:k]
    got = idx[0].to(ws.device)
    check(float((ws[got] - full[:k]).abs().max()) <= tol,
          "retrieval top-k: a rank holds a candidate whose score differs")
    equal = got == order.indices[:k]
    check(bool(equal[apart].all()), "retrieval top-k differs where the "
          "scores are apart")
    return int(apart.sum()), int(equal[apart].sum()), int(equal.sum())


def recsys_kernel_inputs(np, torch, seed, rng) -> dict:
    """FM and MIND at full width on the card (random weights from `seed`,
    in that order from one generator, `gen`), FM's ClickLog batches at
    serve_p99, serve_bulk and retrieval_cand, MIND's log, and `real`: the
    embedding bag's real shapes, name -> (table, int32 ids, weights,
    combine) — FM's table and linear term over serve_bulk's ids, FM's
    table over the 1,000,000 retrieval rows, MIND's item table pooling
    serve_bulk's histories, by mean and with weights drawn from `rng`."""
    from repro_torch.configs.registry import RECSYS_SHAPES, get_arch
    from repro_torch.data.recsys_data import ClickLog
    from repro_torch.models import recsys as rec
    p99, bulk = (RECSYS_SHAPES[s]["batch"] for s in ("serve_p99", "serve_bulk"))
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm_cfg = get_arch("fm").make_config()
    fm = rec.init_params(fm_cfg, gen, "cuda")
    fm_log = ClickLog(fm_cfg.field_vocabs, item_vocab=fm_cfg.item_vocab,
                      seq_len=fm_cfg.seq_len, seed=seed)
    fm_batches = {"serve_p99": recsys_batch(torch, fm_log.ctr_batch(p99)),
                  "serve_bulk": recsys_batch(torch, fm_log.ctr_batch(bulk)),
                  "retrieval_cand": recsys_batch(
                      torch, fm_log.retrieval_batch(1, n_cand))}
    mind_cfg = get_arch("mind").make_config()
    mind = rec.init_params(mind_cfg, gen, "cuda")
    mind_log = ClickLog(mind_cfg.field_vocabs, item_vocab=mind_cfg.item_vocab,
                        seq_len=mind_cfg.seq_len, seed=seed)
    hist = torch.from_numpy(mind_log.seq_batch(bulk)["hist"]).to("cuda")

    def rows32(batch_ids, cfg):
        return (batch_ids.long() + cfg.field_offsets("cuda")[None]).int()

    hw = torch.from_numpy(rng.normal(size=tuple(hist.shape)).astype(
        np.float32)).to("cuda")
    fm_bulk_rows = rows32(fm_batches["serve_bulk"]["ids"], fm_cfg)
    ret = fm_batches["retrieval_cand"]
    ret_ids = ret["ids"].expand(n_cand, -1).clone()
    ret_ids[:, -1] = ret["cand"] % fm_cfg.field_vocabs[-1]
    real = {
        "fm_table_serve_bulk": (fm.table, fm_bulk_rows, None, "sum"),
        "fm_w_lin_serve_bulk": (fm.w_lin, fm_bulk_rows, None, "sum"),
        "fm_table_retrieval": (fm.table, rows32(ret_ids, fm_cfg), None, "sum"),
        "mind_hist_mean": (mind.item_table, hist, None, "mean"),
        "mind_hist_weighted": (mind.item_table, hist, hw, "sum")}
    return {"gen": gen, "fm_cfg": fm_cfg, "fm": fm, "fm_batches": fm_batches,
            "mind_cfg": mind_cfg, "mind": mind, "mind_log": mind_log,
            "real": real}


def recsys_phases(args, np, torch) -> list:
    """Phases 7-8: recsys serving.  The embedding-bag kernel against its
    plain version (seeded edge cases; at FM's and MIND's real shapes, timed
    beside its bound, plain version and `embedding_bag`), each check shown
    to refuse a wrong output; FM at full width through `recsys_serve_step`
    (serve_p99, serve_bulk) and `recsys_retrieval_step` (retrieval_cand),
    every `segment_bag` call of it held against the plain version and
    counted; then AutoInt, BST and MIND at full width.  Returns the
    kernel's entry of the `kernels` line."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import RECSYS_SHAPES, get_arch
    from repro_torch.data.recsys_data import ClickLog
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_bag import (bag_tile, bag_vec,
                                                 segment_bag_info)
    from repro_torch.launch.steps import (recsys_retrieval_step,
                                          recsys_serve_step)
    from repro_torch.models import recsys as rec

    t_phase = t_start = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products must not run in TF32 for the recsys checks")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(args.seed)
    p99, bulk = (RECSYS_SHAPES[s]["batch"] for s in ("serve_p99", "serve_bulk"))
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]

    # -- 7. the embedding-bag kernel against its plain version ---------------
    err, n_cases, n_exact, controls, edge = 0.0, 0, 0, {}, None

    def held(table, ids, w, combine):
        """The kernel's output checked against the plain version's, which
        it returns."""
        nonlocal err, n_cases, n_exact
        got = ops.segment_bag(table, ids, w, combine)
        want = ops.segment_bag_plain(table, ids, w, combine)
        e = max_err(torch, got, want)
        check(bag_ok(torch, got, want, w is None
                     and table.dtype == torch.float32),
              f"segment_bag != plain at table {tuple(table.shape)} "
              f"{table.dtype} ids {tuple(ids.shape)} weights "
              f"{w is not None} {combine}: max abs err {e}")
        err, n_cases = max(err, e), n_cases + 1
        n_exact += int(torch.equal(got, want))
        return want

    for table, ids, w, combine in bag_cases(np, torch, rng):
        want = held(table, ids, w, combine)
        if (edge is None and table.dtype == torch.float32 and w is None
                and ids.shape[0] > 1):
            edge = (table, ids, want, combine)

    def refused(name, wrong, want, exact):
        check(not bag_ok(torch, wrong, want, exact),
              f"control {name} passes the segment_bag check")
        controls[name] = round(row_rel_err(torch, wrong, want), 4)

    def refuse_all(tag, table, ids, want, combine="sum"):
        exact = table.dtype == torch.float32
        refused(f"{tag}_zero", torch.zeros_like(want), want, exact)
        refused(f"{tag}_last_field_dropped", ops.segment_bag_plain(
            table, ids[:, :-1].contiguous(), None, combine), want, exact)
        if bool((ids < 0).any()):
            refused(f"{tag}_pad_as_row_0", ops.segment_bag_plain(
                table, ids.clamp(min=0), None, combine), want, exact)

    refuse_all("edge", *edge)
    del edge
    t_phase = phase_done("recsys_kernel_edge_cases", t_phase)

    # the models whose tables the real shapes read, their batches, and
    # the real shapes
    m = recsys_kernel_inputs(np, torch, args.seed, rng)
    fm_cfg, fm, fm_batches = m["fm_cfg"], m["fm"], m["fm_batches"]
    mind_cfg, mind, mind_log, gen = (m["mind_cfg"], m["mind"],
                                     m["mind_log"], m["gen"])
    real = m["real"]
    ret = fm_batches["retrieval_cand"]
    del m
    torch.cuda.synchronize()
    say("recsys_models", fm_table=tuple(fm.table.shape),
        fm_w_lin=tuple(fm.w_lin.shape), mind_item_table=tuple(
            mind.item_table.shape), fm_params=fm_cfg.param_count(),
        mind_params=mind_cfg.param_count())
    t_phase = phase_done("recsys_init", t_phase)

    # -- 7. ... at the real shapes -------------------------------------------
    real_timing = {}
    for name, (table, ids, w, combine) in real.items():
        want = held(table, ids, w, combine)
        if name in ("fm_table_serve_bulk", "mind_hist_mean"):
            refuse_all(name, table, ids, want, combine)
        # embedding_bag takes no negative ids: pads become row 0 with a
        # zero per-sample weight (the mean's 1 / count folded in)
        valid = ids >= 0
        lib_ids = ids.clamp(0, table.shape[0] - 1)
        lib_w = None
        if w is not None or not bool(valid.all()):
            lib_w = valid.to(table.dtype) * (1 if w is None else w)
            if combine == "mean":
                lib_w = lib_w / valid.sum(1, keepdim=True).clamp(min=1)
        lib_mode = "mean" if combine == "mean" and lib_w is None else "sum"

        def lib(table=table, lib_ids=lib_ids, lib_w=lib_w, lib_mode=lib_mode):
            return F.embedding_bag(lib_ids, table, mode=lib_mode,
                                   per_sample_weights=lib_w)

        lib_err = max_err(torch, lib(), want)
        real_timing[name] = (
            time_cuda_ms(torch, lambda: ops.segment_bag(table, ids, w, combine)),
            time_cuda_ms(torch, lambda: ops.segment_bag_plain(
                table, ids, w, combine), iters=5),
            bound_ms(*bag_bound(torch, table, ids, w is not None),
                     FLOPS_PER_S["torch.float32"]),
            time_cuda_ms(torch, lib))
        ms, plain_ms, (b_ms, b_by), lib_ms = real_timing[name]
        esize = table.element_size()
        tile = bag_tile(ids.shape[0], ids.shape[1], table.shape[1], esize,
                        w is not None, bag_vec(table.shape[1], esize,
                                               table.data_ptr()))
        say("kernel_design", name="segment_bag", shape=name,
            **tile._asdict(), **segment_bag_info(table.dtype, tile,
                                                 w is not None))
        say("recsys_kernel_shape", name=name, table=tuple(table.shape),
            ids=tuple(ids.shape), pads=int((~valid).sum()),
            weights=w is not None, combine=combine, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            embedding_bag_ms=f"{lib_ms:.4f}",
            embedding_bag_vs_plain=f"{lib_err:.3g}")
        del want, valid, lib_ids, lib_w
    del real
    say("recsys_kernel_check", cases=n_cases, exact=n_exact,
        max_abs_err=f"{err:.4g}", controls=json.dumps(controls))
    torch.cuda.empty_cache()
    t_phase = phase_done("recsys_kernels", t_phase)

    # -- 8. FM main path at full width ---------------------------------------
    fm_cpu = rec.RecSysModel(fm_cfg, "cpu")
    fm_cpu.load_state_dict(fm.state_dict())
    ops.segment_bag_cuda.launches = 0
    reps = {"serve_p99": 30, "serve_bulk": 5, "retrieval_cand": 3}
    outs = {}
    with recording(ops, "segment_bag", []) as calls:
        for shape, batch in fm_batches.items():
            retrieval = shape == "retrieval_cand"
            step = recsys_retrieval_step if retrieval else recsys_serve_step
            outs[shape], secs = timed_steps(torch, step, fm, batch,
                                            reps[shape])
            report_qps("fm", shape, batch["ids"].shape[0], secs,
                       n_cand if retrieval else 0)
    launches = ops.segment_bag_cuda.launches
    fm_steps = 2 * sum(r + 1 for r in reps.values())
    check(len(calls) == fm_steps and launches == len(calls),
          f"segment_bag launched {launches} times for {len(calls)} calls on "
          f"the FM path; want {fm_steps}")
    for (table, ids), out in calls:
        check(torch.equal(out, ops.segment_bag_plain(table, ids)),
              f"segment_bag on the FM path != plain at ids "
              f"{tuple(ids.shape)}")
    n_calls = len(calls)
    del calls
    scores_p99 = outs["serve_p99"]
    want_p99 = recsys_serve_step(fm_cpu, {
        k: v.cpu() for k, v in fm_batches["serve_p99"].items()})
    e_p99 = score_err(torch, scores_p99, want_p99)
    cpu_ret = {k: v.cpu() for k, v in ret.items()}
    want_ret = rec.retrieval_scores(fm_cpu, cpu_ret)
    got_ret = rec.retrieval_scores(fm, ret)
    e_ret = score_err(torch, got_ret, want_ret)
    vals, idx = outs["retrieval_cand"]
    top = same_top(torch, idx, want_ret)
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (scores_p99, outs["serve_bulk"], got_ret, vals))
    say("recsys_check", model="fm", serve_p99_vs_cpu=f"{e_p99[0]:.4g}",
        serve_p99_vs_cpu_of_scale=f"{e_p99[1]:.4g}",
        retrieval_vs_cpu=f"{e_ret[0]:.4g}",
        retrieval_vs_cpu_of_scale=f"{e_ret[1]:.4g}", top128_ranks_apart=top[0],
        top128_equal_where_apart=top[1], top128_equal=top[2], finite=finite,
        segment_bag_calls=n_calls, segment_bag_launches=launches,
        shapes=json.dumps({k: list(v.shape) for k, v in
                           (("serve_p99", scores_p99),
                            ("serve_bulk", outs["serve_bulk"]),
                            ("retrieval_top", idx))}))
    check(finite, "non-finite FM scores")
    check(max(e_p99 + e_ret) <= 2e-5, f"FM scores on the card differ from "
          f"the CPU's: serve_p99 {e_p99}, retrieval {e_ret} (abs, of scale)")
    # FM's ties are exact on both devices (its sums run in a fixed order
    # per row), so the whole top 128 is the CPU's
    check(top[2] == idx.shape[1], f"FM top-128 indices equal the CPU's at "
          f"{top[2]} ranks")
    check(tuple(outs["serve_bulk"].shape) == (bulk,)
          and tuple(idx.shape) == (1, 128), "FM output shapes")
    del fm_cpu, outs, want_ret, got_ret, cpu_ret, vals, idx, ret
    torch.cuda.empty_cache()
    t_phase = phase_done("recsys_fm_main_path", t_phase)

    # -- 8. AutoInt, BST and MIND at full width ------------------------------
    say("recsys_cut", model="mind", shape="serve_bulk", reason=json.dumps(
        f"serve_scores takes the diagonal of mind_train_logits, a [B, B] "
        f"float32 matrix: {4 * bulk * bulk / 1e9:.0f} GB at B {bulk}"))
    for arch in ("autoint", "bst"):
        say("recsys_cut", model=arch, shape="retrieval_cand",
            candidates=RETRIEVAL_CUT, reason=json.dumps(RETRIEVAL_CUT_WHY))
    del fm, fm_batches
    for arch in ("autoint", "bst", "mind"):
        if arch == "mind":
            cfg, model, log = mind_cfg, mind, mind_log
        else:
            cfg = get_arch(arch).make_config()
            model = rec.init_params(cfg, gen, "cuda")
            log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                           seq_len=cfg.seq_len, seed=args.seed)
        seq = arch != "autoint"
        small = log.seq_batch(p99) if seq else log.ctr_batch(p99)
        scores, secs = timed_steps(torch, recsys_serve_step, model,
                                   recsys_batch(torch, small), 10)
        report_qps(arch, "serve_p99", p99, secs)
        cpu_model = rec.RecSysModel(cfg, "cpu")
        cpu_model.load_state_dict(model.state_dict())
        e = score_err(torch, scores, recsys_serve_step(
            cpu_model, recsys_batch(torch, small, "cpu")))
        del cpu_model
        outs = [scores]
        if arch != "mind":
            big = log.seq_batch(bulk) if seq else log.ctr_batch(bulk)
            out, secs = timed_steps(torch, recsys_serve_step, model,
                                    recsys_batch(torch, big), 3)
            report_qps(arch, "serve_bulk", bulk, secs)
            check(tuple(out.shape) == (bulk,), f"{arch} serve_bulk shape")
            outs.append(out)
            del big, out
        c = n_cand if arch == "mind" else min(n_cand, RETRIEVAL_CUT)
        (vals, idx), secs = timed_steps(
            torch, recsys_retrieval_step, model,
            recsys_batch(torch, log.retrieval_batch(1, c)), 3)
        report_qps(arch, "retrieval_cand", 1, secs, c)
        outs.append(vals)
        finite = all(bool(torch.isfinite(x).all()) for x in outs)
        say("recsys_check", model=arch, serve_p99_vs_cpu=f"{e[0]:.4g}",
            serve_p99_vs_cpu_of_scale=f"{e[1]:.4g}", finite=finite, retrieval_candidates=c,
            retrieval_top=list(idx.shape))
        check(finite, f"non-finite {arch} scores")
        check(max(e) <= 2e-5, f"{arch} serve_p99 scores on the card differ "
              f"from the CPU's by {e} (abs, of scale)")
        check(tuple(idx.shape) == (1, 128), f"{arch} retrieval top-k shape")
        del model, log, outs, vals, idx, scores
        torch.cuda.empty_cache()
    del mind
    say("recsys_memory", max_memory_allocated=torch.cuda.max_memory_allocated())
    phase_done("recsys_other_models", t_phase)
    phase_done("recsys", t_start)

    ms, plain_ms, (b_ms, b_by), lib_ms = real_timing["fm_table_serve_bulk"]
    return [{"name": "segment_bag", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/segment_bag.cu",
             "replaces": "src/repro/kernels/segment_bag.py:33",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


# ---------------------------------------------------------------------------
# training (phase 8b)
# ---------------------------------------------------------------------------

TRAIN_CHECK_ARCHS = ("llama3-8b", "granite-moe-1b-a400m")  # (a), smoke size
TRAIN_CHECK_SHAPE = (4, 64)    # (a): batch and sequence of the one step
TRAIN_TOL = 2e-5               # the model zoo's float32 tolerance
TRAIN_MOE_ARCH = "granite-moe-1b-a400m"
TRAIN_MOE_BATCH = 4
TRAIN_MOE_STEPS = 6
TRAIN_MOE_CUT = (
    "train_4k (configs/registry.py: seq 4096, global batch 256) with the "
    "batch cut to 4: one card holds 22.2 GB of float32 params, grads, m and "
    "v (1.385 G x 16 B), ~5.4 GB a row of S x S float32 attention inside "
    "the layer being recomputed and ~3.2 GB a row of [4096, 49408] float32 "
    "logits with their gradient: batch 4 peaks near 40 GB of the card's "
    "80, and each further row adds ~8.6 GB")
TRAIN_FM_STEPS = 3
TRAIN_OTHER_STEPS = 2
TRAIN_MIND_BATCH = 16384
TRAIN_MIND_CUT = (
    "train_batch (configs/registry.py: batch 65536) cut to 16384 for MIND: "
    "at 65536 its [B, B] float32 in-batch logits are 17.2 GB before the "
    "softmax and its gradient")


@contextlib.contextmanager
def replaced(module, name, fn):
    """Within the block, `module.name` is `fn`."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def rel_err(torch, got, want) -> float:
    """max |got - want| over the largest |want| (0 for an all-zero want
    that got equals)."""
    e = float((got.float() - want.float()).abs().max())
    return e / max(float(want.float().abs().max()), 1e-30) if e else 0.0


def device_trace(torch, fn):
    """Wall and device time of one call of `fn` under torch.profiler: the
    device's busy ms (the sum of its kernels' times), its idle share and
    the kernels that take the most time.  A profiler that records no
    device activity gives {"traced": False} and a reason."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    except Exception as e:                 # a diagnostic: the run goes on
        return {"traced": False, "reason": json.dumps(f"{type(e).__name__}: {e}")}
    if not by_name:
        return {"traced": False, "reason": "no device activity recorded"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"traced": True, "wall_ms": f"{wall_ms:.3f}",
            "device_busy_ms": f"{busy:.3f}",
            "device_idle_share": f"{1 - busy / wall_ms:.3f}",
            "kernel_kinds": len(by_name),
            "top": json.dumps({k[:60]: round(v, 3) for k, v in top})}


def adamw_from(torch, opt, ocfg, init, grads, device):
    """AdamW's first step from the weights `init` with the gradients
    `grads` (CPU tensors), on `device`: the new parameters on the CPU."""
    params = {k: v.to(device, copy=True) for k, v in init.items()}
    opt.apply_updates(ocfg, params, {k: g.to(device) for k, g in grads.items()},
                      opt.init_state(ocfg, params))
    return {k: p.cpu() for k, p in params.items()}


def lm_check_step(torch, tfm, tl, opt, moe, cfg, init, batch, ocfg, device):
    """One loss_fn + AdamW step of `cfg` from the weights `init` (CPU
    tensors) on `device`: (loss, {name: gradient}, {name: new parameter},
    the (probs, gate_idx) of every `moe.route` call), all on the CPU."""
    model = tfm.Transformer(cfg, device)
    tl.load_params(model, init)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    routes = []
    with recording(moe, "route", routes):
        loss, _, grads = tl.value_and_grad(tfm.loss_fn, model, tb)
    grads = {k: g.cpu() for k, g in grads.items()}
    return (loss.cpu(), grads, adamw_from(torch, opt, ocfg, init, grads, device),
            [(out[0].detach().cpu(), out[2].cpu()) for _, out in routes])


def held_step(torch, moe, what, got, want, n_routes, update=None):
    """Phase 8b (a)'s check of one step against another: the loss and
    every gradient within TRAIN_TOL of the tensor's largest magnitude and
    every routing difference a near tie in the forward's routing (the
    first `n_routes` `moe.route` calls of each: remat routes each layer
    again in the backward).  `update`, the new parameters of `got`'s
    optimizer from `want`'s gradients, within TRAIN_TOL of each tensor's
    largest magnitude of `want`'s.  The two full steps' parameters are
    printed, not held: AdamW's first update is ~lr * g / (|g| + eps), so
    an element whose gradient is near eps moves by an amount that the
    gradient's last bits set (`near_eps` counts the nonzero gradient
    elements under 100 eps).  Returns the errors and the near ties."""
    (l1, g1, p1, r1), (l2, g2, p2, r2) = got, want
    loss_err = rel_err(torch, l1, l2)
    grad_err = max(rel_err(torch, g1[k], g2[k]) for k in g2)
    near_eps = sum(int(((g != 0) & (g.abs() < 100 * 1e-8)).sum())
                   for g in g2.values())
    check(len(r1) in (n_routes, 2 * n_routes)
          and len(r2) in (n_routes, 2 * n_routes),
          f"{what}: {len(r1)} / {len(r2)} routings, want {n_routes} each "
          f"(twice that with remat)")
    ties = []
    for i, ((pa, ia), (pb, ib)) in enumerate(zip(r1[:n_routes],
                                                 r2[:n_routes])):
        differs, gap, near = moe.routing_differences(pa, ia, pb, ib)
        for t in torch.nonzero(differs.reshape(-1)).flatten().tolist():
            check(bool(near.reshape(-1)[t]), f"{what}: route call {i} token "
                  f"{t} routed differently with a gap of "
                  f"{float(gap.reshape(-1)[t]):.3g}, not a near tie")
            ties.append({"call": i, "token": t,
                         "gap": float(f"{float(gap.reshape(-1)[t]):.3g}")})
    out = {"loss_rel_err": f"{loss_err:.3g}", "grad_rel_err": f"{grad_err:.3g}",
           "step_param_abs_err": f"{max(float((p1[k] - p2[k]).abs().max()) for k in p2):.3g}",
           "near_eps": near_eps, "routing_near_ties": json.dumps(ties)}
    errs = [loss_err, grad_err]
    if update is not None:
        upd = max(rel_err(torch, update[k], p2[k]) for k in p2)
        out["update_rel_err"] = f"{upd:.3g}"
        errs.append(upd)
    check(max(errs) <= TRAIN_TOL and not ties,
          f"{what}: {out} (limit {TRAIN_TOL})")
    return out


def train_phases(args, np, torch, card) -> tuple:
    """Phase 8b: training.  (a) one loss_fn + AdamW step of the llama3-8b
    and granite-moe-1b-a400m smoke configs (float32, remat) on the card
    against the same step of the port on the CPU, and remat on against off
    on the card; (b) granite-moe-1b-a400m at full width and depth (bf16
    compute, float32 params and AdamW state, remat) on train_4k's sequence
    with the batch cut, TRAIN_MOE_STEPS steps on one fixed batch: finite
    losses, aux and grad norms, the last loss below the first, step time,
    tokens/s, MFU, peak memory and one traced step; (c) FM at full width
    and train_batch, its bag sums through the segment-bag kernel under
    `ops.SegmentBagFn`: the first step's loss and gradients against the
    plain bag under autograd on the card, then TRAIN_FM_STEPS AdamW steps
    with the kernel's launches counted (two per forward); (d) AutoInt and
    BST at train_batch and MIND cut, TRAIN_OTHER_STEPS steps each, finite;
    (e) `launch/train.py --arch fm --steps 6` on its default device (the
    card), the bag kernel launched twice a step.  Returns the segment-bag
    launches of (c)'s steps and (c)'s step p50 in ms."""
    import dataclasses
    from repro_torch.configs.registry import (LM_SHAPES, RECSYS_SHAPES,
                                              get_arch)
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.data.recsys_data import ClickLog
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import recsys as rec
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    t_start = t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products must not run in TF32 for the training checks")

    # -- (a) the card against the CPU at smoke size --------------------------
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    B, S = TRAIN_CHECK_SHAPE
    for arch in TRAIN_CHECK_ARCHS:
        cfg = get_arch(arch).make_smoke_config()
        check(cfg.dtype == cfg.param_dtype == torch.float32 and cfg.remat,
              f"{arch} smoke is not float32 with remat")
        cpu = tfm.init_params(cfg, torch.Generator().manual_seed(args.seed),
                              "cpu")
        init = {k: p.detach().clone() for k, p in cpu.named_parameters()}
        del cpu
        batch = next(lm_batches(cfg.vocab, batch=B, seq_len=S, seed=args.seed))
        steps = {name: lm_check_step(torch, tfm, tl, opt, moe,
                                     dataclasses.replace(cfg, remat=remat),
                                     init, batch, ocfg, dev)
                 for name, dev, remat in (("card", "cuda", True),
                                          ("cpu", "cpu", True),
                                          ("card_no_remat", "cuda", False))}
        n_routes = cfg.n_layers if cfg.moe else 0
        update = adamw_from(torch, opt, ocfg, init, steps["cpu"][1], "cuda")
        vs_cpu = held_step(torch, moe, f"{arch} card vs CPU", steps["card"],
                           steps["cpu"], n_routes, update)
        remat = held_step(torch, moe, f"{arch} remat on vs off",
                          steps["card"], steps["card_no_remat"], n_routes)
        finite = all(bool(torch.isfinite(g).all())
                     for g in steps["card"][1].values())
        check(finite, f"{arch}: non-finite gradients on the card")
        say("train_check", arch=arch, batch=B, seq=S,
            loss=f"{float(steps['card'][0]):.6f}",
            loss_cpu=f"{float(steps['cpu'][0]):.6f}",
            routes=len(steps["card"][3]),
            **{f"vs_cpu_{k}": v for k, v in vs_cpu.items()},
            **{f"remat_{k}": v for k, v in remat.items()})
        del steps
    t_phase = phase_done("train_card_vs_cpu", t_phase)

    # -- (b) granite-moe-1b-a400m at full width and depth --------------------
    cfg = get_arch(TRAIN_MOE_ARCH).make_config()
    check(cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
          and cfg.remat, f"{TRAIN_MOE_ARCH}: not bf16 on float32 params")
    S = LM_SHAPES["train_4k"]["seq_len"]
    B = TRAIN_MOE_BATCH
    say("train_cut", arch=TRAIN_MOE_ARCH, batch=B, seq=S,
        reason=json.dumps(TRAIN_MOE_CUT))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = tfm.init_params(cfg, gen, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        lm_batches(cfg.vocab, batch=B, seq_len=S, seed=args.seed)).items()}
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                               decay_steps=10 * TRAIN_MOE_STEPS)
    step = tl.make_train_step(tfm.loss_fn, ocfg)
    state = opt.init_state(ocfg, tl.param_dict(model))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    t_phase = phase_done("train_moe_init", t_phase)
    hist, secs = [], []
    for _ in range(TRAIN_MOE_STEPS):
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        hist.append({k: float(m[k]) for k in ("loss", "nll", "aux",
                                               "grad_norm", "lr")})
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    trace = device_trace(torch, lambda: step(model, state, batch))
    finite = all(math.isfinite(h[k]) for h in hist
                 for k in ("loss", "aux", "grad_norm"))
    p50 = percentile(secs, 50)
    tokens = B * S
    active = cfg.active_param_count()
    attn_flops = 12 * S * S * cfg.n_heads * cfg.hd * cfg.n_layers * B
    flops = 6 * active * tokens + attn_flops
    say("train_moe", arch=TRAIN_MOE_ARCH, card=json.dumps(card), batch=B,
        seq=S, steps=TRAIN_MOE_STEPS, params=n_params,
        active_params=active,
        losses=json.dumps([round(h["loss"], 5) for h in hist]),
        aux=json.dumps([round(h["aux"], 6) for h in hist]),
        grad_norms=json.dumps([round(h["grad_norm"], 4) for h in hist]),
        finite=finite, step_ms=json.dumps([round(s * 1e3, 1) for s in secs]),
        step_p50_ms=f"{p50 * 1e3:.1f}", tokens_per_s=f"{tokens / p50:.1f}",
        peak_gb=f"{peak / 1e9:.2f}",
        mfu=f"{flops / p50 / FLOPS_PER_S['torch.bfloat16']:.4f}",
        mfu_counts=json.dumps(
            f"(6 x {active} active params x {tokens} tokens + 12 x S^2 "
            f"{S}^2 x Hq {cfg.n_heads} x hd {cfg.hd} x L {cfg.n_layers} x "
            f"B {B} attention) = {flops:.4g} flops per step over the step "
            f"p50 and 989e12 (bf16 dense peak)"))
    say("train_moe_trace", arch=TRAIN_MOE_ARCH, **trace)
    check(finite, f"{TRAIN_MOE_ARCH}: non-finite loss, aux or grad norm: {hist}")
    check(hist[-1]["loss"] < hist[0]["loss"], f"{TRAIN_MOE_ARCH}: the last "
          f"loss {hist[-1]['loss']} is not below the first {hist[0]['loss']}")
    del model, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = phase_done("train_moe", t_phase)

    # -- (c) FM at full width through the segment-bag kernel -----------------
    cfg = get_arch("fm").make_config()
    B = RECSYS_SHAPES["train_batch"]["batch"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = rec.init_params(cfg, gen, "cuda")
    log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                   seq_len=cfg.seq_len, seed=args.seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in log.ctr_batch(B).items()}
    ops.segment_bag_cuda.launches = 0
    loss_k, _, grads_k = tl.value_and_grad(rec.loss_fn, model, batch)
    check(ops.segment_bag_cuda.launches == 2, f"FM's forward launched the "
          f"bag kernel {ops.segment_bag_cuda.launches} times, want 2")
    with replaced(ops, "segment_bag", ops.segment_bag_plain):
        loss_p, _, grads_p = tl.value_and_grad(rec.loss_fn, model, batch)
    check(ops.segment_bag_cuda.launches == 2,
          "the plain path launched the bag kernel")
    loss_err = float((loss_k - loss_p).abs())
    grad_errs = {k: rel_err(torch, grads_k[k], grads_p[k]) for k in grads_p}
    del grads_k, grads_p
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    step = tl.make_train_step(rec.loss_fn, ocfg)
    state = opt.init_state(ocfg, tl.param_dict(model))
    torch.cuda.synchronize()
    ops.segment_bag_cuda.launches = 0
    losses, secs = [], []
    for _ in range(TRAIN_FM_STEPS):
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        secs.append(time.perf_counter() - t0)
    train_launches = ops.segment_bag_cuda.launches
    fm_step_ms = f"{percentile(secs, 50) * 1e3:.2f}"
    finite = all(math.isfinite(x) for pair in losses for x in pair)
    say("train_fm", batch=B, table=tuple(model.table.shape),
        loss_kernel=f"{float(loss_k):.7f}", loss_plain=f"{float(loss_p):.7f}",
        loss_abs_err=f"{loss_err:.3g}",
        grad_rel_err=json.dumps({k: float(f"{v:.3g}")
                                 for k, v in grad_errs.items()}),
        steps=TRAIN_FM_STEPS, losses=json.dumps([round(x[0], 6) for x in losses]),
        finite=finite, segment_bag_launches=train_launches,
        steps_per_s=f"{len(secs) / sum(secs):.2f}",
        examples_per_s=f"{B * len(secs) / sum(secs):.1f}",
        step_p50_ms=fm_step_ms)
    check(loss_err <= TRAIN_TOL, f"FM loss through the kernel differs from "
          f"the plain bag's by {loss_err}")
    check(max(grad_errs.values()) <= TRAIN_TOL, f"FM gradients through the "
          f"kernel differ from the plain bag's: {grad_errs}")
    check(finite, f"FM: non-finite loss or grad norm: {losses}")
    check(train_launches == 2 * TRAIN_FM_STEPS, f"FM's {TRAIN_FM_STEPS} "
          f"steps launched the bag kernel {train_launches} times")
    del model, state, batch, step, log
    torch.cuda.empty_cache()
    t_phase = phase_done("train_fm", t_phase)

    # -- (d) AutoInt, BST and MIND -------------------------------------------
    say("train_cut", arch="mind", batch=TRAIN_MIND_BATCH,
        reason=json.dumps(TRAIN_MIND_CUT))
    for arch in ("autoint", "bst", "mind"):
        cfg = get_arch(arch).make_config()
        B = (TRAIN_MIND_BATCH if arch == "mind"
             else RECSYS_SHAPES["train_batch"]["batch"])
        model = rec.init_params(cfg, gen, "cuda")
        log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                       seq_len=cfg.seq_len, seed=args.seed)
        raw = log.ctr_batch(B) if arch == "autoint" else log.seq_batch(B)
        batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
        step = tl.make_train_step(rec.loss_fn, ocfg)
        state = opt.init_state(ocfg, tl.param_dict(model))
        torch.cuda.synchronize()
        out, secs = [], []
        for _ in range(TRAIN_OTHER_STEPS):
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            out.append({k: float(v) for k, v in m.items()})
            secs.append(time.perf_counter() - t0)
        finite = all(math.isfinite(o[k]) for o in out
                     for k in ("loss", "grad_norm"))
        say("train_recsys", arch=arch, batch=B, steps=TRAIN_OTHER_STEPS,
            losses=json.dumps([round(o["loss"], 6) for o in out]),
            grad_norms=json.dumps([round(o["grad_norm"], 5) for o in out]),
            finite=finite, steps_per_s=f"{len(secs) / sum(secs):.2f}",
            examples_per_s=f"{B * len(secs) / sum(secs):.1f}")
        check(finite, f"{arch}: non-finite loss or grad norm: {out}")
        del model, state, batch, step, log, raw
        torch.cuda.empty_cache()
    t_phase = phase_done("train_other_recsys", t_phase)

    # -- (e) the launcher on the card by default ------------------------------
    from repro_torch.launch import train as train_launcher
    ops.segment_bag_cuda.launches = 0
    hist = train_launcher.main(["--arch", "fm", "--steps", "6"])
    launcher_launches = ops.segment_bag_cuda.launches
    say("train_launcher", arch="fm", steps=6, history=json.dumps(hist),
        segment_bag_launches=launcher_launches)
    check(math.isfinite(hist[-1]["loss"]) and launcher_launches == 12,
          f"launch/train.py --arch fm --steps 6 on the card: {hist}, "
          f"{launcher_launches} bag launches (want 12)")
    phase_done("train_launcher", t_phase)
    phase_done("train", t_start)
    return train_launches, fm_step_ms


# ---------------------------------------------------------------------------
# data-parallel training and the GIN (phase 8c)
# ---------------------------------------------------------------------------

GNN_STEPS = 3                  # AdamW steps of each full-width GIN shape
GNN_SAMPLED = ("minibatch_lg",)          # shapes trained on sampled subgraphs
GNN_FORKED = ("ogb_products", "minibatch_lg")  # graphs built in the workers
HALO_TOL = 1e-4                # tests/test_dist.py's halo-vs-dense limit
DP_FM_STEPS = 3                # timed float32 dp steps of FM
DP_INT8_STEPS = 2              # int8 steps: the second has a residual
DP_LSQ_STEPS = 3               # bit-equal dp steps of the least squares
DP_LSQ_CONVERGE = 150          # tests/test_dist.py's int8 convergence run
DP_LSQ_CFG = dict(lr=5e-2, weight_decay=0.0, warmup_steps=0)
NEAR_EPS = 100                 # gradients under 100 AdamW eps: see dp_phase


def _gnn_graph_job(shape, seed, out_dir) -> dict:
    """A forked worker's host build of GNN_SHAPES[shape]'s graph at full
    size (numpy only): ogb_products' full-graph batch, or minibatch_lg's
    GNN_STEPS subgraphs of `batch_nodes` seeds at its fanout.  Each array
    goes to an .npy file under `out_dir`; returns their paths per batch,
    the graph's size, its least in-degree and the build's seconds."""
    import numpy as np
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data import graph_data
    t0 = time.perf_counter()
    s = GNN_SHAPES[shape]
    g = graph_data.generate_graph(s["n_nodes"], s["n_edges"], s["d_feat"],
                                  s["n_classes"], seed=seed)
    if shape in GNN_SAMPLED:
        rng = np.random.default_rng(seed)
        batches = [graph_data.sample_subgraph(
            g, rng.integers(0, g.n_nodes, s["batch_nodes"]), s["fanout"], rng)
            for _ in range(GNN_STEPS)]
    else:
        batches = [graph_data.full_graph_batch(g, seed=seed)]
    files = []
    for i, b in enumerate(batches):
        files.append({})
        for k, v in b.items():
            path = os.path.join(out_dir, f"{shape}-{i}-{k}.npy")
            np.save(path, v)
            files[-1][k] = path
    return {"files": files, "n_nodes": g.n_nodes, "n_edges": g.n_edges,
            "min_in_degree": int(np.diff(g.adj_offsets).min()),
            "host_s": time.perf_counter() - t0, "end_wall": time.time()}


def start_gnn_graphs(stack, seed) -> dict:
    """Phase 8c's two large graphs (GNN_FORKED), each built by a forked
    worker (forked before the search phases allocate; numpy only) while
    the earlier phases run.  Returns {shape: future}; the workers and
    their files end with `stack`."""
    import tempfile
    out_dir = stack.enter_context(tempfile.TemporaryDirectory(
        prefix="chip_smoke_gnn_"))
    pool = stack.enter_context(ProcessPoolExecutor(
        max_workers=len(GNN_FORKED),
        mp_context=multiprocessing.get_context("fork")))
    return {shape: pool.submit(_gnn_graph_job, shape, seed, out_dir)
            for shape in GNN_FORKED}


def _load_batches(np, torch, job) -> list:
    """The worker's batches, on the card."""
    return [{k: torch.from_numpy(np.load(p)).cuda() for k, p in f.items()}
            for f in job["files"]]


class _Count:
    """Counts calls of a function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _lsq(np, torch, rows, seed):
    """tests/test_dist.py's least-squares problem from numpy seeds, on the
    card: params (w [4, 1], b [1]; zeros) and the batch (x, y = x w)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    w_true = rng.normal(size=(4, 1)).astype(np.float32)
    params = {"w": torch.zeros((4, 1), device="cuda"),
              "b": torch.zeros((1,), device="cuda")}
    batch = {"x": torch.from_numpy(x).cuda(),
             "y": torch.from_numpy(x @ w_true).cuda()}
    return params, batch


def _lsq_loss(torch):
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean((pred - batch["y"]) ** 2), {}
    return loss_fn


def dp_phase(args, np, torch, mesh, fm_step_ms) -> int:
    """Phase 8c (a): the data-parallel step on the one-rank NCCL group of
    `mesh`.  Returns the bag kernel's launches in the dp steps."""
    import torch.distributed as dist

    from repro_torch.configs.registry import RECSYS_SHAPES, get_arch
    from repro_torch.data.recsys_data import ClickLog
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rec
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    t_phase = time.perf_counter()
    # -- the least squares: no atomics, bit for bit end to end --------------
    loss_fn = _lsq_loss(torch)
    ocfg = opt.OptimizerConfig(**DP_LSQ_CFG)
    pa, batch = _lsq(np, torch, 64, args.seed)
    pb = {k: v.clone() for k, v in pa.items()}
    sa, sb = opt.init_state(ocfg, pa), opt.init_state(ocfg, pb)
    one = tl.make_train_step(loss_fn, ocfg)
    dp = tl.make_sharded_train_step(loss_fn, ocfg, mesh)
    res = tl.init_residual(pb)
    for i in range(DP_LSQ_STEPS):
        pa, sa, ma = one(pa, sa, batch)
        pb, sb, res, mb = dp(pb, sb, res, batch)
        check(torch.equal(ma["loss"], mb["loss"])
              and all(torch.equal(pa[k], pb[k]) for k in pa),
              f"least squares step {i}: the dp step is not the one-device "
              f"step bit for bit")
    pc, _ = _lsq(np, torch, 64, args.seed)
    q = tl.make_sharded_train_step(loss_fn, ocfg, mesh, compression="int8")
    sc, rc = opt.init_state(ocfg, pc), tl.init_residual(pc)
    for _ in range(DP_LSQ_CONVERGE):
        pc, sc, rc, mc = q(pc, sc, rc, batch)
    lsq_final = float(mc["loss"])
    say("dp_lsq", bit_equal_steps=DP_LSQ_STEPS, int8_steps=DP_LSQ_CONVERGE,
        int8_final_loss=f"{lsq_final:.3g}")
    check(lsq_final < 1e-2, f"int8 dp least squares did not converge: "
          f"{lsq_final} after {DP_LSQ_CONVERGE} steps")
    t_phase = phase_done("dp_lsq", t_phase)

    # -- FM at full width: one-device vs dp, and the same gradients ----------
    cfg = get_arch("fm").make_config()
    B = RECSYS_SHAPES["train_batch"]["batch"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = rec.init_params(cfg, gen, "cuda")
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                   seq_len=cfg.seq_len, seed=args.seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in log.ctr_batch(B).items()}
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    real_vg = tl.value_and_grad
    seen = []

    def recording_vg(loss_fn, params, b):
        out = real_vg(loss_fn, params, b)
        seen.append((out[0].clone(), {k: g.clone() for k, g in out[2].items()}))
        return out

    def fm_state():
        tl.load_params(model, init)
        return opt.init_state(ocfg, tl.param_dict(model))

    with replaced(tl, "value_and_grad", recording_vg):
        tl.make_train_step(rec.loss_fn, ocfg)(model, fm_state(), batch)
        one = {k: p.detach().clone() for k, p in model.named_parameters()}
        ops.segment_bag_cuda.launches = 0
        dp_step = tl.make_sharded_train_step(rec.loss_fn, ocfg, mesh)
        dp_step(model, fm_state(), tl.init_residual(model), batch)
        dp_launches = ops.segment_bag_cuda.launches
    got = {k: p.detach().clone() for k, p in model.named_parameters()}
    (l1, g1), (l2, g2) = seen
    # new parameters: held whole; the elements whose gradient lies under
    # NEAR_EPS * eps are counted and printed, since there AdamW's first
    # update, ~lr * g / (|g| + eps), moves by what the gradient's last bits
    # say (d/dg is 1 / (4 eps) at |g| = eps), and the atomics set those bits
    near = NEAR_EPS * ocfg.eps
    errs = {"loss": rel_err(torch, l2, l1),
            "grads": max(rel_err(torch, g2[k], g1[k]) for k in g1),
            "params": 0.0}
    apart = {}
    for k in one:
        d = (got[k] - one[k]).abs()
        far = (g1[k].abs() >= near) & (g2[k].abs() >= near)
        scale = max(float(one[k].abs().max()), 1e-30)
        whole = float(d.max()) / scale
        errs["params"] = max(errs["params"], whole)
        nonzero = (g1[k] != 0) | (g2[k] != 0)
        apart[k] = {"rel": float(f"{whole:.3g}"),
                    "near_eps": int((~far & nonzero).sum()),
                    "far_rel": float(f"{float(d[far].max()) / scale:.3g}"
                                     if bool(far.any()) else 0.0)}
    # the one-device step's gradients through the dp step: its update must
    # equal the one-device step's bit for bit
    with replaced(tl, "value_and_grad",
                  lambda *_: (l1, {}, {k: g.clone() for k, g in g1.items()})):
        tl.make_sharded_train_step(rec.loss_fn, ocfg, mesh)(
            model, fm_state(), tl.init_residual(model), batch)
    same_update = all(torch.equal(p, one[k])
                      for k, p in model.named_parameters())
    del seen, g1, g2, one, got
    # timed float32 dp steps, all_reduce calls counted
    reduce = _Count(dist.all_reduce)
    state, res, secs = fm_state(), tl.init_residual(model), []
    ops.segment_bag_cuda.launches = 0
    with replaced(dist, "all_reduce", reduce):
        for _ in range(DP_FM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, res, m = dp_step(model, state, res, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    dp_launches += ops.segment_bag_cuda.launches
    n_leaves = len(init)
    say("dp_fm", batch=B, group_ranks=dist.get_world_size(mesh.dp_group),
        loss_rel_err=f"{errs['loss']:.3g}",
        grad_rel_err=f"{errs['grads']:.3g}",
        param_rel_err=f"{errs['params']:.3g}", params=json.dumps(apart),
        same_grads_update_bit_equal=same_update,
        all_reduce_calls=reduce.calls,
        all_reduce_want=f"({n_leaves} leaves + 1 loss) x {DP_FM_STEPS}",
        step_ms=json.dumps([round(s * 1e3, 2) for s in secs]),
        step_p50_ms=f"{percentile(secs, 50) * 1e3:.2f}",
        one_device_step_p50_ms=fm_step_ms)
    check(max(errs.values()) <= TRAIN_TOL, f"FM's dp step differs from the "
          f"one-device step: {errs} (limit {TRAIN_TOL})")
    check(same_update, "FM's dp step from the one-device step's gradients "
          "is not the one-device update bit for bit")
    check(reduce.calls == (n_leaves + 1) * DP_FM_STEPS,
          f"{reduce.calls} all_reduce calls in {DP_FM_STEPS} dp steps, want "
          f"{(n_leaves + 1) * DP_FM_STEPS}")
    t_phase = phase_done("dp_fm", t_phase)

    # -- int8 with error feedback: a step with a nonzero residual ------------
    calls = []
    real_cp = tl.compressed_psum_with_feedback

    def recording_cp(grads, residual, group):
        summed, new = real_cp(grads, residual, group)
        calls.append(({k: g.clone() for k, g in grads.items()},
                      {k: r.clone() for k, r in residual.items()},
                      {k: g.clone() for k, g in summed.items()}, new))
        return summed, new

    reduce = _Count(dist.all_reduce)
    q = tl.make_sharded_train_step(rec.loss_fn, ocfg, mesh, compression="int8")
    state, res = fm_state(), tl.init_residual(model)
    ops.segment_bag_cuda.launches = 0
    with replaced(tl, "compressed_psum_with_feedback", recording_cp), \
            replaced(dist, "all_reduce", reduce):
        for _ in range(DP_INT8_STEPS):
            model, state, res, m = q(model, state, res, batch)
    dp_launches += ops.segment_bag_cuda.launches
    g, r, summed, new = calls[-1]
    exact, control, res_norm = True, False, 0.0
    for k in g:
        x = g[k].float() + r[k]
        qk, scale = collectives.quantize_int8(x)
        deq = collectives.dequantize_int8(qk, scale)
        exact &= torch.equal(summed[k], deq) and torch.equal(new[k], x - deq)
        q0, s0 = collectives.quantize_int8(g[k].float())
        control |= not torch.equal(summed[k],
                                   collectives.dequantize_int8(q0, s0))
        res_norm = max(res_norm, float(r[k].abs().max()))
    say("dp_int8", steps=DP_INT8_STEPS, residual_in_max=f"{res_norm:.3g}",
        sum_and_residual_equal_plain=exact, residual_dropped_refused=control,
        all_reduce_calls=reduce.calls, loss=f"{float(m['loss']):.6f}")
    check(res_norm > 0, "the int8 step after the first has a zero residual")
    check(exact, "the int8 dp step's sums or residuals differ from "
          "dequantize(quantize(g + r)) and x - deq on the card")
    check(control, "the int8 check accepts a sum that dropped the residual")
    check(reduce.calls == (n_leaves + 1) * DP_INT8_STEPS,
          f"{reduce.calls} all_reduce calls in {DP_INT8_STEPS} int8 steps")
    check(dp_launches == 2 * (1 + DP_FM_STEPS + DP_INT8_STEPS),
          f"the dp steps launched the bag kernel {dp_launches} times")
    del model, state, res, batch, init, calls
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("dp_int8", t_phase)
    return dp_launches


def _gnn_cfg(shape):
    import dataclasses

    from repro_torch.configs.registry import GNN_SHAPES, get_arch
    s = GNN_SHAPES[shape]
    return dataclasses.replace(get_arch("gin-tu").make_config(),
                               d_feat=s["d_feat"], n_classes=s["n_classes"],
                               graph_readout=s["kind"] == "train_graphs")


def gnn_train(np, torch, card, shape, batches, loss_fn, seed, full=False,
              edges=None) -> dict:
    """GNN_STEPS AdamW steps of gin-tu at full width on `batches` (one
    batch a step, cycled), from weights of a CPU generator seeded `seed`:
    losses finite; step times and peak memory; with `full` (a full graph)
    the last loss below the first and one more step under
    torch.profiler."""
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    cfg = _gnn_cfg(shape)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(seed),
                            "cpu").cuda()
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    step = tl.make_train_step(loss_fn, ocfg)
    state = opt.init_state(ocfg, tl.param_dict(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, secs = [], []
    for i in range(GNN_STEPS):
        t0 = time.perf_counter()
        model, state, m = step(model, state, batches[i % len(batches)])
        hist.append({k: float(m[k]) for k in ("loss", "acc", "grad_norm")})
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    out = {"card": json.dumps(card), "steps": GNN_STEPS,
           "losses": json.dumps([round(h["loss"], 4) for h in hist]),
           "acc": json.dumps([round(h["acc"], 4) for h in hist]),
           "step_ms": json.dumps([round(s * 1e3, 2) for s in secs]),
           "step_p50_ms": f"{percentile(secs, 50) * 1e3:.2f}",
           "peak_gb": f"{peak / 1e9:.2f}"}
    if edges is not None:
        out["edges_per_s"] = f"{edges / percentile(secs, 50):.4g}"
    if full:
        out.update({f"trace_{k}": v for k, v in device_trace(
            torch, lambda: step(model, state, batches[0])).items()})
    finite = all(math.isfinite(h[k]) for h in hist
                 for k in ("loss", "grad_norm"))
    say("gnn_train", shape=shape, **out)
    check(finite, f"gin-tu {shape}: non-finite loss or grad norm: {hist}")
    check(not full or hist[-1]["loss"] < hist[0]["loss"],
          f"gin-tu {shape}: the last loss {hist[-1]['loss']} is not below "
          f"the first {hist[0]['loss']}")
    return out


def gnn_phase(args, np, torch, card, mesh, graphs) -> None:
    """Phase 8c (b)-(d): gin-tu at full width on every GNN_SHAPES entry,
    the halo-exchange loss on the one-rank group, the launcher."""
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data import graph_data
    from repro_torch.dist import sharding
    from repro_torch.models import gnn
    from repro_torch.train import train_loop as tl

    t_phase = time.perf_counter()
    # -- full_graph_sm: card vs CPU, then the halo loss ----------------------
    s = GNN_SHAPES["full_graph_sm"]
    cfg = _gnn_cfg("full_graph_sm")
    g = graph_data.generate_graph(s["n_nodes"], s["n_edges"], s["d_feat"],
                                  s["n_classes"], seed=args.seed)
    cpu_model = gnn.init_params(cfg, torch.Generator().manual_seed(args.seed),
                                "cpu")
    card_model = gnn.GIN(cfg, "cuda")
    tl.load_params(card_model, dict(cpu_model.named_parameters()))
    full = graph_data.full_graph_batch(g, seed=args.seed)
    vg = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("card", card_model, "cuda")):
        b = {k: torch.from_numpy(v).to(dev) for k, v in full.items()}
        loss, m, grads = tl.value_and_grad(gnn.loss_fn, model, b)
        vg[name] = (loss.cpu(), {k: v.cpu() for k, v in grads.items()})
    loss_err = rel_err(torch, vg["card"][0], vg["cpu"][0])
    grad_errs = {k: rel_err(torch, vg["card"][1][k], vg["cpu"][1][k])
                 for k in vg["cpu"][1]}
    worst = max(grad_errs, key=grad_errs.get)
    say("gnn_card_vs_cpu", shape="full_graph_sm", nodes=g.n_nodes,
        edges=g.n_edges, loss=f"{float(vg['card'][0]):.6f}",
        loss_cpu=f"{float(vg['cpu'][0]):.6f}", loss_rel_err=f"{loss_err:.3g}",
        grad_rel_err_max=f"{grad_errs[worst]:.3g}", worst=worst)
    check(max([loss_err] + list(grad_errs.values())) <= TRAIN_TOL,
          f"gin-tu full_graph_sm on the card differs from the CPU: loss "
          f"{loss_err}, gradients {grad_errs} (limit {TRAIN_TOL})")
    # (c) the halo-exchange loss on the one-rank group, forward and
    # backward, against the dense loss over every node
    part = graph_data.partition_for_halo(g, mesh.dp_size)
    keys = ("nodes", "src", "dst", "edge_mask", "labels", "label_mask",
            "send_idx")
    shard = {k: sharding.dp_placement(mesh, part[k].shape).block(
        torch.from_numpy(part[k])) for k in keys}
    check(shard["nodes"].device == mesh.device,
          f"the halo shard is on {shard['nodes'].device}, not {mesh.device}")
    dense = {k: torch.from_numpy(v).cuda() for k, v in
             graph_data.full_graph_batch(g, train_frac=1.0,
                                         seed=args.seed).items()}
    gather = _Count(torch.distributed.all_gather)
    with replaced(torch.distributed, "all_gather", gather):
        hl, hm, hg = tl.value_and_grad(
            lambda mdl, b: gnn.halo_loss_fn(mdl, b, mesh.dp_group),
            card_model, shard)
    dl, dm, dg = tl.value_and_grad(gnn.loss_fn, card_model, dense)
    halo_err = abs(float(hl) - float(dl))
    halo_grad = max(rel_err(torch, hg[k], dg[k]) for k in dg)
    say("gnn_halo", shape="full_graph_sm", shards=mesh.dp_size,
        boundary=part["boundary"], cut_fraction=part["cut_fraction"],
        all_gathers=gather.calls, loss=f"{float(hl):.6f}",
        loss_dense=f"{float(dl):.6f}", loss_abs_err=f"{halo_err:.3g}",
        acc=float(hm["acc"]), acc_dense=float(dm["acc"]),
        grad_rel_err=f"{halo_grad:.3g}")
    check(halo_err <= HALO_TOL and float(hm["acc"]) == float(dm["acc"]),
          f"halo loss {float(hl)} / acc {float(hm['acc'])} against the dense "
          f"{float(dl)} / {float(dm['acc'])} (limit {HALO_TOL})")
    check(halo_grad <= HALO_TOL, f"halo gradients differ from the dense "
          f"ones by {halo_grad} of their scale (limit {HALO_TOL})")
    check(gather.calls == cfg.n_layers, f"{gather.calls} all_gathers, want "
          f"one a layer ({cfg.n_layers})")
    del vg, card_model, cpu_model, dense, shard, hg, dg
    t_phase = phase_done("gnn_full_graph_sm", t_phase)

    # -- molecule: the readout ------------------------------------------------
    s = GNN_SHAPES["molecule"]
    mb = graph_data.molecule_batch(s["batch"], s["n_nodes"], s["n_edges"],
                                   s["d_feat"], s["n_classes"], seed=args.seed)
    n_graphs = mb.pop("n_graphs")
    mb = {k: torch.from_numpy(v).cuda() for k, v in mb.items()}
    gnn_train(np, torch, card, "molecule", [mb],
              lambda mdl, b: gnn.loss_fn(mdl, dict(b, n_graphs=n_graphs)),
              args.seed)
    t_phase = phase_done("gnn_molecule", t_phase)

    # -- the two large graphs, from the forked workers ------------------------
    for shape in GNN_FORKED:
        t0 = time.perf_counter()
        job = graphs[shape].result()
        waited = time.perf_counter() - t0
        batches = _load_batches(np, torch, job)
        s = GNN_SHAPES[shape]
        # the phase the worker's build ended in (its host cores are busy
        # until then: the timed search windows start at main_path)
        ended_in = next((p for p, t in PHASE_ENDS if t >= job["end_wall"]),
                        "dp_gnn")
        say("gnn_graph", shape=shape, nodes=job["n_nodes"],
            edges=job["n_edges"], min_in_degree=job["min_in_degree"],
            host_build_s=f"{job['host_s']:.1f}", build_ended_in=ended_in,
            waited_s=f"{waited:.1f}",
            load_s=f"{time.perf_counter() - t0 - waited:.1f}",
            batch_nodes=tuple(batches[0]["nodes"].shape),
            batch_edges=int(batches[0]["src"].shape[0]))
        if shape in GNN_SAMPLED:
            check(job["min_in_degree"] >= max(s["fanout"]),
                  f"{shape}: a node of in-degree {job['min_in_degree']} "
                  f"under the fanout {s['fanout']}")
        gnn_train(np, torch, card, shape, batches, gnn.loss_fn, args.seed,
                  full=shape not in GNN_SAMPLED,
                  edges=None if shape in GNN_SAMPLED else job["n_edges"])
        del batches
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = phase_done(f"gnn_{shape}", t_phase)

    # -- (d) the launcher on the card by default -------------------------------
    from repro_torch.launch import train as train_launcher
    hist = train_launcher.main(["--arch", "gin-tu", "--shape", "molecule",
                                "--steps", "6"])
    say("gnn_launcher", arch="gin-tu", shape="molecule", steps=6,
        history=json.dumps(hist))
    check(math.isfinite(hist[-1]["loss"]), f"launch/train.py --arch gin-tu "
          f"--shape molecule on the card: {hist}")
    phase_done("gnn_launcher", t_phase)


def dp_gnn_phases(args, np, torch, card, graphs, fm_step_ms) -> int:
    """Phase 8c: data-parallel training and the GIN on a one-rank NCCL
    process group.  Returns the bag kernel's launches in the dp steps."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t_start = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(store, "store"),
            world_size=1, rank=0)
    except Exception as e:          # the run fails: the group is the path
        raise SmokeFailure(f"no NCCL process group: {e!r}") from e
    try:
        mesh = make_host_mesh(data=1, model=1)
        check(mesh.distributed and mesh.device.type == "cuda",
              f"the dp mesh is not on a process group on the card: {mesh}")
        dp_launches = dp_phase(args, np, torch, mesh, fm_step_ms)
        gnn_phase(args, np, torch, card, mesh, graphs)
    finally:
        dist.destroy_process_group()
    phase_done("dp_gnn", t_start)
    return dp_launches


# ---------------------------------------------------------------------------
# 9. the dry-run: the fake pass against one rank's program on the card
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("llama3-8b/train_4k", "llama3-8b/decode_32k",
                "veretennikov/serve_batch")
DRYRUN_PEAK_TOL = 0.10         # predicted peak within 10% of the measured
DRYRUN_REPS = 3                # timed steps of each cell after the first
DRYRUN_TIMEOUT_S = 600         # the fake pass, started in phase 1
DRYRUN_HOLD_SEED = 9           # the random arenas and rows of the holds
DRYRUN_WRAPPERS = {"unpack_postings": "unpack_postings_cuda",
                   "banded_intersect_rows": "banded_intersect_rows_cuda",
                   "banded_min_delta_rows": "banded_min_delta_rows_cuda",
                   "banded_delta_mask_rows": "banded_delta_mask_rows_cuda",
                   "flash_decode": "flash_decode_cuda",
                   "segment_bag_sums": "segment_bag_cuda"}


def start_dryrun(stack) -> dict:
    """Phase 9 (a): `python -m repro_torch.launch.dryrun` on DRYRUN_CELLS
    (the single 32 x 8 mesh), a subprocess started in phase 1 that runs
    beside the earlier phases (a fake-tensor pass: no allocation, no
    launch).  Returns its handle; it ends with `stack`."""
    import tempfile
    root = Path(__file__).resolve().parent
    out_dir = stack.enter_context(tempfile.TemporaryDirectory(
        prefix="chip_smoke_dryrun_"))
    log = open(os.path.join(out_dir, "log"), "w")
    stack.callback(log.close)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(DRYRUN_CELLS), "--mesh", "single", "--jobs",
         str(len(DRYRUN_CELLS)), "--out", out_dir],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    stack.callback(stop)
    return {"proc": proc, "dir": out_dir, "t0": time.perf_counter()}


def _dryrun_records(dry) -> dict:
    """The fake pass's records of DRYRUN_CELLS, once it has ended."""
    proc = dry["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                   - (time.perf_counter() - dry["t0"])))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"the dry-run's fake pass still runs after "
                           f"{DRYRUN_TIMEOUT_S} s")
    with open(os.path.join(dry["dir"], "log")) as fh:
        log = fh.read()
    check(rc == 0 and "done; 0 failures" in log,
          f"the dry-run's fake pass failed (rc {rc}):\n{log[-4000:]}")
    out = {}
    for c in DRYRUN_CELLS:
        arch, shape = c.split("/")
        with open(os.path.join(dry["dir"], f"{arch}__{shape}__32_8.json")) \
                as fh:
            out[c] = json.load(fh)
    return out


def _dryrun_fill(torch, cell, gen):
    """Rank 0's inputs on the card: random weights from the generator
    (norm scales 1), random tokens and labels in every vocabulary, random
    caches (drawn in place: no transient), zero arenas and tables (every
    index in range; `_dryrun_holds` holds the search kernels on random
    ones)."""
    def fill(name, shape, dtype, dev):
        if name in cell.params and dtype.is_floating_point:
            if len(shape) == 1 and ("ln" in name or "norm" in name):
                return torch.ones(shape, dtype=dtype, device=dev)
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=dev).mul_(0.02).to(dtype)
        if name in ("tokens", "labels"):
            return torch.randint(0, 32000, shape, generator=gen,
                                 device=dev).to(dtype)
        if name in ("k", "v"):
            return torch.empty(shape, dtype=dtype,
                               device=dev).normal_(generator=gen)
        return torch.zeros(shape, dtype=dtype, device=dev)
    return fill


@contextlib.contextmanager
def _signatures(module, name, sigs, sig):
    """Within the block, `module.name` adds `sig(*args)` of every call to
    the set `sigs` (the shapes the main path gives a kernel)."""
    fn = getattr(module, name)

    def rec(*args):
        sigs.add(sig(*args))
        return fn(*args)
    setattr(module, name, rec)
    try:
        yield sigs
    finally:
        setattr(module, name, fn)


def _random_arena(torch, gen, n_lanes, n_blocks, idx_shape):
    """A packed arena of random blocks at the given sizes: random lane
    words, field widths 0..32, bases that keep every field's words inside
    `lanes` (3 fields x 32 bits x BLOCK postings = 384 words at most),
    random anchors; random ordinals over every block."""
    kw = dict(generator=gen, device="cuda", dtype=torch.int32)
    w = torch.randint(0, 33, (n_blocks, 3), **kw)
    meta = torch.stack([
        torch.randint(0, n_lanes - 384 + 1, (n_blocks,), **kw),
        w[:, 0] | (w[:, 1] << 6) | (w[:, 2] << 12),
        *torch.randint(-(1 << 20), 1 << 20, (3, n_blocks), **kw)], 1)
    arena = {"lanes": torch.randint(-(1 << 31), (1 << 31) - 1, (n_lanes,),
                                    **kw),
             "blk_meta": meta.contiguous()}
    return arena, torch.randint(0, n_blocks * 128, idx_shape, **kw)


def _random_rows(torch, ops, gen, a_shape, b_shape):
    """Banded-intersect rows at the given shapes: keys over 64 x Pb values
    (about one in four a keys within band 8 of a b key), b ascending with
    a sentinel tail on half the rows, a with sentinel pads, bands 0..8."""
    kw = dict(generator=gen, device="cuda", dtype=torch.int32)
    (n, pa), pb = a_shape, b_shape[1]
    b = torch.randint(0, 64 * pb, (n, pb), **kw).sort(dim=1).values
    b[: n // 2, pb - pb // 4:] = ops.I32_SENTINEL
    a = torch.randint(0, 64 * pb, (n, pa), **kw)
    a[:, pa - pa // 8:] = ops.I32_SENTINEL
    return a, b, torch.randint(0, 9, (n,), **kw)


def _dryrun_holds(torch, ops, cell, run):
    """The kernels of one cell's step held against their plain versions
    at the shapes the step gives them: `run()` runs the step once with
    flash decode's calls recorded and the search kernels' shapes taken;
    each recorded decode call's output (the card's cache, filled at
    random) against `flash_decode_plain` on its own q, cache and kv_len
    (a row-relative bf16 ulp, and a half-cache control that must be
    refused); the unpack and intersect kernels at each recorded shape on
    a random arena and random rows, exactly.  Returns {kernel: (calls
    held, max abs err, row-relative err or None, control or None)}."""
    import repro_torch.core.batch_executor as bx
    decode, unpack, rows = [], set(), set()
    with recording(ops, "flash_decode", decode), \
            _signatures(bx, "unpack_postings", unpack,
                        lambda arena, idx: (arena["lanes"].shape[0],
                                            arena["blk_meta"].shape[0],
                                            tuple(idx.shape))), \
            _signatures(bx, "banded_intersect_rows", rows,
                        lambda a, b, bands: (tuple(a.shape),
                                             tuple(b.shape))):
        run()
    torch.cuda.synchronize()
    out = {}
    if decode:
        err = rel = 0.0
        for (q, k, v, kv_len), o in decode:
            e, r = hold(torch, f"{cell.arch_id}/{cell.shape_name} "
                        "flash_decode", o,
                        ops.flash_decode_plain(q, k, v, kv_len))
            err, rel = max(err, e), max(rel, r)
        (q, k, v, kv_len), o = decode[0]
        ctl = control(torch, "flash_decode over half the cache",
                      ops.flash_decode_plain(q, k, v, kv_len // 2), o,
                      ROW_ULP)
        out["flash_decode"] = (len(decode), err, rel, ctl)
    del decode
    gen = torch.Generator(device="cuda").manual_seed(DRYRUN_HOLD_SEED)
    for name, sigs in (("unpack_postings", unpack),
                       ("banded_intersect_rows", rows)):
        err = 0
        for sig in sorted(sigs):
            if name == "unpack_postings":
                arena, idx = _random_arena(torch, gen, *sig)
                got = ops.unpack_postings(arena, idx)
                want = ops.unpack_postings_plain(arena, idx)
                check(bool(torch.any(want[0] != 0)), "random arena: all zero")
            else:
                a, b, bands = _random_rows(torch, ops, gen, *sig)
                got = (ops.banded_intersect_rows(a, b, bands),)
                want = (ops.banded_intersect_rows_plain(a, b, bands),)
                check(bool(want[0].any()) and not bool(want[0].all()),
                      f"random rows {sig}: every probe alike")
            for g, w in zip(got, want):
                err = max(err, int((g.long() - w.long()).abs().max()))
            del got, want
        check(err == 0, f"{cell.arch_id}/{cell.shape_name} {name} != its "
                        f"plain version at {sorted(sigs)}: max abs err {err}")
        if sigs:
            out[name] = (len(sigs), err, None, None)
    return out


def _dispatch_us(torch, ops, n=2000, rounds=3):
    """Host microseconds per call of the flash-decode kernel through its
    operator (`ops.flash_decode`, the path every caller takes) and through
    the ctypes wrapper directly, on a one-tile cache (the device time is
    far below the host's): medians of `rounds` runs of `n` calls each, in
    turns (operator, direct, direct, operator)."""
    q = torch.randn(1, 8, 128, dtype=torch.bfloat16, device="cuda")
    k = torch.randn(1, 64, 1, 128, dtype=torch.bfloat16, device="cuda")
    kv = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    fns = {"op": lambda: ops.flash_decode(q, k, k, kv),
           "direct": lambda: ops.flash_decode_cuda(q, k, k, kv)}
    got = {"op": [], "direct": []}
    for name in ("op", "direct"):
        for _ in range(50):
            fns[name]()
    for _ in range(rounds):
        for name in ("op", "direct", "direct", "op"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fns[name]()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) / n * 1e6)
    return percentile(got["op"], 50), percentile(got["direct"], 50)


def dryrun_phase(args, np, torch, dry, kernels) -> None:
    """Phase 9 (b): rank 0's program of each DRYRUN_CELLS cell run for
    real on the card under the fake process group of the 32 x 8 mesh
    (collectives return at once; shapes and kernels are real), held
    against the fake pass's record: the peak above the phase's baseline
    within DRYRUN_PEAK_TOL of the prediction (and the prediction without
    the AdamW state refused), kernel launches equal to the kernel ops the
    pass saw and collective calls by type equal to its counts, one step
    each; then DRYRUN_REPS timed steps beside the roofline's compute and
    memory terms, and one recorded step whose kernels are held against
    their plain versions (`_dryrun_holds`).  The launches join the
    kernels' entries.  Last, the host
    cost of a kernel's operator dispatch (`_dispatch_us`)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, materialize

    t_start = time.perf_counter()
    records = _dryrun_records(dry)
    say("dryrun_fake", cells=len(records),
        waited_s=f"{time.perf_counter() - t_start:.1f}",
        trace_s=json.dumps({c: r["t_trace_s"] for c, r in records.items()}))
    wrappers = {k: getattr(ops, v) for k, v in DRYRUN_WRAPPERS.items()}
    phase_launches = dict.fromkeys(wrappers, 0)
    hold_err = {}
    mesh = make_production_mesh(False)
    try:
        for c in DRYRUN_CELLS:
            rec = records[c]
            arch, shape = c.split("/")
            cell = build_cell(arch, shape, mesh)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            params, state, inputs = materialize(
                cell, "cuda", _dryrun_fill(torch, cell, gen))
            counter = dr.PassCounter(dr._axes_of(cell))
            before = {k: w.launches for k, w in wrappers.items()}
            with counter:
                out = cell.step(params, state, inputs)
            del out
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            launched = {k: w.launches - before[k] for k, w in wrappers.items()}
            saw = rec["kernels"]
            for k in wrappers:
                check(launched[k] == saw.get(k, 0),
                      f"dry-run {c}: {launched[k]} {k} launches, the fake "
                      f"pass saw {saw.get(k, 0)}")
            fake_coll = rec["collectives"]["op_counts"]
            check(counter.coll_ops == fake_coll,
                  f"dry-run {c}: collectives {counter.coll_ops}, the fake "
                  f"pass counted {fake_coll}")
            pred = rec["memory"]["peak_bytes"]
            err = abs(pred - peak) / peak
            check(err <= DRYRUN_PEAK_TOL,
                  f"dry-run {c}: predicted peak {pred / 1e9:.3f} GB, "
                  f"measured {peak / 1e9:.3f} GB ({err:.1%})")
            opt_b = rec["memory"]["optimizer_bytes"]
            control = None
            if opt_b:
                control = abs(pred - opt_b - peak) / peak
                check(control > DRYRUN_PEAK_TOL,
                      f"dry-run {c}: the prediction without the AdamW state "
                      f"({(pred - opt_b) / 1e9:.3f} GB) passes the check")
            ms = []
            before = {k: w.launches for k, w in wrappers.items()}
            for _ in range(DRYRUN_REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = cell.step(params, state, inputs)
                end.record()
                end.synchronize()
                del out
                ms.append(start.elapsed_time(end))
            for k, w in wrappers.items():
                reps = w.launches - before[k]
                check(reps == DRYRUN_REPS * saw.get(k, 0),
                      f"dry-run {c}: {reps} {k} launches in {DRYRUN_REPS} "
                      f"steps, want {DRYRUN_REPS * saw.get(k, 0)}")
                phase_launches[k] += launched[k] + reps
            # one more step, its kernels' calls recorded, then the holds,
            # whose own launches are not the path's
            before = {k: w.launches for k, w in wrappers.items()}
            counts = {}

            def run():
                cell.step(params, state, inputs)
                counts.update({k: w.launches - before[k]
                               for k, w in wrappers.items()})
            held = _dryrun_holds(torch, ops, cell, run)
            for k, w in wrappers.items():
                check(counts[k] == saw.get(k, 0),
                      f"dry-run {c}: {counts[k]} {k} launches in the "
                      f"recorded step, want {saw.get(k, 0)}")
                phase_launches[k] += counts[k]
                w.launches = before[k] + counts[k]
            for k, (n, err, rel, ctl) in held.items():
                hold_err[k] = max(hold_err.get(k, 0), err)
                say("dryrun_hold", cell=c, kernel=k, held=n,
                    max_abs_err=err,
                    row_rel_err="n/a" if rel is None else f"{rel:.3e}",
                    control="n/a" if ctl is None else f"{ctl:.3e}")
            del params, state, inputs
            roof = rec["roofline"]
            step_ms = percentile(ms, 50)
            bound = max(roof["t_compute_s"], roof["t_memory_s"]) * 1e3
            say("dryrun", cell=c, mesh=rec["mesh"], kind=rec["kind"],
                predicted_peak_gb=f"{pred / 1e9:.3f}",
                measured_peak_gb=f"{peak / 1e9:.3f}", peak_err=f"{err:.4f}",
                control_err=("n/a" if control is None else f"{control:.4f}"),
                fits=rec["memory"]["fits"],
                launches=json.dumps({k: v for k, v in launched.items() if v}),
                fake_ops=json.dumps(saw),
                collectives=json.dumps(counter.coll_ops),
                step_ms=f"{step_ms:.3f}", steps_ms=json.dumps(
                    [round(x, 3) for x in ms]),
                t_compute_ms=f"{roof['t_compute_s'] * 1e3:.3f}",
                t_memory_ms=f"{roof['t_memory_s'] * 1e3:.3f}",
                t_collective_ms=f"{roof['t_collective_s'] * 1e3:.3f}",
                dominant=roof["dominant"],
                share_of_larger=f"{bound / step_ms:.4f}")
    finally:
        dist.destroy_process_group()
    op_us, direct_us = _dispatch_us(torch, ops)
    say("dryrun_dispatch", what="flash_decode at [1, 64] cache, host us a "
        "call", op_us=f"{op_us:.2f}", direct_us=f"{direct_us:.2f}",
        overhead_us=f"{op_us - direct_us:.2f}")
    by_name = {k["name"]: k for k in kernels}
    for op, name in (("unpack_postings", "unpack_postings"),
                     ("banded_intersect_rows", "banded_intersect_rows"),
                     ("banded_min_delta_rows", "banded_min_delta_rows"),
                     ("banded_delta_mask_rows", "banded_delta_mask_rows"),
                     ("flash_decode", "flash_decode"),
                     ("segment_bag_sums", "segment_bag")):
        entry = by_name[name]
        entry["dryrun_launches"] = phase_launches[op]
        entry["launches"] += phase_launches[op]
        if op in hold_err:
            entry["dryrun_max_abs_err"] = hold_err[op]
    for op in ("flash_decode", "unpack_postings", "banded_intersect_rows"):
        check(phase_launches[op] > 0, f"dry-run: no {op} launch in phase 9")
        check(op in hold_err, f"dry-run: {op} was not held against its "
                              f"plain version")
    phase_done("dryrun", t_start)


# ---------------------------------------------------------------------------
# the port's examples
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart.py", "torch_search_serve.py",
            "torch_distributed_search.py", "torch_train_lm.py")
EXAMPLE_TIMEOUT_S = 600


def example_phase():
    """Phase 10: the port's four examples (examples/torch_*.py), each
    a subprocess on the card at its default size, all started at once
    (their index builds are host work); each must exit 0 within
    EXAMPLE_TIMEOUT_S.  Prints each one's seconds and last lines; kills
    any that is still running when the phase ends."""
    import tempfile
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs, seconds = {}, {}, {}
        try:
            for name in EXAMPLES:
                logs[name] = open(os.path.join(tmp, name + ".log"), "w+")
                procs[name] = subprocess.Popen(
                    [sys.executable, str(root / "examples" / name)],
                    cwd=root, env=env, stdout=logs[name],
                    stderr=subprocess.STDOUT)
            while len(seconds) < len(procs):
                elapsed = time.perf_counter() - t_start
                check(elapsed < EXAMPLE_TIMEOUT_S,
                      f"examples {sorted(set(procs) - set(seconds))} still "
                      f"running after {EXAMPLE_TIMEOUT_S} s")
                for name, p in procs.items():
                    if name not in seconds and p.poll() is not None:
                        seconds[name] = elapsed
                time.sleep(0.2)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
            for fh in logs.values():
                fh.seek(0)
        outs = {name: fh.read() for name, fh in logs.items()}
        for fh in logs.values():
            fh.close()
    for name, p in procs.items():
        tail = outs[name].strip().splitlines()[-3:]
        say("example", name=name, rc=p.returncode,
            seconds=f"{seconds[name]:.1f}", tail=json.dumps(tail))
        check(p.returncode == 0, f"example {name} exited {p.returncode}: "
              + "\n".join(outs[name].strip().splitlines()[-30:]))
    phase_done("examples", t_start)


# ---------------------------------------------------------------------------
# A/B between checkouts (--ab, --ab-attention, --ab-kernels)
# ---------------------------------------------------------------------------

def _ab_child(measure, tree, margs, conn):
    """One spawned run: `repro_torch` from `tree` only, then
    `measure(tree, *margs)`; its dict, or the error, goes back on `conn`."""
    try:
        sys.path.insert(0, str(Path(tree).resolve() / "src"))
        conn.send(measure(tree, *margs))
    except BaseException as e:                      # reported by the parent
        conn.send({"error": f"{type(e).__name__}: {e}"})
    finally:
        conn.close()


def ab_check_trees(trees):
    """Fails unless the card is there and every tree holds the port."""
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    for tree in trees:
        check((Path(tree) / "src" / "repro_torch").is_dir(),
              f"{tree} holds no src/repro_torch")


def ab_runs(trees, measure, *margs) -> list:
    """`measure(tree, *margs)` of each checkout in `trees`, in the order
    given, on one card, each in a fresh (spawned) process that imports
    `repro_torch` from its checkout alone and builds its kernels there.
    Returns [{"tree": tree, **result}, ...]; fails on the first run that
    fails."""
    ctx = multiprocessing.get_context("spawn")
    runs = []
    for tree in trees:
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_ab_child, args=(measure, tree, margs, send))
        p.start()
        send.close()
        try:
            res = recv.recv()
        except EOFError:
            res = {"error": "the run died without a result"}
        p.join()
        check("error" not in res, f"{tree}: {res.get('error')}")
        runs.append({"tree": tree, **res})
    return runs


def _fmt(r):
    return {k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in r.items()}


def _ab_main_path(tree, blob, freeze):
    """The unranked main path of `tree`'s engines (see run_ab)."""
    import torch
    from repro_torch.core import (AdditionalIndexEngine, OrdinaryEngine,
                                  SearchRequest)
    data = pickle.loads(blob)
    index = data["index"]
    batches = [[SearchRequest(q, mode=m) for q, m in b]
               for b in data["batches"]]
    stop_batch = [SearchRequest(q, mode=m) for q, m in data["stop"]]
    if freeze:
        gc.collect()
        gc.freeze()
    out = {}
    for name, cls in (("additional", AdditionalIndexEngine),
                      ("ordinary", OrdinaryEngine)):
        eng = cls(index, device="cuda")
        ex = eng.batch_executor
        eng.search_batch(batches[0])                  # warm-up
        torch.cuda.synchronize()
        for k in ex.timings:
            ex.timings[k] = 0.0
        lat, digest = [], hashlib.sha256()
        for batch in batches[1:]:
            t0 = time.perf_counter()
            resp = eng.search_batch(batch)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            for r in resp:
                digest.update(r.doc.tobytes() + r.pos.tobytes()
                              + str(r.postings_read).encode())
        split = dict(ex.timings)
        t0 = time.perf_counter()
        eng.search_batch(stop_batch)
        torch.cuda.synchronize()
        out[name] = {
            "qps": len(lat) * len(batches[1]) / sum(lat),
            "batch_p50_ms": percentile(lat, 50) * 1e3,
            "batch_p99_ms": percentile(lat, 99) * 1e3,
            "stop_near_batch_ms": (time.perf_counter() - t0) * 1e3,
            **{f"{k}_s": v for k, v in split.items()},
            "digest": digest.hexdigest()[:16]}
        del eng, ex
    return out


AB_DECODE_STEPS = 48           # timed llama3-8b decode steps per run


def _ab_decode(tree, seed, batch, cur_len, steps):
    """`tree`'s llama3-8b decode step at full width in bf16 (random weights
    from `seed`; a [batch, 32768] cache filled to `cur_len`) through the
    flash-decode kernel: p50 / p99 ms of `steps` greedy steps after two
    warm-up steps, and a digest of the tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    cfg = tfm.serving_config(get_arch("llama3-8b").make_config())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tfm.init_params(cfg, gen, device="cuda")
    cache = tfm.init_cache(cfg, batch, 32768, device="cuda")
    for c in cache.values():
        c.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (batch,), generator=gen, device="cuda")
    lat, digest = [], hashlib.sha256()
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tfm.decode_step(model, cache, tok, cur_len + i,
                                        attn_impl="flash")
        tok = logits[:, :cfg.vocab].argmax(-1)
        torch.cuda.synchronize()
        if i >= 2:
            lat.append(time.perf_counter() - t0)
        digest.update(tok.cpu().numpy().tobytes())
    return {"decode_p50_ms": percentile(lat, 50) * 1e3,
            "decode_p99_ms": percentile(lat, 99) * 1e3,
            "decode_digest": digest.hexdigest()[:16]}


def run_ab(args) -> int:
    """`--ab TREE ...`: the unranked main path of each checkout in TREE, in
    the order given, on one card.  The corpus and index are built once, on
    the host, with the package beside this script (the index builder is
    the same code in every checkout of the port so far) and pickled; each
    run (`ab_runs`) unpickles the index into its checkout's classes and
    drives what phase 4 drives for unranked requests: per engine one
    warm-up batch, `--batches` timed batches of the paper's stream and one
    stop-heavy near batch, reporting QPS, batch p50 / p99 and the
    executor's phase seconds.  The list runs once with `gc.collect();
    gc.freeze()` after set-up and once without, so every checkout sees the
    same harness either way.  The answers (doc, pos, postings_read per
    response) must agree across runs.  Then each checkout's llama3-8b
    decode step (`_ab_decode`: full width, bf16, random weights, a
    `--lm-batch` x 32768 cache at `--lm-prompt` tokens, AB_DECODE_STEPS
    flash steps) in the same order: p50 / p99 ms, the tokens equal."""
    import numpy as np
    ab_check_trees(args.ab)
    from repro_torch.core import (CorpusConfig, LexiconConfig, build_all,
                                  generate_corpus, make_lexicon_and_analyzer)

    t0 = time.perf_counter()
    lc = LexiconConfig(seed=args.seed)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=args.docs,
                                              mean_doc_len=800.0,
                                              seed=args.seed))
    index = build_all(corpus, lex, ana)
    n_b, bs = args.batches, args.batch_size
    stream = paper_stream(np, corpus, (n_b + 1) * bs, args.seed + 1)
    blob = pickle.dumps({
        "index": index,
        "batches": [stream[i * bs:(i + 1) * bs] for i in range(n_b + 1)],
        "stop": stop_near_stream(np, corpus, lex, ana, bs, args.seed + 2)},
        protocol=pickle.HIGHEST_PROTOCOL)
    del index, corpus
    gc.collect()
    say("ab_setup", docs=args.docs, pickle_bytes=len(blob),
        seconds=f"{time.perf_counter() - t0:.1f}")

    runs = []
    for freeze in (True, False):
        for r in ab_runs(args.ab, _ab_main_path, blob, freeze):
            for eng in ("additional", "ordinary"):
                say("ab", tree=r["tree"], gc_freeze=freeze, engine=eng,
                    **_fmt(r[eng]))
            runs.append({"gc_freeze": freeze, **r})
    decode = ab_runs(args.ab, _ab_decode, args.seed, args.lm_batch,
                     args.lm_prompt, AB_DECODE_STEPS)
    for r in decode:
        say("ab_decode", **_fmt(r))
    print(json.dumps({"ab": runs, "ab_decode": decode}), flush=True)
    digests = {(eng, r[eng]["digest"]) for r in runs for eng in
               ("additional", "ordinary")}
    check(len(digests) == 2, f"answers differ across runs: {digests}")
    tokens = {r["decode_digest"] for r in decode}
    check(len(tokens) == 1, f"decoded tokens differ across runs: {tokens}")
    return 0


def _ab_attention(tree, shapes, seed):
    """`tree`'s two attention kernels on seeded inputs at the LM path's
    real shapes, each held against its plain version, then timed."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    B, Hq, Hkv, D, S, P, S0 = shapes
    q, k, v = randn((B, Hq, D)), randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
    kv_len = torch.full((B,), P, dtype=torch.int32, device="cuda")
    hold(torch, f"{tree}: flash_decode != plain",
         ops.flash_decode(q, k, v, kv_len),
         ops.flash_decode_plain(q, k, v, kv_len))
    out = {"flash_decode_ms": time_cuda_ms(
        torch, lambda: ops.flash_decode(q, k, v, kv_len))}
    del q, k, v
    q, k, v = randn((1, S0, Hq, D)), randn((1, S0, Hkv, D)), randn((1, S0, Hkv, D))
    hold(torch, f"{tree}: flash_prefill != plain",
         ops.flash_prefill(q, k, v), ops.flash_prefill_plain(q, k, v))
    out["flash_prefill_ms"] = time_cuda_ms(
        torch, lambda: ops.flash_prefill(q, k, v))
    return out


def run_ab_attention(args) -> int:
    """`--ab-attention TREE ...`: the flash-decode and flash-prefill kernels
    of each checkout in TREE (`ab_runs`).  The inputs are bf16 normal draws
    from --seed at phase 5's real shapes (decode: q [B, Hq, D] against
    the [B, 32768, Hkv, D] cache at kv_len = the prompt; prefill: batch 1,
    the prompt's first PREFILL_REAL_S positions), the same in every run;
    each kernel is held against its plain version before it is timed."""
    ab_check_trees(args.ab_attention)
    from repro_torch.configs.registry import LM_SHAPES, get_arch
    cfg = get_arch(args.lm_arch).make_config()
    shapes = (args.lm_batch, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
              LM_SHAPES["decode_32k"]["seq_len"], args.lm_prompt,
              min(PREFILL_REAL_S, args.lm_prompt))
    runs = ab_runs(args.ab_attention, _ab_attention, shapes, args.seed)
    for r in runs:
        say("ab_attention", **_fmt(r))
    print(json.dumps({"ab_attention": runs}), flush=True)
    return 0


def _ab_row_classes(torch, tree, classes, fused):
    """`tree`'s intersect and delta-mask ops on the largest recorded call
    of each b width of each engine (`classes`), each held against its
    plain version, three readings each (the median); with this design's C
    entry points (a stride argument: 0 stages the row) also each regime
    the entry point takes at that width, through the entry point."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.intersect import fence_stride
    plans = len(build.SIGNATURES["intersect"][
        "banded_intersect_rows_launch"]) == 9
    out = {}
    for key, (calls, x) in classes.items():
        name, engine, pb = key.split("|")
        pb = int(pb)
        if name == "banded_intersect_rows":
            x = x[:3]
            want = ops.banded_intersect_rows_plain(*x)
            op = lambda x=x: ops.banded_intersect_rows(*x)
        else:
            x = x if fused else x[:3]
            want = ops.banded_delta_mask_rows_plain(*x[:3])
            op = lambda x=x: ops.banded_delta_mask_rows(*x)
        got = op()
        check(torch.equal(got[0] if isinstance(got, tuple) else got, want),
              f"{tree}: {key} != plain")
        fns = {"ms": op}
        if plans:
            n, pa = x[0].shape
            fn = build.load("intersect" if name == "banded_intersect_rows"
                            else "delta_mask")
            stream = torch.cuda.current_stream().cuda_stream
            for regime, stride in (("staged_ms", 0),
                                   ("fenced_ms", fence_stride(pb))):
                if stride == 0 and pb > 12288:
                    continue               # the staged row's 48 KB
                def launch(x=x, stride=stride, fn=fn, name=name):
                    if name == "banded_intersect_rows":
                        res = torch.empty((n, pa), dtype=torch.bool,
                                          device="cuda")
                        ptrs = (res.data_ptr(),)
                    else:
                        res = torch.empty((2, n, pa), dtype=torch.int32,
                                          device="cuda")
                        ptrs = (res[0].data_ptr(), res[1].data_ptr())
                    build.check(fn(*[t.data_ptr() for t in x], n, pa, pb,
                                   stride, *ptrs, stream), key)
                    return res if res.dim() == 2 else res[0]
                check(torch.equal(launch(), want),
                      f"{tree}: {key} {regime} != plain")
                fns[regime] = launch
        reads = {k: [time_cuda_ms(torch, f) for _ in range(3)]
                 for k, f in fns.items()}
        out[key] = {"a": list(x[0].shape), "b": pb, "calls": calls,
                    "live_a": int((x[0] != 2**31 - 1).sum()),
                    **{k: percentile(v, 50) for k, v in reads.items()}}
    return out


def _ab_row_kernels(torch, tree, rows):
    """`tree`'s three row kernels on the recorded main-path inputs `rows`
    (the largest call of min delta, intersect and delta mask), each held
    against its plain version, then five readings each beside five of the
    launch floor, in turns (medians, and each reading).  A tree whose
    delta-mask op takes no windows (before the window scan moved into its
    launch) is timed on the mask alone."""
    from repro_torch.kernels import ops
    fused = _fused(ops)
    md, it = rows["min_delta"], rows["intersect"]
    dm = rows["delta_mask"] if fused else rows["delta_mask"][:3]
    check(torch.equal(ops.banded_min_delta_rows(*md),
                      ops.banded_min_delta_rows_plain(*md)),
          f"{tree}: banded_min_delta_rows != plain")
    check(torch.equal(ops.banded_intersect_rows(*it),
                      ops.banded_intersect_rows_plain(*it)),
          f"{tree}: banded_intersect_rows != plain")
    mask = ops.banded_delta_mask_rows_plain(*dm[:3])
    got = ops.banded_delta_mask_rows(*dm)
    check(torch.equal(got[0] if fused else got, mask),
          f"{tree}: banded_delta_mask_rows != plain")
    if fused:
        check(torch.equal(got[1], ops.delta_mask_t_bits(mask, dm[3])),
              f"{tree}: banded_delta_mask_rows t_bits != delta_mask_t_bits")
    one = torch.zeros(1, device="cuda")
    fns = {"launch_floor": one.zero_,
           "banded_intersect_rows": lambda: ops.banded_intersect_rows(*it),
           "banded_delta_mask_rows": lambda: ops.banded_delta_mask_rows(*dm),
           "banded_min_delta_rows": lambda: ops.banded_min_delta_rows(*md)}
    reads = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            reads[k].append(time_cuda_ms(torch, fn))
    out = {"delta_mask_fused_t_bits": fused}
    for k, v in reads.items():
        out[f"{k}_ms"] = percentile(v, 50)
        out[f"{k}_ms_each"] = json.dumps([round(t, 5) for t in v])
    return out


def _fused(ops):
    """Whether `ops` is a tree whose delta-mask op takes the windows and
    returns the mask and its window scan."""
    import inspect
    return len(inspect.signature(ops.banded_delta_mask_rows).parameters) == 4


def _ab_kword(torch, kw_blob):
    """The K-word kinds through `tree`'s additional engine on the pickled
    index: one warm-up batch, then each kind's batch five times (p50 of
    the batch's host seconds and of its steps' host seconds from launch
    to results on the host, `timings["device"]`); the CUDA
    kernels of the kind's bucket with the most groups, and of that
    bucket's K-way join (the tree's own `kword_found`: its delta-mask
    launch and window scan), by torch.profiler; a digest of the
    answers."""
    import repro_torch.core.batch_executor as bx
    from repro_torch.core import AdditionalIndexEngine, SearchRequest
    from repro_torch.kernels import ops
    data = pickle.loads(kw_blob)
    eng = AdditionalIndexEngine(data["index"], device="cuda")
    ex = eng.batch_executor

    def batch(reqs):
        return [SearchRequest(q, mode="kword", window=w, rank=rk)
                for q, w, rk in reqs]
    eng.search_batch(batch(data["warmup"]))
    torch.cuda.synchronize()
    out, digest = {}, hashlib.sha256()
    for kind, reqs in data["kinds"].items():
        reqs = batch(reqs)
        lat, step_s = [], []
        for rep in range(5):
            ex.timings["device"] = 0.0
            t0 = time.perf_counter()
            resp = eng.search_batch(reqs)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            step_s.append(ex.timings["device"])
            if rep == 0:
                for r in resp:
                    digest.update(r.doc.tobytes() + r.pos.tobytes())
                    if r.anchor_scores is not None:
                        digest.update(r.anchor_scores.tobytes())
        out[f"{kind}_batch_p50_ms"] = percentile(lat, 50) * 1e3
        out[f"{kind}_step_host_s_p50"] = percentile(step_s, 50)
        # the kind's K-word bucket with the most groups (then the most
        # elements), its tables as the executor made them
        buckets = []
        step = bx.bucket_step_math

        def keep(arena, t, **kw):
            if kw.get("kword"):
                buckets.append((arena, t, kw))
            return step(arena, t, **kw)
        bx.bucket_step_math = keep
        try:
            eng.search_batch(reqs)
        finally:
            bx.bucket_step_math = step
        arena, t, kw = max(buckets, key=lambda b: (
            b[1]["start"].shape[1], b[1]["start"].numel() * b[2]["P"]))
        T, G, F = t["start"].shape
        out[f"{kind}_bucket"] = f"T{T}G{G}F{F}P0{kw['P0']}P{kw['P']}"
        out[f"{kind}_bucket_kernels"] = kernel_count(
            torch, lambda: bx.bucket_step_math(arena, t, **kw))
        # the join's inputs: the bucket's delta-mask call, then the join
        # as the tree's kword_found makes it
        calls = []
        dmr = bx.banded_delta_mask_rows

        def grab(*args):
            calls.append(args)
            return dmr(*args)
        bx.banded_delta_mask_rows = grab
        try:
            bx.bucket_step_math(arena, t, **kw)
        finally:
            bx.banded_delta_mask_rows = dmr
        a_rows, b_rows = calls[-1][0], calls[-1][1]
        bands, active = t["band"][:, 1:], t["active"][:, 1:]
        if hasattr(bx, "kword_found"):
            def join():
                return bx.kword_found(a_rows, b_rows, bands, active)
        else:                              # the join before the fused scan
            def join():
                masks = ops.banded_delta_mask_rows(a_rows, b_rows,
                                                   bands.reshape(-1))
                masks = masks.reshape(T, G - 1, -1).transpose(0, 1)
                return ops.kword_window_hits(masks, active.transpose(0, 1),
                                             bands.max(dim=1).values)
        out[f"{kind}_join_kernels"] = kernel_count(torch, join)
        digest.update(join().cpu().numpy().tobytes())
    out["kword_digest"] = digest.hexdigest()[:16]
    return out


def _ab_kernels(tree, rows_path, kw_blob, seed):
    """`tree`'s embedding-bag kernel at the recsys kernel phase's real
    shapes (built from `seed` by this tree's own code), held against its
    plain version, then timed; FM's serve steps and the bag wrapper's host
    time per call; then the search half (`_ab_search`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import recsys_serve_step
    out = {}
    m = recsys_kernel_inputs(np, torch, seed, np.random.default_rng(seed))
    real = m["real"]
    digest = hashlib.sha256()
    for name, (table, ids, w, combine) in real.items():
        got = ops.segment_bag(table, ids, w, combine)
        want = ops.segment_bag_plain(table, ids, w, combine)
        check(bag_ok(torch, got, want, w is None
                     and table.dtype == torch.float32),
              f"{tree}: segment_bag != plain at {name}")
        digest.update(want.cpu().numpy().tobytes())
        out[f"segment_bag_{name}_ms"] = time_cuda_ms(
            torch, lambda: ops.segment_bag(table, ids, w, combine))
    # the same call with every bag reading one row per field (the batch's
    # smallest id of each field): every row an L1 hit, so the time left is
    # the ids' and sums' traffic and the arithmetic
    table, ids, _, _ = real["fm_table_serve_bulk"]
    hot = ids.min(dim=0, keepdim=True).values.expand_as(ids).contiguous()
    check(torch.equal(ops.segment_bag(table, hot),
                      ops.segment_bag_plain(table, hot)),
          f"{tree}: segment_bag != plain at one row per field")
    out["segment_bag_fm_table_one_row_per_field_ms"] = time_cuda_ms(
        torch, lambda: ops.segment_bag(table, hot))
    # the wrapper's host time per call at serve_p99 (200 calls enqueued
    # back to back: the host, not the card, sets their pace) and FM's
    # serve steps, p50 of the host's step times
    fm, batches = m["fm"], m["fm_batches"]
    p99_ids = (batches["serve_p99"]["ids"].long()
               + m["fm_cfg"].field_offsets("cuda")[None]).int()
    ops.segment_bag(fm.table, p99_ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ops.segment_bag(fm.table, p99_ids)
    torch.cuda.synchronize()
    out["segment_bag_serve_p99_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    for shape, reps in (("serve_p99", 30), ("serve_bulk", 5)):
        _, secs = timed_steps(torch, recsys_serve_step, fm, batches[shape],
                              reps)
        out[f"fm_{shape}_step_p50_ms"] = percentile(secs, 50) * 1e3
    del m, real, table, ids, hot, fm, batches
    gc.collect()
    torch.cuda.empty_cache()
    out["digest"] = digest.hexdigest()[:16]
    return {**out, **_ab_search(torch, tree, rows_path, kw_blob)}


def _ab_search(torch, tree, rows_path, kw_blob):
    """The search half of a run: the K-word kinds (`_ab_kword`), then the
    row kernels on the recorded inputs at `rows_path` (`_ab_row_kernels`,
    `_ab_row_classes`), last, on a card the calls before have kept busy:
    each is a few dependent trips to memory, and its single readings in a
    fresh process move by a fifth."""
    from repro_torch.kernels import ops
    out = _ab_kword(torch, kw_blob)
    saved = torch.load(rows_path)
    rows = {k: [x.cuda() for x in v] for k, v in saved["rows"].items()}
    out.update(_ab_row_kernels(torch, tree, rows))
    classes = {k: (n, [x.cuda() for x in v])
               for k, (n, v) in saved["classes"].items()}
    out["classes"] = _ab_row_classes(torch, tree, classes, _fused(ops))
    return out


def run_ab_kernels(args) -> int:
    """`--ab-kernels TREE ...`: the row kernels, the embedding-bag kernel
    and the K-word path of each checkout in TREE (`ab_runs`).  An index of
    --docs documents is built once with the package beside this script;
    the search warm-up batches record the largest call of min delta, of
    intersect and of delta mask (with the windows the K-word join gives
    it), and all of the main path's batches through both engines the
    largest call of each b width of intersect and delta mask, which every
    run gets; the index and the K-word batches go to every run pickled (the
    index builder is the same code in every checkout of the port so far).
    Each run: the bag kernel at the recsys kernel phase's real shapes from
    --seed, built with its own code (the plain version's sums must agree
    across runs), and FM's serve_bulk call once more with every bag reading
    one row per field; the bag wrapper's host time per call at serve_p99
    and FM's serve_p99 and serve_bulk step p50; the K-word and ranked
    K-word batches five times each (batch p50, `device` seconds p50) and
    a torch.profiler count of the CUDA kernels of each kind's bucket with
    the most groups and of its K-way join (the answers must agree across
    runs); then the intersect, delta-mask and min-delta kernels and the
    launch floor five times each, in turns (medians, and each reading),
    and intersect and delta mask on each b width's call (`_ab_row_classes`).
    Each kernel is held against its plain version before it is timed."""
    import numpy as np
    import torch
    ab_check_trees(args.ab_kernels)
    import tempfile

    import repro_torch.core.batch_executor as bx
    from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                                  LexiconConfig, OrdinaryEngine, build_all,
                                  generate_corpus, make_lexicon_and_analyzer)
    t0 = time.perf_counter()
    lc = LexiconConfig(seed=args.seed)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=args.docs,
                                              mean_doc_len=800.0,
                                              seed=args.seed))
    index = build_all(corpus, lex, ana)
    batches, stop_batch, ranked, kw = search_batches(np, corpus, lex, ana,
                                                     args)
    names = ("banded_min_delta_rows", "banded_intersect_rows",
             "banded_delta_mask_rows")
    rec = {"banded_min_delta_rows": Recorder(
               bx.banded_min_delta_rows,
               lambda a, bk, bd, bands: a.numel() + bk.numel()),
           "banded_intersect_rows": Recorder(
               bx.banded_intersect_rows, lambda a, b, bands: a.numel()),
           "banded_delta_mask_rows": Recorder(
               bx.banded_delta_mask_rows,
               lambda a, b, bands, windows: a.numel() + b.numel())}
    for name in names:
        setattr(bx, name, rec[name])
    try:
        eng = AdditionalIndexEngine(index, device="cuda")
        for batch in (batches[0], ranked[0], kw[0]):
            eng.search_batch(batch)
    finally:
        for name in names:
            setattr(bx, name, rec[name].fn)
    check(all(r.best is not None for r in rec.values()),
          "the warm-up batches reached not every row kernel")
    rows = {"min_delta": rec["banded_min_delta_rows"].best,
            "intersect": rec["banded_intersect_rows"].best,
            "delta_mask": rec["banded_delta_mask_rows"].best}
    # the largest call of each b width of the intersect and delta-mask
    # kernels, per engine, over all of the main path's batches
    logged = ("banded_intersect_rows", "banded_delta_mask_rows")
    classes = {}
    for ename, cls in (("additional", AdditionalIndexEngine),
                       ("ordinary", OrdinaryEngine)):
        recs = {k: Recorder(getattr(bx, k), lambda a, *rest: a.numel())
                for k in logged}
        for k, r in recs.items():
            setattr(bx, k, r)
        try:
            eng_c = cls(index, device="cuda")
            for batch in batches + [stop_batch] + ranked + kw:
                eng_c.search_batch(batch)
        finally:
            for k, r in recs.items():
                setattr(bx, k, r.fn)
        for k, r in recs.items():
            for pb, (n, _, inp) in sorted(r.by_pb.items()):
                classes[f"{k}|{ename}|{pb}"] = (n, [x.cpu() for x in inp])
        del eng_c, recs
    tmp = tempfile.mkdtemp()
    rows_path = os.path.join(tmp, "rows.pt")
    torch.save({"rows": {k: [x.cpu() for x in v] for k, v in rows.items()},
                "classes": classes}, rows_path)

    def reqs(b):
        return [(r.surface_ids, r.window, r.rank) for r in b]
    kw_blob = pickle.dumps({"index": index, "warmup": reqs(kw[0]),
                            "kinds": {"kword": reqs(kw[1]),
                                      "kword_ranked": reqs(kw[2])}},
                           protocol=pickle.HIGHEST_PROTOCOL)
    say("ab_kernels_setup", docs=args.docs,
        **{k: f"a{tuple(v[0].shape)}b{tuple(v[1].shape)}"
           for k, v in rows.items()},
        classes=len(classes), kword_pickle_bytes=len(kw_blob),
        seconds=f"{time.perf_counter() - t0:.1f}")
    del eng, index, corpus, rec, rows, classes
    gc.collect()
    torch.cuda.empty_cache()
    try:
        runs = ab_runs(args.ab_kernels, _ab_kernels, rows_path, kw_blob,
                       args.seed)
    finally:
        os.unlink(rows_path)
        os.rmdir(tmp)
    for r in runs:
        for key, c in r["classes"].items():
            name, engine, pb = key.split("|")
            say("ab_kernel_class", tree=r["tree"], name=name, engine=engine,
                **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                   for k, v in c.items()})
        say("ab_kernels", **_fmt({k: v for k, v in r.items()
                                  if k != "classes"}))
    print(json.dumps({"ab_kernels": runs}), flush=True)
    check(len({r["digest"] for r in runs}) == 1,
          "the bag inputs differ across runs")
    check(len({r["kword_digest"] for r in runs}) == 1,
          "the K-word answers differ across runs")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--segment-docs", type=int, default=1000,
                    help="documents of phase 4c's segments (a cut depth)")
    ap.add_argument("--front-threads", action="store_true",
                    help="diagnostic: phase 4c (b) also times the unranked "
                         "batches with the four shards called in turn and "
                         "through the front at a 0.1 ms switch interval")
    ap.add_argument("--lm-arch", default="llama3-8b",
                    help="LM of the serving phase, at full width")
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--lm-prompt", type=int, default=31744,
                    help="prompt tokens per row (a multiple of 1024 above "
                         "8192 runs the chunked prefill)")
    ap.add_argument("--lm-steps", type=int, default=32,
                    help="greedy decode steps after the prefill")
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="A/B the unranked main path of these checkouts "
                         "(run order, e.g. PARENT . . PARENT) instead of "
                         "the smoke run")
    ap.add_argument("--ab-attention", nargs="+", metavar="TREE",
                    help="A/B the two attention kernels of these checkouts "
                         "at the LM path's real shapes instead of the "
                         "smoke run")
    ap.add_argument("--ab-kernels", nargs="+", metavar="TREE",
                    help="A/B the row kernels, the embedding-bag kernel "
                         "and the K-word path of these checkouts at their "
                         "real shapes instead of the smoke run")
    args = ap.parse_args(argv)
    for flag, mode in (("ab", run_ab), ("ab_attention", run_ab_attention),
                       ("ab_kernels", run_ab_kernels)):
        if getattr(args, flag):
            try:
                return mode(args)
            except SmokeFailure as e:
                print(f"chip_smoke --{flag.replace('_', '-')}: FAILED: {e}",
                      file=sys.stderr)
                return 1
    try:
        device = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
