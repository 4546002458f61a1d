"""Training launcher: `--arch <id>` resolves the registry, builds the data
pipeline for the family, and trains with `fit` (checkpoints under
`--ckpt`).

The port of src/repro/launch/train.py for the lm, gnn and recsys
families, on the card unless `--device cpu` is asked for.  The weights
come from the port's `init_params` with a CPU generator seeded 0, moved to
the device, so the card and the CPU start from the same weights; the data
from `lm_batches` / `ClickLog` / `graph_data` seeded 0 (gnn: `--shape
molecule` batches of small graphs with the sum readout, `minibatch_lg`
fanout-sampled subgraphs, otherwise the full graph).  The smoke config is
the default (`--full` selects the real one); the served-only family
exits.  Data-parallel training is a library function
(`train_loop.make_sharded_train_step`), as in the reference: the launcher
trains on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \\
        --shape molecule --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.core.executor import resolve_device
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_loop import fit


def _lm_setup(cfg, batch, seq, device):
    from repro_torch.data.lm_data import lm_batches
    from repro_torch.models import transformer as tfm
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            "cpu").to(device)
    data = lm_batches(cfg.vocab, batch=batch, seq_len=seq, seed=0)
    return model, data, tfm.loss_fn


def _gnn_setup(cfg, shape_name, device):
    from repro_torch.data import graph_data
    from repro_torch.models import gnn

    def init(c):
        return gnn.init_params(c, torch.Generator().manual_seed(0),
                               "cpu").to(device)

    if shape_name == "molecule":
        cfg = dataclasses.replace(cfg, graph_readout=True)

        def gen():
            seed = 0
            while True:
                b = graph_data.molecule_batch(8, 12, 24, cfg.d_feat,
                                              cfg.n_classes, seed=seed)
                seed += 1
                yield {k: v for k, v in b.items() if k != "n_graphs"}

        extra = {"n_graphs": 8}
        return init(cfg), gen(), (lambda m, b: gnn.loss_fn(m, dict(b, **extra)))
    g = graph_data.generate_graph(600, 4000, cfg.d_feat, cfg.n_classes, seed=0)
    model = init(cfg)
    if shape_name == "minibatch_lg":
        rng = np.random.default_rng(0)

        def gen():
            while True:
                seeds = rng.integers(0, g.n_nodes, 32)
                yield graph_data.sample_subgraph(g, seeds, (5, 3), rng)

        return model, gen(), gnn.loss_fn

    full = graph_data.full_graph_batch(g)

    def gen():
        while True:
            yield full

    return model, gen(), gnn.loss_fn


def _recsys_setup(cfg, batch, device):
    from repro_torch.data.recsys_data import ClickLog
    from repro_torch.models import recsys
    model = recsys.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(device)
    log = ClickLog(cfg.field_vocabs, item_vocab=cfg.item_vocab,
                   seq_len=cfg.seq_len, seed=0)
    seq = cfg.model in ("bst", "mind")

    def gen():
        while True:
            yield log.seq_batch(batch) if seq else log.ctr_batch(batch)

    return model, gen(), recsys.loss_fn


def main(argv=None) -> list:
    """Trains as `argv` asks; returns the history of `fit`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="gnn: which graph regime")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full-scale config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family not in ("lm", "gnn", "recsys"):
        raise SystemExit(f"--arch {args.arch}: family {spec.family} is "
                         "served, not trained (see repro_torch.launch.serve)")
    dev = resolve_device(args.device)
    cfg = spec.make_config() if args.full else spec.make_smoke_config()
    if spec.family == "lm":
        model, data, loss_fn = _lm_setup(cfg, args.batch, args.seq, dev)
    elif spec.family == "gnn":
        model, data, loss_fn = _gnn_setup(cfg, args.shape or "full_graph_sm",
                                          dev)
    else:
        model, data, loss_fn = _recsys_setup(cfg, args.batch, dev)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={args.arch} family={spec.family} params={n_params:,} "
          f"device={dev.type}")
    ckpt = CheckpointManager(args.ckpt, keep=2) if args.ckpt else None
    _, _, hist = fit(model, loss_fn,
                     OptimizerConfig(lr=args.lr, warmup_steps=5,
                                     decay_steps=max(args.steps, 10)),
                     data, n_steps=args.steps, ckpt=ckpt, log_every=10)
    print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
