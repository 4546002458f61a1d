"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-parameter
llama-style model for a few hundred steps, with checkpoints.  The
counterpart of examples/train_lm.py, on the card unless `--device cpu`.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--tiny]
        [--ckpt DIR] [--device cpu]

Without `--ckpt` the checkpoints go to a temporary directory that is
removed at the end; with it, a second run resumes from its latest step.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.executor import resolve_device
from repro_torch.data.lm_data import lm_batches
from repro_torch.models import transformer as tfm
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_loop import fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer model for a fast demo run")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.tiny:
        cfg = tfm.TransformerConfig(
            name="lm-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=384, vocab=2048, dtype=torch.float32, remat=False)
        batch, seq = 8, 64
    else:
        # ~100M params: 12L x 768d, GQA 12/4, llama3-style
        cfg = tfm.TransformerConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_ff=2048, vocab=32768, dtype=torch.float32, remat=False)
        batch, seq = 4, 256
    print(f"model: {cfg.name}, params={cfg.param_count():,}, "
          f"device={device.type}")

    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            "cpu").to(device)
    data = lm_batches(cfg.vocab, batch=batch, seq_len=seq, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(args.ckpt or tmp, keep=2)
        _, _, hist = fit(
            model, tfm.loss_fn,
            OptimizerConfig(lr=3e-4, warmup_steps=20, decay_steps=args.steps),
            data, n_steps=args.steps, ckpt=ckpt, log_every=10)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {args.steps} steps")
    return hist


if __name__ == "__main__":
    main()
