"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --device cpu

  lm     — greedy decode from the architecture's smoke config with the KV
           cache decode step (`decode_step`, attention through the
           flash-decode kernel), batch 2, cache of 128 positions: the
           reference's `serve_lm`.  Runs on the card unless `--device cpu`.
  search — not ported yet: it needs the serve tier (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.executor import resolve_device
from repro_torch.models import transformer as tfm


def serve_lm(arch: str, n_tokens: int, device=None) -> list:
    """Greedy decode of `n_tokens` tokens, batch 2, from token 0, with
    weights from `init_params` and a generator seeded 0.  Returns batch row
    0's tokens; ties in the argmax go to the lowest index, as
    `jnp.argmax`."""
    cfg = get_arch(arch).make_smoke_config()
    dev = resolve_device(device)
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    B, S_max = 2, 128
    cache = tfm.init_cache(cfg, B, S_max, device=dev)
    tok = torch.zeros((B,), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    toks = []
    for i in range(n_tokens):
        logits, cache = tfm.decode_step(model, cache, tok, i,
                                        attn_impl="flash")
        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        toks.append(tok)
    out = torch.stack(toks, dim=1)[0].tolist() if toks else []
    dt = time.perf_counter() - t0
    print(f"[serve/lm] {arch} decoded {n_tokens} tokens x batch {B} in "
          f"{dt * 1e3:.0f} ms ({dt / max(n_tokens, 1) * 1e3:.1f} ms/token, "
          f"{dev.type}); first 10: {out[:10]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["search", "lm"], default="lm")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.mode == "search":
        raise NotImplementedError(
            "--mode search needs the serve tier, which is not ported yet "
            "(ROADMAP.md queue 1, items 6 and 9)")
    serve_lm(args.arch, args.tokens, device=args.device)


if __name__ == "__main__":
    main()
