"""llama3-8b [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA 128k vocab [arXiv:2407.21783]."""
import torch

from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=128256, rope_theta=500_000.0)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-8b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=352, vocab=512, rope_theta=500_000.0,
        dtype=torch.float32)


SPEC = ArchSpec(arch_id="llama3-8b", family="lm", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=LM_SHAPES)
