"""granite-3-8b [dense] 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
import torch

from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=12800, vocab=49155, rope_theta=10_000.0)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-3-8b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=384, vocab=512, rope_theta=10_000.0,
        dtype=torch.float32)


SPEC = ArchSpec(arch_id="granite-3-8b", family="lm", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=LM_SHAPES)
