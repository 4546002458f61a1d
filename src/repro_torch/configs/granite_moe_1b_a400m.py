"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import torch

from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab=49155, rope_theta=10_000.0,
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512))


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=512, rope_theta=10_000.0,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64), dtype=torch.float32)


SPEC = ArchSpec(arch_id="granite-moe-1b-a400m", family="lm",
                make_config=make_config, make_smoke_config=make_smoke_config,
                shapes=LM_SHAPES)
