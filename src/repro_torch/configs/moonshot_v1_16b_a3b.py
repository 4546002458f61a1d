"""moonshot-v1-16b-a3b [moe] 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
import torch

from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=163840, rope_theta=50_000.0,
        head_dim=128,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408))


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=512, rope_theta=50_000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96), dtype=torch.float32)


SPEC = ArchSpec(arch_id="moonshot-v1-16b-a3b", family="lm",
                make_config=make_config, make_smoke_config=make_smoke_config,
                shapes=LM_SHAPES)
