"""qwen2.5-32b [dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
import torch

from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=27648, vocab=152064, qkv_bias=True,
        rope_theta=1_000_000.0)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b-smoke", n_layers=2, d_model=160, n_heads=5,
        n_kv_heads=1, d_ff=448, vocab=512, qkv_bias=True,
        rope_theta=1_000_000.0, dtype=torch.float32)


SPEC = ArchSpec(arch_id="qwen2.5-32b", family="lm", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=LM_SHAPES)
