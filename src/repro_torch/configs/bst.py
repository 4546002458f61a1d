"""bst [recsys] embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq (Alibaba) [arXiv:1905.06874]."""
from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.data.recsys_data import criteo_vocabs
from repro_torch.models.recsys import RecSysConfig


def make_config() -> RecSysConfig:
    return RecSysConfig(name="bst", model="bst",
                        field_vocabs=criteo_vocabs(8, max_vocab=200_000),
                        embed_dim=32, seq_len=20, n_blocks=1, bst_heads=8,
                        mlp_dims=(1024, 512, 256), item_vocab=1_000_000)


def make_smoke_config() -> RecSysConfig:
    return RecSysConfig(name="bst-smoke", model="bst",
                        field_vocabs=criteo_vocabs(4, max_vocab=200),
                        embed_dim=16, seq_len=8, n_blocks=1, bst_heads=4,
                        mlp_dims=(64, 32), item_vocab=1000)


SPEC = ArchSpec(arch_id="bst", family="recsys", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=RECSYS_SHAPES)
