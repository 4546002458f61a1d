"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030]."""
from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.data.recsys_data import criteo_vocabs
from repro_torch.models.recsys import RecSysConfig


def make_config() -> RecSysConfig:
    return RecSysConfig(name="mind", model="mind",
                        field_vocabs=criteo_vocabs(8, max_vocab=200_000),
                        embed_dim=64, n_interests=4, capsule_iters=3,
                        seq_len=50, item_vocab=1_000_000)


def make_smoke_config() -> RecSysConfig:
    return RecSysConfig(name="mind-smoke", model="mind",
                        field_vocabs=criteo_vocabs(4, max_vocab=200),
                        embed_dim=16, n_interests=2, capsule_iters=2,
                        seq_len=8, item_vocab=1000)


SPEC = ArchSpec(arch_id="mind", family="recsys", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=RECSYS_SHAPES)
