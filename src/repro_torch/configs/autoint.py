"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn [arXiv:1810.11921]."""
from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.data.recsys_data import criteo_vocabs
from repro_torch.models.recsys import RecSysConfig


def make_config() -> RecSysConfig:
    return RecSysConfig(name="autoint", model="autoint",
                        field_vocabs=criteo_vocabs(39, max_vocab=1_000_000),
                        embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32)


def make_smoke_config() -> RecSysConfig:
    return RecSysConfig(name="autoint-smoke", model="autoint",
                        field_vocabs=criteo_vocabs(6, max_vocab=500),
                        embed_dim=16, n_attn_layers=2, n_heads=2, d_attn=8)


SPEC = ArchSpec(arch_id="autoint", family="recsys", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=RECSYS_SHAPES)
