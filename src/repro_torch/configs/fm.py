"""fm [recsys] n_sparse=39 embed_dim=10 interaction=fm-2way — pairwise
<v_i, v_j> x_i x_j via the O(nk) sum-square trick [Rendle ICDM'10]."""
from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES
from repro_torch.data.recsys_data import criteo_vocabs
from repro_torch.models.recsys import RecSysConfig


def make_config() -> RecSysConfig:
    return RecSysConfig(name="fm", model="fm",
                        field_vocabs=criteo_vocabs(39, max_vocab=1_000_000),
                        embed_dim=10)


def make_smoke_config() -> RecSysConfig:
    return RecSysConfig(name="fm-smoke", model="fm",
                        field_vocabs=criteo_vocabs(6, max_vocab=500),
                        embed_dim=10)


SPEC = ArchSpec(arch_id="fm", family="recsys", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=RECSYS_SHAPES)
