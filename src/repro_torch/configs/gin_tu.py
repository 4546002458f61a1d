"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826].  d_feat / n_classes are shape-specific (each graph shape
is its own dataset); dataclasses.replace patches them per cell."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GINConfig


def make_config() -> GINConfig:
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                     d_feat=1433, n_classes=7)


def make_smoke_config() -> GINConfig:
    return GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16,
                     d_feat=8, n_classes=3)


SPEC = ArchSpec(arch_id="gin-tu", family="gnn", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=GNN_SHAPES)
