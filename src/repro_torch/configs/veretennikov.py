"""veretennikov [search] — the paper's own system as a serving architecture.

Per-shard arena sizes model the paper's 45 GB / ~130k-document corpus
(259 GB total index) document-partitioned over the dp ranks; see
serve/search_serve.py.  Shapes cover interactive, bulk and worst-case
(frequent-word-heavy) query mixes.
"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.serve.search_serve import SearchServeConfig

# paper-scale postings per shard at 512 shards (scaled from measured
# postings-per-token ratios of the synthetic build)
_BASE = dict(n_basic=10_000_000, n_expanded=17_000_000, n_stop=23_000_000,
             n_multi=12_000_000)

SEARCH_SHAPES = {
    "serve_batch": {"kind": "search_serve", "queries": 64, "postings_pad": 32768,
                    **_BASE},
    "serve_p99": {"kind": "search_serve", "queries": 8, "postings_pad": 8192,
                  **_BASE},
    "serve_heavy": {"kind": "search_serve", "queries": 16, "postings_pad": 262144,
                    **_BASE},
    "serve_bulk": {"kind": "search_serve", "queries": 256, "postings_pad": 16384,
                   **_BASE},
    # proximity-ranked serving (arXiv:2108.00410): the step variant with the
    # scoring pass and a float32 score output per row
    "serve_ranked": {"kind": "search_serve", "queries": 64,
                     "postings_pad": 32768, "ranked": True, **_BASE},
}


def make_config() -> SearchServeConfig:
    return SearchServeConfig(name="veretennikov", **_BASE)


def make_smoke_config() -> SearchServeConfig:
    return SearchServeConfig(name="veretennikov-smoke", queries=4, groups=3,
                             fetch_slots=2, postings_pad=256, check_slots=2,
                             n_basic=4096, n_expanded=4096, n_stop=4096,
                             n_first=1024, n_multi=4096)


SPEC = ArchSpec(arch_id="veretennikov", family="search", make_config=make_config,
                make_smoke_config=make_smoke_config, shapes=SEARCH_SHAPES)
