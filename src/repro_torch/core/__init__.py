"""Core: the paper's additional-index phrase-search system, in PyTorch.

Public search surface: build a `SearchRequest`, hand it to an engine's
`search` / `search_batch`, read the `SearchResponse` — see core/api.py.
"""
from repro_torch.core.analyzer import Analyzer, make_lexicon_and_analyzer
from repro_torch.core.api import (DocHit, RankingParams, SearchRequest,
                                  SearchResponse)
from repro_torch.core.batch_executor import BatchDeviceIndex, BatchExecutor
from repro_torch.core.builder import IndexParams, IndexSet, build_all
from repro_torch.core.corpus import Corpus, CorpusConfig, generate_corpus
from repro_torch.core.engine import (AdditionalIndexEngine, OrdinaryEngine,
                                     brute_force_kword,
                                     brute_force_kword_ranked,
                                     brute_force_ranked, brute_force_search,
                                     near_query_contains_stop,
                                     near_query_stop_confined)
from repro_torch.core.executor import DeviceIndex, Executor
from repro_torch.core.lexicon import LexiconConfig
from repro_torch.core.kword import MODE_KWORD
from repro_torch.core.planner import MODE_NEAR, MODE_PHRASE, Planner, QueryPlan
# segments last: it builds on builder/corpus/planner above (its serve-side
# imports are lazy, inside methods — no core -> serve import cycle)
from repro_torch.core.segments import (IndexSegment, SegmentManager,
                                       concat_corpora, corpus_batches)

__all__ = [
    "Analyzer", "make_lexicon_and_analyzer",
    "DocHit", "RankingParams", "SearchRequest", "SearchResponse",
    "BatchDeviceIndex", "BatchExecutor",
    "IndexParams", "IndexSet", "build_all",
    "Corpus", "CorpusConfig", "generate_corpus",
    "AdditionalIndexEngine", "OrdinaryEngine", "brute_force_kword",
    "brute_force_kword_ranked", "brute_force_ranked", "brute_force_search",
    "near_query_contains_stop", "near_query_stop_confined",
    "DeviceIndex", "Executor", "LexiconConfig",
    "MODE_KWORD", "MODE_NEAR", "MODE_PHRASE", "Planner", "QueryPlan",
    "IndexSegment", "SegmentManager", "concat_corpora", "corpus_batches",
]
