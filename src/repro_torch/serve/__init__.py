"""Serving layer of the port: the front door (`front`: micro-batching,
admission control, doc-shard fan-out, graceful degradation) over batched
phrase-query serving on doc-partitioned arenas (`search_serve`)."""
from repro_torch.serve.front import (FrontDoor, FrontDoorConfig,  # noqa: F401
                                     FrontStats, ShardBackend, TokenBucket,
                                     build_doc_shards, merge_shard_responses)
from repro_torch.serve.search_serve import (SearchServe,  # noqa: F401
                                            SearchServeConfig, arena_specs,
                                            make_search_serve_step,
                                            query_table_specs)
