"""Serving layer of the port: batched phrase-query serving over
doc-partitioned arenas (`search_serve`)."""
from repro_torch.serve.search_serve import (SearchServe,  # noqa: F401
                                            SearchServeConfig, arena_specs,
                                            make_search_serve_step,
                                            query_table_specs)
