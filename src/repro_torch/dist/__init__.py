"""Distribution substrate of the port: training supervision with checkpoint
restart and straggler-mitigating dispatch over replicated document shards
(`fault_tolerance`), the fault injection that drives the dispatch
(`chaos`) and the explicit ring all-reduce (`collectives`)."""
