"""Distribution substrate of the port: training supervision with checkpoint
restart and straggler-mitigating dispatch over replicated document shards
(`fault_tolerance`), the fault injection that drives the dispatch
(`chaos`), the explicit collectives (`collectives`: the ring all-reduce,
the int8 all-reduce with error feedback of data-parallel training, and the
GIN's halo exchange under autograd) and the placements on the
data-parallel axis (`sharding`)."""
