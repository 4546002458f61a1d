"""Distribution substrate of the port's serving side: straggler-mitigating
dispatch over replicated document shards (`fault_tolerance`) and the fault
injection that drives it (`chaos`)."""
