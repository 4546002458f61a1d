"""repro_torch: the PyTorch/CUDA port of the additional-index phrase search
engine (Veretennikov, arXiv:1801.09079), beside the JAX reference package
`repro`.

The port imports torch and numpy only — never jax and nothing of `repro`;
it keeps its own copy of every module it needs.  Its entry points run on
the card unless the caller asks for the CPU (`device="cpu"`); on the card
the search path and its serve tier (`serve`, over `launch.mesh`), the LM
serving path and the recsys serving path (`models`, `launch`; the dense
LMs, recsys models and `veretennikov` of `configs`) launch the
hand-written CUDA kernels of `repro_torch.kernels` (sources in
`kernels/csrc/`).  Training (`train`, `checkpoint`,
`dist.fault_tolerance.TrainSupervisor`, `launch.train`) trains the LMs,
the recsys models and the GIN (`models.gnn`, `data.graph_data`) on one
device, and data-parallel over a process group
(`train.train_loop.make_sharded_train_step`, float32 or int8 gradient
all-reduce: `dist.collectives`; elastic restore: `dist.sharding`); FM's
bag sums take their gradient through the bag kernel.  Importing the
package sets no global state.
"""
