from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                              restore_pytree, save_pytree)
