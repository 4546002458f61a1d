from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_state, lr_schedule)
