"""Training (counterpart of ``repro.train``): AdamW with global-norm
clipping and warm-up on tensor trees, and the train step with microbatch
accumulation."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
from repro_torch.train.step import TrainConfig, make_grad_fn, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "make_grad_fn", "make_train_step", "TrainConfig"]
