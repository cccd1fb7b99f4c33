"""Checkpoint store (counterpart of ``repro.checkpoint``), numpy only."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, all_steps,
                                          latest_step, load_extra,
                                          restore_checkpoint,
                                          save_checkpoint)

__all__ = ["AsyncCheckpointer", "all_steps", "latest_step", "load_extra",
           "restore_checkpoint", "save_checkpoint"]
