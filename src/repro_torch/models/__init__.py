"""The LM template: config, layers, SSM blocks, transformer; ``lm_loss``
is the training loss."""
from repro_torch.models.transformer import lm_loss

__all__ = ["lm_loss"]
