"""Checkpointing of the port: the JAX package's on-disk format."""
from .ckpt import (latest_checkpoint, reshard_rates, restore_checkpoint,
                   save_checkpoint)

__all__ = ["latest_checkpoint", "reshard_rates", "restore_checkpoint",
           "save_checkpoint"]
