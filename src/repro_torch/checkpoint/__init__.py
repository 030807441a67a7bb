from .save_restore import (CheckpointManager, restore_checkpoint,
                           save_checkpoint)

__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]
