from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               CheckpointError,
                                               CheckpointManager,
                                               committed_steps,
                                               load_checkpoint,
                                               save_checkpoint)

__all__ = ["CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "committed_steps", "load_checkpoint", "save_checkpoint"]
