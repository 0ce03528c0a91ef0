from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               latest_step, read_manifest,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               verify_checkpoint)

__all__ = ["CheckpointCorruptError", "latest_step", "read_manifest",
           "restore_checkpoint", "save_checkpoint", "verify_checkpoint"]
