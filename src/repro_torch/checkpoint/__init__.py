"""Checkpoint subsystem (counterpart of `repro.checkpoint`): the tensor
save/restore API of `repro_torch.checkpoint.checkpoint`. The reference's
restart cost model serves its cluster simulator and is not ported."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
