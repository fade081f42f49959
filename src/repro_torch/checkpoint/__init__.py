from repro_torch.checkpoint.store import CheckpointManager

__all__ = ["CheckpointManager"]
