from .checkpoint import save, restore, latest_step, CheckpointManager
