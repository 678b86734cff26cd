"""Atomic checkpoints of tensor trees, in the reference's on-disk format."""

from repro_torch.checkpoint.ckpt import load_tree, save_tree  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
