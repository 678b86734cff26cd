"""Checkpoint manager: rotation, latest-resolution, restart-from-failure —
the twin of ``repro.checkpoint.manager``."""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint.ckpt import load_tree, save_tree

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """Rotating step-indexed checkpoints under one root directory.

    * ``save(step, tree)`` writes atomically and prunes to ``keep`` newest
      (rank 0 of a process group alone, the others waiting for it).
    * ``restore_latest(like)`` returns (step, tree) of the newest *valid*
      checkpoint — corrupt/partial ones (crash mid-write) are skipped and
      removed, which is the node-failure recovery path.
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dirs(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and not name.endswith(".tmp"):
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def save(self, step: int, tree, meta: Optional[Dict] = None) -> str:
        """Inside a process group only rank 0 writes (every rank holds the
        same gathered tree), and every rank waits at a barrier until the
        checkpoint is whole."""
        path = os.path.join(self.root, f"step_{step:08d}")
        grouped = dist.is_available() and dist.is_initialized()
        if not grouped or dist.get_rank() == 0:
            save_tree(path, tree, extra_meta=dict(meta or {}, step=step))
            self._prune()
        if grouped:
            dist.barrier()
        return path

    def _prune(self) -> None:
        dirs = self._step_dirs()
        for _step, path in dirs[: max(len(dirs) - self.keep, 0)]:
            shutil.rmtree(path, ignore_errors=True)

    def restore_latest(self, like=None) -> Tuple[Optional[int], Any, Dict]:
        """Newest valid checkpoint, skipping corrupt ones.  (None, None, {})
        if nothing restorable exists."""
        for step, path in reversed(self._step_dirs()):
            try:
                tree, meta = load_tree(path, like=like)
                return step, tree, meta
            except Exception:
                # Partial/corrupt (e.g. the writer died): drop and keep looking.
                shutil.rmtree(path, ignore_errors=True)
                continue
        return None, None, {}

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None
