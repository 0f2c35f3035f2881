"""Checkpoint and resume with the original APTP code's on-disk contract.

A run directory holds `checkpoint-{step}` subdirectories, rotated to the
newest `total_limit` and resumed from "latest" by step number (not by name:
checkpoint-1000 is newer than checkpoint-999). Each holds:

  state/state.pt            the resumable state, `torch.save` of a dict of
                            state dicts, tensors and numbers (what
                            `training/loop.PrunerLoop.state_dict` gives)
  quantizer_embeddings.pt   artifacts written beside it as plain tensors that
  arch_vector.pt, ...       `torch.load(weights_only=True)` reads (the
                            stage-2 and filtering tools' inputs)

plus the diffusers-style `hypernet/`, `quantizer/` and `unet/` folders that
`utils/export.py` writes.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
STATE_FILE = os.path.join("state", "state.pt")


def save_torch_artifact(obj, path: str) -> None:
    """A tensor (or numpy array) as a plain host tensor file."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().to("cpu").clone()
    torch.save(obj, path)


def load_torch_artifact(path: str):
    """An artifact file's tensor (or container), read with
    `weights_only=True`: no arbitrary unpickling."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _steps(root: str) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(root)) if m)


def latest_checkpoint_dir(root: str) -> Optional[str]:
    """The newest `checkpoint-{step}` under `root` by step number, or None."""
    steps = _steps(root)
    return os.path.join(root, f"checkpoint-{steps[-1]}") if steps else None


class CheckpointManager:
    """Step-indexed checkpoints with rotation and 'latest' resume."""

    def __init__(self, root: str, total_limit: Optional[int] = 1):
        self.root = root
        self.total_limit = total_limit
        os.makedirs(root, exist_ok=True)

    def list_steps(self) -> List[int]:
        return _steps(self.root)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint-{step}")

    def save(self, step: int, state: Dict[str, Any],
             artifacts: Optional[Dict[str, Any]] = None) -> str:
        """Write `state` under state/ and each artifact (name → tensor) beside
        it, then rotate. Returns the checkpoint's directory."""
        path = self.dir_for(step)
        os.makedirs(os.path.join(path, "state"), exist_ok=True)
        target = os.path.join(path, STATE_FILE)
        torch.save(state, target + ".tmp")
        os.replace(target + ".tmp", target)
        for name, obj in (artifacts or {}).items():
            save_torch_artifact(obj, os.path.join(path, name))
        self._rotate()
        return path

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The state saved at `step` (default: the latest), on the host."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return torch.load(os.path.join(self.dir_for(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def _rotate(self) -> None:
        if not self.total_limit:
            return
        steps = self.list_steps()
        while len(steps) > self.total_limit:
            shutil.rmtree(self.dir_for(steps.pop(0)), ignore_errors=True)
