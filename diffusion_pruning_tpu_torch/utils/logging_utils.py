"""Run-directory layout and metrics tracking.

`make_run_dir` derives the run directory from the config file's name and the
run name; `Tracker` appends scalars to `metrics.jsonl` and passes them (and
images) on to wandb when it is asked to and the package is installed (it
warns and keeps JSONL only otherwise). Images are uint8 (H, W, 3) arrays:
`heatmap_image` renders a matrix, `image_grid` tiles a batch (the JAX
package's return the same pixels as PIL images).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("diffusion_pruning_tpu_torch")


def init_logging(run_dir: str, level=logging.INFO) -> None:
    os.makedirs(run_dir, exist_ok=True)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(run_dir, "train.log"))],
        force=True,
    )


def make_run_dir(logging_dir: str, config_path: str, run_name: Optional[str]) -> str:
    base = os.path.splitext(os.path.basename(config_path))[0]
    name = run_name or f"{base}-{time.strftime('%Y%m%d-%H%M%S')}"
    run_dir = os.path.join(logging_dir, base, name)
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


class Tracker:
    """JSONL scalar tracker with optional wandb passthrough."""

    def __init__(self, run_dir: str, project: str = "diffusion-pruning-tpu",
                 run_name: Optional[str] = None, use_wandb: bool = False):
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name, dir=run_dir)
            except Exception as e:  # wandb not installed / offline
                logger.warning("wandb unavailable (%s); JSONL tracking only", e)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        clean = {k: float(v) for k, v in metrics.items()
                 if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        self._fh.write(json.dumps({"step": step, **clean}) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def log_images(self, images: Dict[str, np.ndarray], step: int) -> None:
        """Log named uint8 images to wandb when it is live; the PNG copies in
        the run directory are the callers'."""
        if self._wandb is None:
            return
        import wandb
        self._wandb.log({k: wandb.Image(v) for k, v in images.items()}, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def heatmap_image(matrix: np.ndarray, scale: int = 8) -> np.ndarray:
    """A matrix as a uint8 RGB heatmap (dark blue → teal → yellow), each
    entry a scale × scale block."""
    m = np.asarray(matrix, dtype=np.float64)
    lo, hi = m.min(), m.max()
    norm = (m - lo) / (hi - lo + 1e-12)
    stops = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]], dtype=np.float64)
    t = norm * 2
    c0 = np.clip(1 - t, 0, 1)[..., None] * stops[0]
    c1 = (1 - np.abs(t - 1)).clip(0, 1)[..., None] * stops[1]
    c2 = np.clip(t - 1, 0, 1)[..., None] * stops[2]
    rgb = np.clip(c0 + c1 + c2, 0, 255).astype(np.uint8)
    return rgb.repeat(scale, axis=0).repeat(scale, axis=1)


def image_grid(images: np.ndarray, cols: int = 4) -> np.ndarray:
    """uint8 or float [0, 1] NHWC images → one uint8 grid, row-major."""
    arr = np.asarray(images)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    n, h, w, c = arr.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, co = divmod(i, cols)
        grid[r * h:(r + 1) * h, co * w:(co + 1) * w] = arr[i]
    return grid

