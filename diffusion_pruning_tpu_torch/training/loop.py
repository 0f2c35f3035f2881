"""Stage 1's training loop around the step (`training/pruner.py`).

The lifecycle of the JAX package's `training/loop.PrunerLoop`: epochs over
the batches, the switch from the hypernet's own gates to the codebook at
`hypernet_pretraining_steps`, the count of skipped (non-finite) steps,
scalar logging every `log_every` steps (with steps/s and the expert-usage
histogram), validation every `validation_steps`, codebook and resource
heatmaps every `image_logging_steps`, checkpoints every `checkpoint_steps`
(or at each epoch's end) and at the end, rotation, resume ("latest" or a
step number), an optional EMA of the trainables, and the diffusers-style
export beside each checkpoint (`hypernet/`, `quantizer/`, and `unet/` when
`export_unet_ref` holds the U-Net).

Randomness: the steps draw from one `torch.Generator` seeded with `seed`.
It is not saved, and on resume the batches restart from the first one, as
in the JAX loop (whose PRNG key restarts from its seed). A checkpoint that
would repeat the one just written at the same step (the epoch's end is the
run's end) is not written twice.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager
from diffusion_pruning_tpu_torch.utils.export import export_pruning_checkpoint
from diffusion_pruning_tpu_torch.utils.logging_utils import Tracker, heatmap_image

logger = logging.getLogger("diffusion_pruning_tpu_torch")

BATCH_KEYS = ("pixel_values", "input_ids", "mpnet_embeddings", "latent_mean", "latent_logvar")


@dataclasses.dataclass
class LoopConfig:
    max_train_steps: int = 5000
    hypernet_pretraining_steps: int = 500
    validation_steps: int = 1000
    image_logging_steps: int = 1000
    checkpoint_steps: Optional[int] = None   # None = at each epoch's end
    checkpoints_total_limit: int = 1
    log_every: int = 10
    resume_from: Optional[str] = None        # 'latest' or a step number


class PrunerLoop:
    """mods: `PrunerModules` on one device; make_step(mods, cfg, optimizer,
    pretrain=...) and make_val(mods, cfg) build the step and the validation
    step (`make_pruner_step`, `make_validation_step`, or partials of them)."""

    def __init__(self, mods, cfg, loop_cfg: LoopConfig, optimizer: torch.optim.Optimizer,
                 make_step: Callable, make_val: Callable, run_dir: str,
                 tracker: Optional[Tracker] = None, seed: int = 43,
                 ema_decay: Optional[float] = None):
        self.mods, self.cfg, self.loop_cfg = mods, cfg, loop_cfg
        self.optimizer = optimizer
        self.device = mods.quantizer.embedding.weight.device
        self.step_fns = {pretrain: make_step(mods, cfg, optimizer, pretrain=pretrain)
                         for pretrain in (True, False)}
        self.val_fn = make_val(mods, cfg)
        self.ckpt = CheckpointManager(run_dir, loop_cfg.checkpoints_total_limit)
        self.tracker = tracker or Tracker(run_dir)
        self.run_dir = run_dir
        self.export_unet_ref = None  # the U-Net, to also export unet/
        self.global_step = 0
        self.skipped_steps = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._saved_step: Optional[int] = None
        # EMA of the trainables (hypernet and codebook): a few MB
        self.ema_decay = ema_decay
        self.ema = ({name: p.detach().clone() for name, p in self.trainables()}
                    if ema_decay else None)

    def trainables(self):
        """(name, parameter) of everything the step trains."""
        return ([(f"hypernet.{n}", p) for n, p in self.mods.hypernet.named_parameters()]
                + [("quantizer.embedding.weight", self.mods.quantizer.embedding.weight)])

    # ------------------------------------------------------------------

    def log_heatmaps(self, aux):
        """The binarised codebook's pairwise cosine similarity and the batch's
        resource ratios, as PNGs under heatmaps/ (and to wandb when live)."""
        from PIL import Image
        out = os.path.join(self.run_dir, "heatmaps")
        os.makedirs(out, exist_ok=True)
        codes = (self.mods.quantizer.embedding_gs.detach().cpu().numpy() >= 0.5)
        codes = codes.astype(np.float32)
        codes = codes / (np.linalg.norm(codes, axis=1, keepdims=True) + 1e-9)
        sim = heatmap_image(codes @ codes.T)
        Image.fromarray(sim).save(os.path.join(out, f"codebook_sim_{self.global_step}.png"))
        ratios = heatmap_image(aux["batch_resource_ratios"].float().cpu().numpy().reshape(-1, 1))
        Image.fromarray(ratios).save(
            os.path.join(out, f"batch_resource_ratios_{self.global_step}.png"))
        self.tracker.log_images({"codebook_similarity": sim, "batch_resource_ratios": ratios},
                                self.global_step)

    def state_dict(self) -> Dict:
        state = {"hypernet": self.mods.hypernet.state_dict(),
                 "quantizer": self.mods.quantizer.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "step": self.global_step, "skipped_steps": self.skipped_steps}
        if self.ema is not None:
            state["ema"] = self.ema
        return state

    def save_checkpoint(self):
        artifacts = {
            # the snapshot of the last step's training noise itself: the
            # tensor eval routing and expert materialisation use
            "quantizer_embeddings.pt": self.mods.quantizer.embedding_gs,
        }
        path = self.ckpt.save(self.global_step, self.state_dict(), artifacts)
        export_pruning_checkpoint(path, self.mods.hypernet, self.mods.quantizer,
                                  unet=self.export_unet_ref)
        self._saved_step = self.global_step
        logger.info("saved checkpoint %s", path)

    def maybe_resume(self):
        if self.loop_cfg.resume_from is None:
            return
        step = None if self.loop_cfg.resume_from == "latest" else int(self.loop_cfg.resume_from)
        state = self.ckpt.restore(step)
        self.mods.hypernet.load_state_dict(state["hypernet"])
        self.mods.quantizer.load_state_dict(state["quantizer"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for name, t in state["ema"].items():
                self.ema[name].copy_(t)
        self.global_step = int(state["step"])
        self.skipped_steps = int(state["skipped_steps"])
        self._saved_step = self.global_step
        logger.info("resumed from step %d", self.global_step)

    def _place(self, batch):
        out = {}
        for k, v in batch.items():
            if k in BATCH_KEYS:
                t = torch.as_tensor(v)
                out[k] = (t.long() if k == "input_ids" else t.float()).to(self.device)
        return out

    @torch.no_grad()
    def _update_ema(self):
        d = self.ema_decay
        for name, p in self.trainables():
            e = self.ema[name]
            e.copy_(e * d + p.detach().to(e.dtype) * (1.0 - d))

    # ------------------------------------------------------------------

    def train(self, train_batches: Callable[[int], Iterable[Dict[str, np.ndarray]]],
              val_batches: Optional[Callable[[], Iterable]] = None):
        """train_batches(epoch) yields host batches (numpy arrays or tensors;
        the keys the step reads go to the modules' device)."""
        lc = self.loop_cfg
        self.maybe_resume()
        epoch = 0
        t_last = time.perf_counter()
        while self.global_step < lc.max_train_steps:
            for batch in train_batches(epoch):
                if self.global_step >= lc.max_train_steps:
                    break
                pretrain = self.global_step < lc.hypernet_pretraining_steps
                metrics, aux = self.step_fns[pretrain](self._place(batch),
                                                       generator=self.generator)
                self.skipped_steps += int(metrics["skipped"])
                if self.ema is not None:
                    self._update_ema()
                self.global_step += 1

                if self.global_step % lc.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["skipped_steps"] = self.skipped_steps
                    now = time.perf_counter()
                    m["steps_per_sec"] = lc.log_every / (now - t_last)
                    t_last = now
                    counts = torch.bincount(aux["expert_indices"].cpu(),
                                            minlength=self.mods.quantizer.n_e).tolist()
                    for e, c in enumerate(counts):
                        m[f"expert_usage/{e}"] = int(c)
                    self.tracker.log(m, self.global_step)
                    logger.info("step %d loss %.4f ratio %.3f experts %s (%.2f it/s)",
                                self.global_step, m["loss"], m["resource_ratio"], counts,
                                m["steps_per_sec"])

                if val_batches is not None and self.global_step % lc.validation_steps == 0:
                    self.validate(val_batches)
                if lc.image_logging_steps and self.global_step % lc.image_logging_steps == 0:
                    self.log_heatmaps(aux)
                if lc.checkpoint_steps and self.global_step % lc.checkpoint_steps == 0:
                    self.save_checkpoint()
            epoch += 1
            if not lc.checkpoint_steps:
                self.save_checkpoint()
        if self._saved_step != self.global_step:
            self.save_checkpoint()

    def validate(self, val_batches):
        agg: Dict[str, list] = {}
        for batch in val_batches():
            for k, v in self.val_fn(self._place(batch), generator=self.generator).items():
                agg.setdefault(k, []).append(float(v))
        means = {f"val_{k}": float(np.mean(v)) for k, v in agg.items()}
        self.tracker.log(means, self.global_step)
        logger.info("validation @%d: %s", self.global_step,
                    {k: round(v, 4) for k, v in means.items()})
        return means
