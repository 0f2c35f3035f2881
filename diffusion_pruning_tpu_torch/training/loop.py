"""The training loops around the steps: stage 1's `PrunerLoop`
(`training/pruner.py`) and stage 2's `FineTuneLoop` (`training/finetuner.py`).

The lifecycle of the JAX package's `training/loop.PrunerLoop`: epochs over
the batches, the switch from the hypernet's own gates to the codebook at
`hypernet_pretraining_steps`, the count of skipped (non-finite) steps,
scalar logging every `log_every` steps (with steps/s and the expert-usage
histogram), validation every `validation_steps`, codebook and resource
heatmaps every `image_logging_steps` (then `image_logger(loop)` when set:
the entry point's sample images), checkpoints every `checkpoint_steps`
(or at each epoch's end) and at the end, rotation, resume ("latest" or a
step number), an optional EMA of the trainables, and the diffusers-style
export beside each checkpoint (`hypernet/`, `quantizer/`, and `unet/` when
`export_unet_ref` holds the U-Net).

Randomness: the steps draw from one `torch.Generator` seeded with `seed`.
It is not saved, and on resume the batches restart from the first one, as
in the JAX loop (whose PRNG key restarts from its seed). A checkpoint that
would repeat the one just written at the same step (the epoch's end is the
run's end) is not written twice.

`FineTuneLoop` is the JAX package's stage-2 loop: the steps, an optional EMA
of the student's f32 weights, scalar logging, validation when given batches,
checkpoints (the student's f32 masters, the optimizer, the EMA) with
`arch_vector.pt` beside each, rotation and resume.

Data parallel (`mesh`, a `parallel.mesh.DataMesh`): each rank runs the loop
on its rows of each global batch (the batches it is given are those rows)
with the mesh's step. Rank 0 alone writes: checkpoints and exports, tracker
lines, heatmaps and the image logger's samples; every rank waits at a
barrier after each save, and every rank resumes from the same checkpoint.
The `torch.Generator(seed)` stays the stream every rank shares (the
codebook's gumbel noise); a second generator, seeded from (seed, rank)
(`utils/launch.rank_seed`), gives each rank its own draws. A ZeRO-1
optimizer's checkpoint holds its moments gathered from every rank
(`training/finetuner.Zero1AdamW`).

Tensor parallel (`FineTuneLoop` with a `parallel.tp.DpTpMesh` and the
student's `shard`): the steps draw from the one generator every rank seeds
alike (the 2-D step cuts the global batch's draws to the rank's rows); a
checkpoint's masters, AdamW moments and EMA are gathered to full tensors
(a collective) and rank 0 writes them, with the keys and shapes of a
one-process run's, and a resume cuts them to the rank's shard again.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from diffusion_pruning_tpu_torch.parallel.mesh import DataMesh, barrier
from diffusion_pruning_tpu_torch.parallel.tp import DpTpMesh, gather_state, shard_params
from diffusion_pruning_tpu_torch.utils.checkpoint import CheckpointManager
from diffusion_pruning_tpu_torch.utils.export import export_pruning_checkpoint
from diffusion_pruning_tpu_torch.utils.launch import rank_seed
from diffusion_pruning_tpu_torch.utils.logging_utils import NullTracker, Tracker, heatmap_image

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


class _Loop:
    """What both loops share: the batches' placement on the loop's device,
    the generators, the rank that writes, and validation. Subclasses call
    `_setup` and set `batch_keys`, `device`, `val_fn` and `global_step`."""
    batch_keys = BATCH_KEYS
    shares_codebook_noise = False  # whether the step takes `shared_generator`

    def _setup(self, mesh: Optional[DataMesh], run_dir: str, loop_cfg: LoopConfig,
               tracker: Optional[Tracker], seed: int) -> None:
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.ckpt = CheckpointManager(run_dir, loop_cfg.checkpoints_total_limit,
                                      create=self.is_main)
        self.tracker = tracker or (Tracker(run_dir) if self.is_main else NullTracker())
        self.run_dir = run_dir
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.rank_generator = (None if mesh is None else torch.Generator(
            device=self.device).manual_seed(rank_seed(seed, mesh.rank)))

    def draw_kwargs(self) -> Dict[str, torch.Generator]:
        """The generators a step or validation call takes: the one stream on
        one process; under a mesh the rank's stream, and the shared one for
        the codebook noise where the step draws it; under a `DpTpMesh` the
        one stream (the 2-D step cuts the global draws)."""
        if self.mesh is None or isinstance(self.mesh, DpTpMesh):
            return {"generator": self.generator}
        out = {"generator": self.rank_generator}
        if self.shares_codebook_noise:
            out["shared_generator"] = self.generator
        return out

    def _write_checkpoint(self, state, artifacts, export=None):
        """Rank 0 writes `state` and the artifacts (and calls export(path));
        every rank then waits for it."""
        path = self.ckpt.dir_for(self.global_step)
        if self.is_main:
            path = self.ckpt.save(self.global_step, state, artifacts)
            if export is not None:
                export(path)
        barrier(self.mesh)
        self._saved_step = self.global_step
        logger.info("saved checkpoint %s", path)

    def _place(self, batch):
        out = {}
        for k, v in batch.items():
            if k in self.batch_keys:
                t = torch.as_tensor(v)
                out[k] = (t.long() if k == "input_ids" else t.float()).to(self.device)
        return out

    def validate(self, val_batches):
        agg: Dict[str, list] = {}
        for batch in val_batches():
            for k, v in self.val_fn(self._place(batch), **self.draw_kwargs()).items():
                agg.setdefault(k, []).append(float(v))
        means = {f"val_{k}": float(np.mean(v)) for k, v in agg.items()}
        self.tracker.log(means, self.global_step)
        logger.info("validation @%d: %s", self.global_step,
                    {k: round(v, 4) for k, v in means.items()})
        return means


class PrunerLoop(_Loop):
    """mods: `PrunerModules` on one device; make_step(mods, cfg, optimizer,
    pretrain=...) and make_val(mods, cfg) build the step and the validation
    step (`make_pruner_step`, `make_validation_step`, or partials of them),
    each also given `mesh=` when the loop has one."""
    shares_codebook_noise = True

    def __init__(self, mods, cfg, loop_cfg: LoopConfig, optimizer: torch.optim.Optimizer,
                 make_step: Callable, make_val: Callable, run_dir: str,
                 tracker: Optional[Tracker] = None, seed: int = 43,
                 ema_decay: Optional[float] = None, mesh: Optional[DataMesh] = None):
        self.mods, self.cfg, self.loop_cfg = mods, cfg, loop_cfg
        self.optimizer = optimizer
        self.device = mods.quantizer.embedding.weight.device
        on_mesh = {} if mesh is None else {"mesh": mesh}
        self.step_fns = {pretrain: make_step(mods, cfg, optimizer, pretrain=pretrain, **on_mesh)
                         for pretrain in (True, False)}
        self.val_fn = make_val(mods, cfg, **on_mesh)
        self._setup(mesh, run_dir, loop_cfg, tracker, seed)
        self.export_unet_ref = None  # the U-Net, to also export unet/
        self.image_logger: Optional[Callable] = None  # image_logger(loop), after the heatmaps
        self.global_step = 0
        self.skipped_steps = 0
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
        self._write_checkpoint(self.state_dict(), artifacts, lambda path: export_pruning_checkpoint(
            path, self.mods.hypernet, self.mods.quantizer, unet=self.export_unet_ref))

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
                metrics, aux = self.step_fns[pretrain](self._place(batch), **self.draw_kwargs())
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
                if (lc.image_logging_steps and self.global_step % lc.image_logging_steps == 0
                        and self.is_main):
                    self.log_heatmaps(aux)
                    if self.image_logger is not None:
                        self.image_logger(self)
                if lc.checkpoint_steps and self.global_step % lc.checkpoint_steps == 0:
                    self.save_checkpoint()
            epoch += 1
            if not lc.checkpoint_steps:
                self.save_checkpoint()
        if self._saved_step != self.global_step:
            self.save_checkpoint()


class FineTuneLoop(_Loop):
    """Stage 2's loop (an expert's or a baseline's fine-tuning) on one device.

    step_fn(batch, generator=...) is `make_finetune_step`'s step and val_fn
    (or None) `make_finetune_validation_step`'s; `optimizer` the step's
    `AdamW`, whose masters are the student's weights. The student must own
    its storage (`FineTunerModules` checks it), which stands for the JAX
    loop's copy of the student's parameters. A checkpoint's state holds the
    masters by state-dict name (`student`, f32), the optimizer, the step
    count, the skipped steps and the EMA; `arch_vector.pt` is written beside
    it when the loop has one. A resumed run with `ema_decay` whose checkpoint
    has no EMA starts the EMA from the restored weights. With a `mesh` the
    steps are the mesh's (`make_finetune_step(..., mesh=mesh)`); with a
    `DpTpMesh` and `shard`, the student's `parallel.tp.UNetShard`, the 2-D
    step's (`make_finetune_step_gspmd`), and checkpoints hold full tensors
    (module docstring)."""
    batch_keys = ("pixel_values", "input_ids", "latent_mean", "latent_logvar")

    def __init__(self, step_fn: Callable, val_fn: Optional[Callable], optimizer,
                 loop_cfg: LoopConfig, run_dir: str, arch_vector=None,
                 tracker: Optional[Tracker] = None, seed: int = 43,
                 ema_decay: Optional[float] = None, mesh: Optional[DataMesh] = None,
                 shard=None):
        if (shard is None) != (not isinstance(mesh, DpTpMesh)):
            raise ValueError("a tensor-parallel loop takes a DpTpMesh and the student's shard")
        self.step_fn, self.val_fn = step_fn, val_fn
        self.shard = shard
        self.optimizer = optimizer
        self.masters = optimizer.masters
        self.loop_cfg = loop_cfg
        self.arch_vector = arch_vector
        self.device = self.masters.masters[0].device
        self._setup(mesh, run_dir, loop_cfg, tracker, seed)
        self.global_step = 0
        self.skipped_steps = 0
        self._saved_step: Optional[int] = None
        self.ema_decay = ema_decay
        self.ema = self._fresh_ema() if ema_decay else None

    def _fresh_ema(self) -> Dict[str, torch.Tensor]:
        return {n: m.detach().clone() for n, m in self.masters.state_dict().items()}

    def _full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors by the student's names, whole (gathered under tensor
        parallelism, a collective)."""
        if self.shard is None:
            return tensors
        return gather_state(self.shard.axis, tensors, self.shard.plan)

    def _mine(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by the student's names cut to this rank's shard."""
        if self.shard is None:
            return tensors
        axis = self.shard.axis
        return shard_params(tensors, axis.rank, axis.world_size, self.shard.plan)

    def _optimizer_state(self, state: Dict, convert) -> Dict:
        """An optimizer state dict with each parameter's AdamW moments passed
        through convert({name: tensor})."""
        names = self.masters.names
        out = dict(state, state={i: dict(s) for i, s in state["state"].items()})
        for key in ("mu", "nu"):
            moments = convert({names[i]: s[key] for i, s in out["state"].items()})
            for i, s in out["state"].items():
                s[key] = moments[names[i]]
        return out

    def state_dict(self) -> Dict:
        optimizer = self.optimizer.state_dict()
        if self.shard is not None:
            optimizer = self._optimizer_state(optimizer, self._full)
        state = {"student": self._full(self.masters.state_dict()), "optimizer": optimizer,
                 "step": self.global_step, "skipped_steps": self.skipped_steps}
        if self.ema is not None:
            state["ema"] = self._full(self.ema)
        return state

    def save_checkpoint(self):
        artifacts = {}
        if self.arch_vector is not None:  # beside every checkpoint, as the original code
            artifacts["arch_vector.pt"] = np.asarray(self.arch_vector)
        self._write_checkpoint(self.state_dict(), artifacts)

    def maybe_resume(self):
        if self.loop_cfg.resume_from is None:
            return
        step = None if self.loop_cfg.resume_from == "latest" else int(self.loop_cfg.resume_from)
        state = self.ckpt.restore(step)
        self.masters.load_state_dict(self._mine(state["student"]))
        optimizer = state["optimizer"]
        if self.shard is not None:
            optimizer = self._optimizer_state(optimizer, self._mine)
        self.optimizer.load_state_dict(optimizer)
        if self.ema is not None:
            if "ema" in state:
                for name, t in self._mine(state["ema"]).items():
                    self.ema[name].copy_(t)
            else:
                logger.info("the checkpoint has no EMA: it starts from the restored weights")
                self.ema = self._fresh_ema()
        self.global_step = int(state["step"])
        self.skipped_steps = int(state["skipped_steps"])
        self._saved_step = self.global_step
        logger.info("resumed from step %d", self.global_step)

    @torch.no_grad()
    def _update_ema(self):
        d = self.ema_decay
        ema = list(self.ema.values())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            [m.detach() for m in self.masters.masters], 1.0 - d))

    def train(self, train_batches: Callable[[int], Iterable[Dict[str, np.ndarray]]],
              val_batches: Optional[Callable[[], Iterable]] = None):
        """train_batches(epoch) yields host batches (numpy arrays or tensors)."""
        lc = self.loop_cfg
        self.maybe_resume()
        epoch = 0
        t_last = time.perf_counter()
        while self.global_step < lc.max_train_steps:
            for batch in train_batches(epoch):
                if self.global_step >= lc.max_train_steps:
                    break
                metrics = self.step_fn(self._place(batch), **self.draw_kwargs())
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
                    self.tracker.log(m, self.global_step)
                    logger.info("step %d loss %.4f (%.2f it/s)", self.global_step, m["loss"],
                                m["steps_per_sec"])
                if (val_batches is not None and self.val_fn is not None
                        and self.global_step % lc.validation_steps == 0):
                    self.validate(val_batches)
                if lc.checkpoint_steps and self.global_step % lc.checkpoint_steps == 0:
                    self.save_checkpoint()
            epoch += 1
            if not lc.checkpoint_steps:
                self.save_checkpoint()
        if self._saved_step != self.global_step:
            self.save_checkpoint()
