"""Training cells: the stage-1 codebook step of `training/pruner.py`
(`make_pruner_step`, `pretrain` off, `make_optimizer`), on batches made on
the card from the seed.

Set-up builds one step object and drives it through its first
`reference_steps` steps, each on a batch of its own, through the same call
and feed the window uses; the window then steps until `--seconds` have
passed, each step ending in a synchronise. What the comparison needs of the
program is copied to the host at set-up: the trainables before the first
step, the optimizer's first moments after it (the first gradient as the
optimizer got it: exp_avg / (1 − β1)), each step's loss, and the trainables
after the last of those steps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from portbench.harness import family, program, traffic
from portbench.harness import weights as W


@dataclasses.dataclass
class StepRecord:
    start: float
    end: float
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    host_syncs: int = 0   # the program's host syncs in the step (`step.host_syncs`)


@dataclasses.dataclass
class Run:
    """What a training run did."""
    batch: int
    seconds: float
    steps: List[StepRecord] = dataclasses.field(default_factory=list)
    skipped: int = 0
    elapsed: float = 0.0
    setup_end: float = 0.0            # perf_counter at the window's start
    traced: Optional[tuple] = None    # (first step, last step, seconds) of the profiled slice
    program: list = dataclasses.field(default_factory=list)   # the program's spans, traced
    # the program's readings for the comparison (host copies)
    losses: List[float] = dataclasses.field(default_factory=list)
    params0: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    first_grad: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    params_after: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def gumbel(shape, gen) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


@torch.no_grad()
def batch_and_draws(config: dict, mix: dict, seed: int, index: int, device):
    """Step `index`'s batch (pixels in [-1, 1], CLIP ids, MPNet features)
    and every draw of the step (VAE sample noise, diffusion noise,
    timesteps, the router's three gumbel draws), from the seed on the
    device."""
    tc = config["training"]
    b, res = tc["train_batch_size"], config["serving"]["resolution"]
    ref = family.reference(config)
    spec = ref.unet_spec(config)
    layout = ref.gate_layout(spec)
    side = spec.sample_size
    gen = torch.Generator(device=device).manual_seed(W.module_seed(seed, f"batch.{index}"))
    ids, _, _ = traffic.prompts(mix, W.module_seed(seed, f"ids.{index}"), b, device)
    batch = {"pixel_values": torch.rand((b, res, res, 3), generator=gen, device=device) * 2 - 1,
             "input_ids": ids,
             "mpnet_embeddings": torch.randn((b, config["router"]["hypernet_input_dim"]),
                                             generator=gen, device=device)}
    lat = (b, side, side, spec.in_channels)
    k = config["router"]["num_experts"]
    draws = {"vae_eps": torch.randn(lat, generator=gen, device=device),
             "noise": torch.randn(lat, generator=gen, device=device),
             "timesteps": torch.randint(0, config["scheduler"]["num_train_timesteps"], (b,),
                                        generator=gen, device=device),
             "gumbel": gumbel((b, layout.vq_dim), gen),
             "codebook_gumbel": gumbel((k, layout.vq_dim), gen),
             "gates_gumbel": gumbel((b, layout.vq_dim), gen)}
    return batch, draws


def pruner_config(config: dict):
    from diffusion_pruning_tpu_torch.training.pruner import PrunerConfig
    tc = config["training"]
    w = tc["loss_weights"]
    return PrunerConfig(diffusion_weight=w["diffusion"], resource_weight=w["resource"],
                        contrastive_weight=w["contrastive"], distillation_weight=w["distillation"],
                        block_weight=w["block"], std_weight=w["std"], max_weight=w["max"],
                        snr_gamma=tc["snr_gamma"], pruning_target=tc["pruning_target"],
                        hypernet_lr=tc["hypernet_learning_rate"],
                        quantizer_lr=tc["quantizer_learning_rate"], adam_b1=tc["adam_beta1"],
                        adam_b2=tc["adam_beta2"], adam_eps=tc["adam_epsilon"],
                        lr_warmup_steps=tc["lr_warmup_steps"], scale_lr=True)


def trainables(mods) -> Dict[str, torch.nn.Parameter]:
    out = {f"hypernet.{n}": p for n, p in mods.hypernet.named_parameters()}
    out["quantizer.embedding.weight"] = mods.quantizer.embedding.weight
    return out


class Trainer:
    """The program's step object and what drives it."""

    STAGES = ("encode", "router", "teacher", "student", "losses", "backward", "optimizer")

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from diffusion_pruning_tpu_torch.training.pruner import (
            PrunerModules, make_optimizer, make_pruner_step)
        _, unet, clip, vae = family.program(config).frozen_models(config, seed, device)
        hypernet, quantizer = program.router_modules(config, unet.spec, seed, device)
        self.mods = PrunerModules(unet=unet, vae=vae, text_encoder=clip, hypernet=hypernet,
                                  quantizer=quantizer, schedule=program.schedule(config))
        cfg = pruner_config(config)
        self.optimizer = make_optimizer(cfg, self.mods, config["training"]["train_batch_size"])
        self.step_fn = make_pruner_step(self.mods, cfg, self.optimizer, pretrain=False)
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.index = 0
        self.events: Optional[Dict[str, torch.cuda.Event]] = None
        self.span = lambda name: contextlib.nullcontext()   # the tracer's, while traced

    def _mark(self, name: str) -> None:
        if self.events is not None:
            self.events[name].record()

    def step(self, record_stages: bool = False):
        """One step on the next batch, ended by a synchronise: (metrics,
        stage milliseconds or {})."""
        with self.span("draws"):
            batch, draws = batch_and_draws(self.config, self.mix, self.seed, self.index,
                                           self.device)
        self.index += 1
        cuda = self.device.type == "cuda"
        if record_stages and cuda:
            self.events = {n: torch.cuda.Event(enable_timing=True)
                           for n in ("start",) + self.STAGES}
            self.events["start"].record()
        with self.span("step"):
            metrics, _ = self.step_fn(batch, draws, mark=self._mark)
        if cuda:
            with self.span("synchronise"):
                torch.cuda.synchronize(self.device)
        stages = {}
        if self.events is not None:
            names = ("start",) + self.STAGES
            stages = {b: self.events[a].elapsed_time(self.events[b])
                      for a, b in zip(names, names[1:])}
            self.events = None
        return metrics, stages


def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def run(config: dict, mix: dict, seed: int, seconds: float, device, tracer=None,
        log=lambda msg: None):
    """Set-up with the first steps, then the window."""
    family.stage1(config)   # a family without a stage-1 reference stops here
    t_start = time.perf_counter()
    tr = Trainer(config, mix, seed, device)
    t_models = time.perf_counter()
    r = Run(config["training"]["train_batch_size"], seconds)
    params = trainables(tr.mods)
    r.params0 = host(params)
    b1 = config["training"]["adam_beta1"]
    for i in range(int(mix["reference_steps"])):
        metrics, _ = tr.step()
        r.losses.append(float(metrics["loss"]))
        r.skipped += int(bool(metrics["skipped"]))
        if i == 0:
            r.first_grad = {n: tr.optimizer.state[p]["exp_avg"].detach().float().cpu() / (1 - b1)
                            if p in tr.optimizer.state else torch.zeros(p.shape)
                            for n, p in params.items()}
    r.params_after = host(params)
    t_steps = time.perf_counter()
    if tracer is not None:
        tracer.warm(device)
        tr.span = tracer.span
    log(f"set-up: models from the seed {t_models - t_start:.1f} s, {mix['reference_steps']} "
        f"steps {t_steps - t_models:.1f} s")

    t_origin = r.setup_end = time.perf_counter()
    traced = tracer is not None
    if traced:
        tracer.open_window()
    while True:
        t0 = time.perf_counter() - t_origin
        if t0 >= seconds:
            break
        if traced:
            tracer.begin(len(r.steps), t0, device)
        syncs = tr.step_fn.host_syncs
        metrics, stages = tr.step(record_stages=traced)
        r.skipped += int(bool(metrics["skipped"]))
        r.steps.append(StepRecord(t0, time.perf_counter() - t_origin, stages,
                                  tr.step_fn.host_syncs - syncs))
    r.elapsed = r.steps[-1].end if r.steps else seconds
    if traced:
        tracer.finish(r, len(r.steps) - 1, device)
        r.program = tracer.program
    del tr
    return r


def gaps(got: dict, want: dict, stage1) -> dict:
    """The numbers compared between two runs of the first steps (`got` the
    one judged, `want` the reference): the largest relative gap of a step's
    loss; the first gradient's norm and the trainables' change, each by the
    worst leaf (`leaf_gaps` of `stage1`, the stage-1 reference). A leaf
    whose reference gradient is under a thousandth of the median leaf's is
    left out of the change: it moves by round-off alone."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    g_got = {n: float(torch.linalg.vector_norm(g)) for n, g in got["first_grad"].items()}
    g_want = {n: float(torch.linalg.vector_norm(g)) for n, g in want["first_grad"].items()}
    median = float(torch.tensor(list(g_want.values())).median())
    moved = [n for n in g_want if g_want[n] >= 1e-3 * median]

    def change(run, n):
        return float(torch.linalg.vector_norm(run["params_after"][n] - run["params0"][n]))

    grad = stage1.leaf_gaps(g_got, g_want)
    moves = stage1.leaf_gaps({n: change(got, n) for n in moved},
                             {n: change(want, n) for n in moved}, moved)
    worst_g, worst_c = max(grad, key=grad.get), max(moves, key=moves.get)
    return {"loss_gap": loss, "first_grad_norm_gap": grad[worst_g],
            "change_norm_gap": moves[worst_c], "_worst": [worst_g, worst_c],
            "_left_out": sorted(set(g_want) - set(moved))}


def train_checks(r: Run, config: dict, seed: int, device, limits: dict, control: bool = False,
                 mix: Optional[dict] = None) -> Dict[str, dict]:
    """The numbers compared (`gaps` of the program against the reference)
    and the steps skipped; `control` adds the gaps against the reference of
    the precision control (`_control`) and of the reference with half of
    each batch left out (`_fault_half_batch`)."""
    rt = family.stage1(config)
    want = reference_run(config, mix, seed, device, len(r.losses))
    mine = {"losses": r.losses, "first_grad": r.first_grad, "params0": r.params0,
            "params_after": r.params_after}
    g = gaps(mine, want, rt)
    checks = {"skipped_steps": {"value": r.skipped, "limit": 0}}
    for k in ("loss_gap", "first_grad_norm_gap", "change_norm_gap"):
        checks[k] = {"value": g[k], "limit": limits[k]}
    checks["_detail"] = {"losses": r.losses, "reference_losses": want["losses"],
                         "worst_leaves": g["_worst"], "left_out": g["_left_out"]}
    if control:
        for key, kw in (("_control", {"control": True}), ("_fault_half_batch",
                                                         {"fault": half_batch})):
            c = gaps(reference_run(config, mix, seed, device, len(r.losses), **kw), want, rt)
            checks[key] = {k: v for k, v in c.items() if not k.startswith("_")}
    return checks


def half_batch(batch: dict, draws: dict):
    """The fault of a step that takes the first half of its batch and the
    mean over those rows alone."""
    b = batch["input_ids"].shape[0] // 2
    return ({k: v[:b] for k, v in batch.items()},
            {k: v if k == "codebook_gumbel" else v[:b] for k, v in draws.items()})


def reference_run(config: dict, mix: dict, seed: int, device, steps: int,
                  control: bool = False, fault=None) -> dict:
    """The reference's first `steps` steps from the seed on the same
    batches: losses, the first gradient, the trainables before and after.
    `fault(batch, draws)`: a fault planted in the reference put in the
    program's place."""
    from portbench.harness.check import reference_modules
    ref, rt = family.reference(config), family.stage1(config)
    modules = reference_modules(config, seed, device, control)
    layout, rc = ref.gate_layout(ref.unet_spec(config)), config["router"]
    hyper, book = [], []
    for ctor, tag, out in ((lambda: rt.Hypernet(layout, rc["hypernet_input_dim"]), "hypernet",
                            hyper),
                           (lambda: rt.Codebook(rc["num_experts"], layout.vq_dim), "quantizer",
                            book)):
        with torch.device("meta"):
            m = ctor()
        m = m.to_empty(device=device)
        out.append(W.seeded_init_(m, W.module_seed(seed, tag), device))
    st = rt.Stage1.build(modules, hyper[0], book[0], config, device)
    params = st.params()
    out = {"params0": host(params), "losses": []}
    with ref.float32_matmuls():
        for i in range(steps):
            batch, draws = batch_and_draws(config, mix, seed, i, device)
            if fault is not None:
                batch, draws = fault(batch, draws)
            loss, grads = st.step(batch, draws)
            out["losses"].append(loss)
            if i == 0:
                out["first_grad"] = host(grads)
    out["params_after"] = host(params)
    return out
