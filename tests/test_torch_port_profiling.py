"""The port's span recorder (`utils/profiling.py`) and the spans and counters
the serving queue, the prepared-program dispatch and the stage-1 step
record, on the CPU with tiny random models. No JAX: the spans have no JAX
counterpart.

Recording off keeps nothing and leaves the step's results bit-equal;
spans nest by thread; `host_sync` counts a thread's syncs off the CPU;
a `ServingQueue` under concurrent `submit` and `flush_async` records each
submit's and each flush's spans on its own thread; the stage-1 step
records its stages in mark order and its host syncs (`step.host_syncs`)."""
import threading
import time

import numpy as np
import pytest
import torch

from diffusion_pruning_tpu_torch.core.structure import build_structure
from diffusion_pruning_tpu_torch.models.hypernet import HyperStructure
from diffusion_pruning_tpu_torch.models.quantizer import StructureQuantizer
from diffusion_pruning_tpu_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder
from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig
from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
from diffusion_pruning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_pruning_tpu_torch.pipelines import PruningPipeline
from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer, ServingQueue
from diffusion_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
from diffusion_pruning_tpu_torch.training.pruner import (
    PrunerConfig,
    PrunerModules,
    make_optimizer,
    make_pruner_step,
)
from diffusion_pruning_tpu_torch.utils import profiling
from diffusion_pruning_tpu_torch.utils.init_utils import random_init_

torch.set_num_threads(1)
K = 3
STEPS = 2
B = 4
STAGES = ["encode", "router", "teacher", "student", "losses", "backward", "optimizer"]


@pytest.fixture(autouse=True)
def no_recording_left():
    yield
    profiling.stop()


def _modules(seed=0):
    """Tiny random modules of the routed pipeline and the stage-1 step, whose
    codebook snapshot holds K distinct codes."""
    gen = torch.Generator().manual_seed(seed)
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    spec = unet.spec
    vae, text = AutoencoderKL(VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig.tiny())
    hypernet = HyperStructure(spec, input_dim=32)
    quantizer = StructureQuantizer(spec, n_e=K, base=0.0)
    for module in (unet, vae, text, hypernet):
        random_init_(module, gen)
    quantizer.init_params(gen)
    quantizer.init_state()
    codes = (np.random.default_rng(21).random((K, spec.vq_dim)) < 0.6).astype(np.float32)
    codes[:, spec.num_width:] = 1.0
    codes[1, spec.num_width::2] = 0.0
    with torch.no_grad():
        quantizer.embedding_gs.copy_(torch.from_numpy(np.where(codes >= 0.5, 0.8, 0.2)))
    return unet, vae, text, hypernet, quantizer


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


# ---------------------------------------------------------------- the recorder

def test_recording_off_keeps_nothing_and_shares_one_context():
    """Off, every span is the same no-op context and nothing is kept; a span
    opened before `start` is not recorded, one opened after it is, with its
    identifiers and a closed interval on the host's Unix clock."""
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b", device=True, ids={"rids": [1]})
    with profiling.span("off"):
        pass
    assert profiling.stop() == []
    before = profiling.span("opened before")
    profiling.start()
    assert profiling.recording()
    with before:
        with profiling.span("kept", ids={"tier": 2}) as s:
            with profiling.span("bare"):
                pass
    spans = profiling.stop()
    assert s is not before and not profiling.recording()
    assert [(x.name, x.parent, x.ids) for x in spans] == [("kept", None, {"tier": 2}),
                                                          ("bare", spans[0].id, {})]
    assert 0 < spans[0].start_ns <= spans[0].end_ns and spans[0].device_ms is None
    with profiling.span("after stop"):
        pass
    assert profiling.stop() == []


def test_spans_nest_by_thread():
    """Each span's parent is the innermost span open on its own thread, never
    one of another thread's, and each records its thread."""
    profiling.start()
    inner_started, outer_may_close = threading.Event(), threading.Event()

    def other():
        with profiling.span("other_outer"):
            with profiling.span("other_inner", ids={"k": 1}):
                inner_started.set()
                outer_may_close.wait()

    with profiling.span("main_outer"):
        t = threading.Thread(target=other)
        t.start()
        inner_started.wait()
        with profiling.span("main_inner"):
            with profiling.span("main_leaf"):
                pass
        outer_may_close.set()
        t.join()
    spans = {s.name: s for s in profiling.stop()}
    assert spans["main_outer"].parent is None and spans["other_outer"].parent is None
    assert spans["main_inner"].parent == spans["main_outer"].id
    assert spans["main_leaf"].parent == spans["main_inner"].id
    assert spans["other_inner"].parent == spans["other_outer"].id
    assert spans["other_inner"].ids == {"k": 1}
    main, worker = threading.get_ident(), t.ident
    assert {n: s.thread for n, s in spans.items()} == {
        "main_outer": main, "main_inner": main, "main_leaf": main,
        "other_outer": worker, "other_inner": worker}
    assert all(s.end_ns >= s.start_ns for s in spans.values())


def test_host_sync_counts_the_threads_syncs_off_the_cpu():
    """`host_sync` counts one sync of the calling thread for a device that is
    not the CPU (recording on or off) and none for the CPU, and records a
    `host_sync` span while recording is on; the resource model's three
    tables copied to the device are three of them."""
    from diffusion_pruning_tpu_torch.core.resource import ResourceModel

    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    n = profiling.host_syncs()
    assert profiling.host_sync(cpu) is profiling.host_sync(card) is profiling.span("x")
    assert profiling.host_syncs() == n + 1
    seen = []
    t = threading.Thread(target=lambda: (profiling.host_sync(card),
                                         seen.append(profiling.host_syncs())))
    t.start()
    t.join()
    assert seen == [1] and profiling.host_syncs() == n + 1
    unet = GatedUNet(UNetConfig.tiny(cross_attention_dim=32))
    arch = torch.ones(2, unet.spec.vq_dim)
    profiling.start()
    with profiling.span("losses"):
        ratios = ResourceModel(unet.spec).resource_ratio(arch)
    spans = profiling.stop()
    assert torch.allclose(ratios, torch.ones(2))
    (losses,) = [s for s in spans if s.name == "losses"]
    assert [(s.name, s.parent) for s in spans if s is not losses] == [("host_sync", losses.id)] * 3
    assert profiling.host_syncs() == n + 1     # on the CPU nothing waits


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def server():
    pipe = PruningPipeline(*_modules(), device="cpu")
    srv = ExpertServer.from_codebook(pipe, pipe.unet.spec, pipe.unet.cfg, batch_size=2)
    srv.warmup(STEPS, 7.5)
    return srv


def _requests(server, seed, n):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 128, (n, 77)))
    noise = torch.from_numpy(rng.gumbel(size=(n, server.base_pipeline.unet.spec.vq_dim))
                             .astype(np.float32)) * 3
    latents = torch.from_numpy(rng.standard_normal((n, 8, 8, 4), dtype=np.float32))
    return ids, noise, latents


def test_serving_queue_records_submit_and_flush_spans_on_their_threads(server):
    """Submits on the main thread while a flush runs on its own: each submit
    is `submit` → encode_prompt, encode_negative, route, route_to_host; each
    flush is `flush` (its index and the rids it answered) → flush_lock,
    join, for each expert expert_pipe and one `tier` (expert, tier, rows,
    layout: "nchw" for a CPU expert) per tier batch → latents, denoise,
    decode, then to_host, all on the flush's thread."""
    queue = ServingQueue(server, num_inference_steps=STEPS)
    neg = torch.zeros(1, 77, dtype=torch.long)
    ids, noise, latents = _requests(server, 5, 6)

    def submit(i):
        return queue.submit(ids[i:i + 1], neg, route_noise=noise[i:i + 1],
                            latents=latents[i:i + 1])[0]

    profiling.start()
    first = [submit(i) for i in range(3)]
    fut = queue.flush_async()
    second = [submit(i) for i in range(3, 6)]   # while the first flush runs
    answered = [fut.result(), queue.flush_async().result()]
    spans = profiling.stop()
    by_id = {s.id: s for s in spans}
    main = threading.get_ident()

    submits = [s for s in spans if s.name == "submit"]
    assert len(submits) == len(first + second) and all(not s.ids for s in submits)
    for s in submits:
        assert s.thread == main and s.parent is None
        kids = _children(spans, s)
        assert [k.name for k in kids] == ["encode_prompt", "encode_negative", "route",
                                          "route_to_host"]
        assert all(k.thread == main and s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns
                   for k in kids)

    flushes = [s for s in spans if s.name == "flush"]
    assert [f.ids["flush"] for f in flushes] == [0, 1]
    for f, got in zip(flushes, answered):
        assert f.thread != main and f.parent is None
        assert sorted(f.ids["rids"]) == sorted(got)
        kids = _children(spans, f)
        names = [k.name for k in kids]
        assert names[:2] == ["flush_lock", "join"] and names[-1] == "to_host"
        routed = [queue.routes[r] for r in got]
        tiers = [k for k in kids if k.name == "tier"]
        pipes = [i for i, k in enumerate(kids) if k.name == "expert_pipe"]
        assert len(pipes) == len(set(routed))
        assert len(pipes) + len(tiers) + 3 == len(kids)
        for i, j in zip(pipes, pipes[1:] + [len(kids) - 1]):   # each expert's tiers follow its pipe
            assert len({k.ids["expert"] for k in kids[i + 1: j]}) == 1 and j > i + 1
        assert sorted((t.ids["expert"], t.ids["tier"], t.ids["rows"], t.ids["layout"])
                      for t in tiers) == sorted(
            (e, tier, rows, "nchw") for e in set(routed)
            for tier, rows in server.plan_batches(routed.count(e), server.batch_shapes))
        for t in tiers:
            parts = _children(spans, t)
            assert [p.name for p in parts] == ["latents", "denoise", "decode"]
            assert all(not p.ids and p.device_ms is None for p in parts)
        # a thread's ident may be reused by the next flush's thread
        family = [s for s in spans if s.thread == f.thread and s.parent is not None]
        assert family and all(by_id[s.parent].thread == f.thread for s in family)
    assert {s.name for s in spans} == {"submit", "encode_prompt", "encode_negative", "route",
                                       "route_to_host", "flush", "flush_lock", "join",
                                       "expert_pipe", "tier", "latents", "denoise", "decode",
                                       "to_host"}


def test_serving_with_recording_off_records_nothing(server):
    """No span is kept, and the served tiers are still counted by layout."""
    queue = ServingQueue(server, num_inference_steps=STEPS)
    ids, noise, latents = _requests(server, 6, 2)
    before = profiling.tiers_served()
    queue.submit(ids, torch.zeros(1, 77, dtype=torch.long), route_noise=noise, latents=latents)
    assert len(queue.flush()) == 2
    assert profiling.stop() == []
    routed = list(queue.routes.values())
    tiers = sum(len(server.plan_batches(routed.count(e), server.batch_shapes))
                for e in set(routed))
    after = profiling.tiers_served()
    assert after.get("nchw", 0) - before.get("nchw", 0) == tiers
    assert after.get("nhwc", 0) == before.get("nhwc", 0)


@pytest.mark.parametrize("zero_negative", [True, False])
def test_sdxl_submit_records_both_towers_under_encode_prompt(zero_negative):
    """An SDXL submit (two CLIP towers): `clip_l` then `clip_bigg` under
    `encode_prompt`; an empty negative prompt (`zero_negative`) is zeros and
    opens neither under `encode_negative`, an encoded one opens both."""
    from test_torch_port_sdxl import prompt_ids, random_code, tiny_sdxl_config, \
        tiny_sdxl_pipeline
    spec = build_structure(tiny_sdxl_config())
    quantizer = StructureQuantizer(spec, n_e=2, base=0.0)
    with torch.no_grad():
        codes = torch.stack([random_code(spec, 1), random_code(spec, 2)])
        quantizer.embedding_gs.copy_(torch.where(codes >= 0.5, 0.8, 0.2))
    pipe = tiny_sdxl_pipeline(hypernet=HyperStructure(spec, input_dim=8),
                              quantizer=quantizer.eval())
    pipe.zero_negative = zero_negative
    server = ExpertServer.from_codebook(pipe, spec, pipe.unet.cfg, batch_size=2)
    queue = ServingQueue(server, num_inference_steps=STEPS, guidance_scale=5.0)
    profiling.start()
    queue.submit(prompt_ids(1), prompt_ids(1, seed=9), hyper_net_input=torch.zeros(1, 8),
                 route_noise=1e3 * (2 * codes[:1] - 1), latents=torch.zeros(1, 8, 8, 4))
    spans = profiling.stop()
    (submit,) = [s for s in spans if s.name == "submit"]
    kids = {k.name: k for k in _children(spans, submit)}
    assert [k.name for k in _children(spans, kids["encode_prompt"])] == ["clip_l", "clip_bigg"]
    towers = [k.name for k in _children(spans, kids["encode_negative"])]
    assert towers == ([] if zero_negative else ["clip_l", "clip_bigg"])
    assert all(s.device_ms is None for s in spans if s.name.startswith("clip"))  # no card
    assert len(queue.flush()) == 1


# ---------------------------------------------------------------- the stage-1 step

def _step_world(cfg):
    unet, vae, text, hypernet, quantizer = _modules(seed=3)
    mods = PrunerModules(unet, vae, text, hypernet, quantizer, DiffusionSchedule())
    opt = make_optimizer(cfg, mods, B)
    return mods, opt, make_pruner_step(mods, cfg, opt)


def _batch_and_generator(seed=12):
    gen = torch.Generator().manual_seed(seed)
    batch = {"input_ids": torch.randint(0, 128, (B, 77), generator=gen),
             "mpnet_embeddings": torch.randn((B, 32), generator=gen),
             "pixel_values": 0.5 * torch.randn((B, 16, 16, 3), generator=gen)}
    return batch, gen


@pytest.mark.parametrize("max_grad_norm", [None, 1e-3])
def test_pruner_step_records_its_stages_in_mark_order(max_grad_norm):
    """`step` holds one span a stage in the order the marks name them, each
    closed before its mark and the next opened after it; `host_sync` spans
    sit at the step's sync sites: the resource tables' three copies (under
    `losses`), the skip test and, with `max_grad_norm`, one clip test a
    parameter group (under `optimizer`). On the CPU none of them waits, so
    `step.host_syncs` stays 0 (the card test holds it to the syncs the card
    reports)."""
    _, opt, step = _step_world(PrunerConfig(max_grad_norm=max_grad_norm))
    batch, gen = _batch_and_generator()
    marks = []
    profiling.start()
    step(batch, generator=gen, mark=lambda name: marks.append((name, time.time_ns())))
    spans = profiling.stop()
    assert step.host_syncs == 0
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "step"
    stages = _children(spans, root)
    assert [s.name for s in stages] == [name for name, _ in marks] == STAGES
    for i, ((_, at), stage) in enumerate(zip(marks, stages)):
        assert root.start_ns <= stage.start_ns <= stage.end_ns <= at <= root.end_ns
        if i + 1 < len(stages):
            assert at <= stages[i + 1].start_ns
    parent = {s.id: s.name for s in spans}
    syncs_at = [parent[s.parent] for s in spans if s.name == "host_sync"]
    clips = len(opt.param_groups) if max_grad_norm else 0
    assert syncs_at == ["losses"] * 3 + ["optimizer"] * (1 + clips)
    assert all(not s.ids for s in spans)
    step(batch, generator=gen)
    assert step.host_syncs == 0


def test_recording_leaves_the_step_bit_equal():
    """Two steps from the same state, recording on and off: every metric and
    every trainable after them equal bit for bit."""
    results = []
    for on in (True, False):
        mods, _, step = _step_world(PrunerConfig())
        batch, gen = _batch_and_generator()
        if on:
            profiling.start()
        metrics = [step(batch, generator=gen)[0] for _ in range(2)]
        spans = profiling.stop()
        assert bool(spans) == on
        params = {n: p.detach().clone() for n, p in mods.hypernet.named_parameters()}
        params["codebook"] = mods.quantizer.embedding.weight.detach().clone()
        results.append((metrics, params))
    (m_on, p_on), (m_off, p_off) = results
    for a, b in zip(m_on, m_off):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    for n in p_on:
        assert torch.equal(p_on[n], p_off[n]), n
