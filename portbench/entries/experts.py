"""The expert server of `cli/serve.py --mode experts`: the codebook's
experts cut by `ExpertServer.from_codebook(..., param_dtype=bfloat16)`,
`ExpertServer.warmup` capturing a CUDA graph for each (expert, tier), and a
`ServingQueue` that tiers each flush's requests by routed expert.

An entry point defines `build(config, seed, device, warm=True)`, the
program (`harness/program.Program`: its models made from the seed, the
codes, the reference's gate layout), and `queue(program, config)`, what
the driver sends to: `submit(clip_ids, neg_ids, hyper_net_input=...,
route_noise=..., latents=...)` → request ids, `flush_async()` → a future of
{request id: image}, `last_slots_used` and `routes` (request id → expert).
"""
from portbench.harness import program as P


def build(config: dict, seed: int, device, warm: bool = True):
    return P.build(config, seed, device, warm)


def queue(program, config: dict):
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ServingQueue
    s = config["serving"]
    return ServingQueue(program.server, num_inference_steps=s["num_inference_steps"],
                        guidance_scale=s["guidance_scale"])
