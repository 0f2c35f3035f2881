"""The routed pipeline of `cli/serve.py --mode routed`, on CUDA graphs: no
experts are served; every request is denoised by the dense gated U-Net
under its routed code, the requests of a flush pooled into one gated batch
(`ExpertServer._run_tiers("gated", ...)`) at the tiers 1, 2, ...,
`batch_size`, each tier's trajectory a graph captured at warm-up
(`ExpertServer.warmup(hybrid=True)` of a server with no experts).

The program is `entries/experts.py`'s, built without warm-up, with its
server replaced by one that holds no experts; the queue contract is the
same (`queue(program, config)`).
"""
import dataclasses

from portbench.harness import program as P


def build(config: dict, seed: int, device, warm: bool = True):
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ExpertServer
    s = config["serving"]
    prog = P.build(config, seed, device, warm=False)
    server = ExpertServer(prog.pipe, [], [], s["batch_size"])
    stats = {}
    if warm:
        stats = server.warmup(num_inference_steps=s["num_inference_steps"],
                              guidance_scale=s["guidance_scale"], hybrid=True)
    return dataclasses.replace(prog, server=server, warmup=stats)


def queue(program, config: dict):
    from diffusion_pruning_tpu_torch.pipelines.expert_server import ServingQueue
    s = config["serving"]
    return ServingQueue(program.server, num_inference_steps=s["num_inference_steps"],
                        guidance_scale=s["guidance_scale"], hybrid=True)
