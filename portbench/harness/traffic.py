"""The one traffic generator: reads a mix's parameter file and makes, from
the seed, what every request of a run sends.

A mix file (`portbench/traffic/<name>.json`) holds:

* `loop`: the arrival law, `portbench/arrivals/<loop>.py`: "open" (requests
  due on a schedule, whatever the server does; `rate_per_s`, or a
  `rate_cycle` of [seconds, rate] pieces for bursts) or "closed" (`clients`
  callers, each sending its next request when its image returns); "train"
  makes a training cell (`harness/training.py`). A law's file states its
  keys;
* `entry`: the serving entry point the requests go to,
  `portbench/entries/<entry>.py`;
* `expert_popularity`: {"law": "zipf", "s": ...}: the share of requests
  routed to the expert of rank r (rank r is expert r) is proportional to
  1 / (r + 1)^s. An open mix takes exactly the largest-remainder counts of
  its requests; a closed mix takes them for each round of `clients`
  requests;
* `prompt_tokens`: the lengths a prompt's tokens are drawn from (CLIP and
  MPNet alike), each used equally often;
* `reference_sample`: how many served requests the reference recomputes;
* `trace`: {"last_s"}: the traced run profiles the whole flushes that
  start in the window's last `last_s` seconds, and the drain after it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np
import torch

from portbench.harness import named

CLIP_BOS, CLIP_EOS, CLIP_PAD = 49406, 49407, 0      # SD-2.1's tokenizer pads with "!" (0)
MPNET_BOS, MPNET_EOS, MPNET_PAD, MPNET_FIRST = 0, 2, 1, 5


def load_mix(root: str, name: str) -> dict:
    with open(os.path.join(root, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def largest_remainder(total: int, weights: np.ndarray) -> np.ndarray:
    """Whole counts summing to `total` in proportion to `weights`."""
    share = total * weights / weights.sum()
    counts = np.floor(share).astype(np.int64)
    rest = total - int(counts.sum())
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


def popularity(mix: dict, num_experts: int) -> np.ndarray:
    law = mix["expert_popularity"]
    if law["law"] != "zipf":
        raise ValueError(f"unknown popularity law {law['law']!r}")
    return 1.0 / (np.arange(1, num_experts + 1) ** float(law["s"]))


def shuffled(values: np.ndarray, gen: torch.Generator) -> np.ndarray:
    return values[torch.randperm(len(values), generator=gen).numpy()]


@dataclasses.dataclass
class Schedule:
    """What a run sends. Open loop: `due_s[i]` and `experts[i]` of request i.
    Closed loop: `experts[k]` of the k-th request sent; `due_s` is empty
    (a request is due when its client's previous image returns)."""
    loop: str
    experts: np.ndarray
    due_s: np.ndarray
    clients: int = 0

    def __len__(self) -> int:
        return len(self.experts)


def schedule(mix: dict, seed: int, seconds: float, num_experts: int) -> Schedule:
    """What a run of `seconds` sends, by the mix's arrival law."""
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    return named.load("arrivals", mix["loop"]).schedule(mix, gen, seconds,
                                                         popularity(mix, num_experts))


def pool_size(sched: Schedule) -> int:
    """Prompt rows drawn at set-up: one per request of an open run; a closed
    run's request k takes row k mod 256."""
    return len(sched) if sched.loop == "open" else min(len(sched), 256)


@torch.no_grad()
def prompts(mix: dict, seed: int, rows: int, device, clip_len: int = 77,
            mpnet_len: int = 128, clip_vocab: int = 49408, mpnet_vocab: int = 30527):
    """Token ids of `rows` prompts, drawn on `device` from the seed in a few
    calls: CLIP ids (rows, clip_len) with BOS, tokens, EOS and padding;
    MPNet ids and mask (rows, mpnet_len). Lengths are `prompt_tokens`, each
    equally often, in an order drawn from the seed."""
    lengths = np.asarray(mix["prompt_tokens"], dtype=np.int64)
    gen_cpu = torch.Generator().manual_seed((int(seed) * 7 + 1) % (2 ** 63))
    lens = shuffled(np.resize(lengths, rows), gen_cpu)
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7 + 2) % (2 ** 63))
    lens_t = torch.as_tensor(lens, device=device)[:, None]

    def fill(length, bos, eos, pad, lo, hi):
        pos = torch.arange(length, device=device)[None, :]
        tok = torch.randint(lo, hi, (rows, length), generator=gen, device=device)
        ids = torch.where(pos <= lens_t, tok, torch.full_like(tok, pad))
        ids[:, 0] = bos
        ids.scatter_(1, torch.clamp(lens_t + 1, max=length - 1), eos)
        return ids, (pos <= lens_t + 1).long()

    clip_ids, _ = fill(clip_len, CLIP_BOS, CLIP_EOS, CLIP_PAD, 1, min(clip_vocab, CLIP_BOS))
    mp_ids, mp_mask = fill(mpnet_len, MPNET_BOS, MPNET_EOS, MPNET_PAD, MPNET_FIRST, mpnet_vocab)
    return clip_ids, mp_ids, mp_mask


def negative_prompt(device, clip_len: int = 77) -> torch.Tensor:
    """The empty negative prompt: BOS, EOS, padding (1, clip_len)."""
    ids = torch.full((1, clip_len), CLIP_PAD, dtype=torch.long, device=device)
    ids[0, 0], ids[0, 1] = CLIP_BOS, CLIP_EOS
    return ids


@torch.no_grad()
def initial_latents(seed: int, rows: int, side: int, channels: int, device) -> torch.Tensor:
    """Standard normal initial latents (rows, side, side, channels), f32."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7 + 3) % (2 ** 63))
    return torch.randn((rows, side, side, channels), generator=gen, device=device)


def reference_rows(served: List[int], experts_of: dict, count: int, seed: int) -> List[int]:
    """The served requests the reference recomputes: for each expert that
    served, one of its requests drawn from the seed, in order of expert,
    then further draws until `count` (or every request)."""
    gen = torch.Generator().manual_seed((int(seed) * 7 + 4) % (2 ** 63))
    served = sorted(served)
    order = [served[i] for i in torch.randperm(len(served), generator=gen).tolist()]
    picked, seen = [], set()
    for rid in order:
        if experts_of[rid] not in seen:
            seen.add(experts_of[rid])
            picked.append(rid)
    for rid in order:
        if len(picked) >= count:
            break
        if rid not in picked:
            picked.append(rid)
    return sorted(picked[:max(count, len(seen))])
