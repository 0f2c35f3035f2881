"""Plain PyTorch reference of the APTP stage-1 codebook step (`pretrain`
off), the step of `configs/pruning/sd-2-1_coco2014.yaml`:

  VAE encode of the pixels (frozen) → noise at the drawn timesteps → CLIP
  text (frozen) → hypernet logits of the MPNet features → the codebook rows
  through a gumbel sigmoid, the prompts assigned to them by Sinkhorn over
  the batch (3 iterations, ε 0.05) → the contrastive loss of the prompts'
  own gates against their MPNet features → the dense teacher and the
  student under the assigned rows → min-SNR(5) v-prediction loss,
  distillation and block-distillation MSE, the resource loss (|log(ratio /
  p)| of the MACs ratio) and the std and max terms → gradients into the
  hypernet and the codebook → AdamW at the peak rate × √B after a linear
  warm-up of 100 updates.

Everything in float32 with TF32 off; the U-Net, VAE and CLIP are the
modules of `reference/sd.py`. The U-Net terms are computed in blocks of rows
(their losses are means over rows), the router terms over the whole batch.
Gate layout and the MACs of each gate site follow APTP's conventions (the
ptflops counts of the original code, quirks kept: attention scores count
the query length squared, a linear's bias counts once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from portbench.reference import sd as ref

# ---------------------------------------------------------------- resource model

def _conv(k, cin, cout, h, bias=True):
    return float(k * k * cin * cout * h * h) + (float(cout * h * h) if bias else 0.0)


def _lin(tokens, din, dout, bias=True):
    return float(tokens * din * dout) + (float(dout) if bias else 0.0)


@dataclasses.dataclass
class Macs:
    site: Dict[tuple, float]          # (subblock name, site index) -> prunable MACs
    nonprunable: Dict[str, float]     # subblock name -> MACs outside its sites
    total: float                      # every MAC of the U-Net


def mac_table(spec: ref.UNetSpec, layout: ref.Layout) -> Macs:
    s, L, temb = spec.sample_size, spec.num_levels, spec.time_embed_dim
    site, nonp = {}, {}
    total = _conv(3, spec.in_channels, spec.block_out_channels[0], s)
    total += _lin(1, spec.block_out_channels[0], temb) + 2.0 * temb + _lin(1, temb, temb)
    subs = layout.by_name()
    c0 = spec.block_out_channels[0]

    def resnet(name, cin, cout, h):
        site[(name, 0)] = (_conv(3, cin, cout, h) + _lin(1, temb, cout) + 2.0 * h * h * cout
                           + _conv(3, cout, cout, h))
        nonp[name] = 2.0 * h * h * cin + (_conv(1, cin, cout, h) if cin != cout else 0.0)

    def transformer(name, c, heads, h):
        seq, d = h * h, c // heads
        core = float(heads) * (2.0 * seq * seq * d + seq * seq)
        site[(name, 0)] = 3 * _lin(seq, c, c, False) + core + _lin(seq, c, c)
        site[(name, 1)] = (_lin(seq, c, c, False) + 2 * _lin(spec.max_text_len,
                                                            spec.cross_attention_dim, c, False)
                           + core + _lin(seq, c, c))
        inner = c * spec.ff_mult
        site[(name, 2)] = _lin(seq, c, 2 * inner) + _lin(seq, inner, c)
        nonp[name] = 2.0 * seq * c + 2 * _lin(seq, c, c) + 3.0 * seq * c

    out = c0
    for i in range(L):
        cin, out, h = out, spec.block_out_channels[i], s >> i
        for j in range(spec.layers_per_block):
            resnet(f"down.{i}.resnet.{j}", cin if j == 0 else out, out, h)
        if f"down.{i}.attn.0" in subs:
            for j in range(spec.layers_per_block):
                transformer(f"down.{i}.attn.{j}", out, spec.attention_head_dim[i], h)
        if i < L - 1:
            total += _conv(3, out, out, h // 2)
    mid, hm = spec.block_out_channels[-1], s >> (L - 1)
    resnet("mid.resnet.0", mid, mid, hm)
    resnet("mid.resnet.1", mid, mid, hm)
    transformer("mid.attn.0", mid, spec.attention_head_dim[L - 1], hm)
    rev = list(reversed(spec.block_out_channels))
    out = rev[0]
    n_up = spec.layers_per_block + 1
    for i in range(L):
        prev, out = out, rev[i]
        in_ch, h = rev[min(i + 1, L - 1)], s >> (L - 1 - i)
        for j in range(n_up):
            skip = in_ch if j == n_up - 1 else out
            resnet(f"up.{i}.resnet.{j}", (prev if j == 0 else out) + skip, out, h)
        if f"up.{i}.attn.0" in subs:
            for j in range(n_up):
                transformer(f"up.{i}.attn.{j}", out, spec.attention_head_dim[L - 1 - i], h)
        if i < L - 1:
            total += _conv(3, out, out, 2 * h)
    total += 4.0 * s * s * c0 + _conv(3, c0, spec.out_channels, s)
    total += sum(site.values()) + sum(nonp.values())
    return Macs(site, nonp, total)


class Resource:
    """The MACs ratio of gates against the dense U-Net, differentiable in the
    gates through the straight-through threshold."""

    def __init__(self, spec: ref.UNetSpec, layout: ref.Layout, device):
        macs = mac_table(spec, layout)
        nw = layout.num_width
        coeff = torch.zeros(nw)
        depth_of = torch.zeros(nw, dtype=torch.long)
        d_nonp = torch.zeros(max(layout.num_depth, 1))
        dense = 0.0
        for sb in layout.subblocks:
            for k, st in enumerate(sb.sites):
                coeff[st.start:st.start + st.width] = macs.site[(sb.name, k)] / st.width
                depth_of[st.start:st.start + st.width] = sb.depth_index + 1
                dense += macs.site[(sb.name, k)]
            if sb.depth_index >= 0:
                d_nonp[sb.depth_index] = macs.nonprunable[sb.name]
                dense += macs.nonprunable[sb.name]
        self.coeff, self.depth_of, self.d_nonp = (t.to(device) for t in (coeff, depth_of, d_nonp))
        self.dense, self.total, self.nw = dense, macs.total, nw

    def ratio(self, arch: torch.Tensor) -> torch.Tensor:
        w = hard(arch[:, :self.nw])
        d = hard(arch[:, self.nw:])
        dfac = torch.cat([torch.ones_like(d[:, :1]), d], dim=1)[:, self.depth_of]
        return ((w * dfac * self.coeff).sum(dim=1) + d @ self.d_nonp) / self.dense

    def keep_target(self, p: float) -> float:
        """A keep fraction p of all MACs, as a fraction of the gateable ones."""
        return 1.0 - (1.0 - p) * self.total / self.dense


# ---------------------------------------------------------------- router

def hard(x: torch.Tensor) -> torch.Tensor:
    """Threshold at 0.5, gradient straight through."""
    return x + ((x >= 0.5).to(x.dtype) - x).detach()


class Hypernet(nn.Module):
    """One linear head per width site and one for the depth logits, applied
    as one product (`mh_fc.{i}`)."""

    def __init__(self, layout: ref.Layout, input_dim: int):
        super().__init__()
        widths = [s.width for sb in layout.subblocks for s in sb.sites] + [layout.num_depth]
        self.mh_fc = nn.ModuleList([nn.Linear(input_dim, w) for w in widths])

    def forward(self, x):
        w = torch.cat([fc.weight for fc in self.mh_fc])
        b = torch.cat([fc.bias for fc in self.mh_fc])
        return nn.functional.linear(x, w, b)


class Codebook(nn.Module):
    def __init__(self, num_experts: int, vq_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_experts, vq_dim)


class Router:
    """The quantizer's gate sampling and normalisation over a layout."""

    def __init__(self, layout: ref.Layout, temperature: float, base: float, depth_order,
                 device):
        self.layout, self.t, self.base = layout, temperature, base
        nw, nd, vq = layout.num_width, layout.num_depth, layout.vq_dim
        order = [i % nd for i in (depth_order if depth_order is not None else range(nd))]
        inv = np.empty(nd, dtype=np.int64)
        inv[np.asarray(order)] = np.arange(nd)
        self.perm = torch.as_tensor(inv, device=device)
        group = torch.zeros(nw, dtype=torch.long)
        first = torch.zeros(nw)
        template = torch.ones(vq)
        soft = torch.zeros(vq)
        depth_col = torch.zeros(vq, dtype=torch.long)
        g = 0
        for sb in layout.subblocks:
            for s in sb.sites:
                group[s.start:s.start + s.width] = g
                first[s.start] = 1.0
                template[s.start:s.start + s.width] = 1.0 / math.sqrt(s.width)
                g += 1
            if sb.depth_index >= 0:
                lo, last = sb.sites[0].start, sb.sites[-1]
                soft[lo:last.start + last.width] = 1.0
                depth_col[lo:last.start + last.width] = nw + sb.depth_index
        self.groups = g
        self.group, self.first, self.template, self.soft, self.depth_col = (
            t.to(device) for t in (group, first, template, soft, depth_col))

    def gates(self, z: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        nw = self.layout.num_width
        z, noise = z.float(), noise.float()
        yw = torch.sigmoid((z[:, :nw] + noise[:, :nw] + self.base) / self.t)
        alive = torch.zeros(yw.shape[0], self.groups, device=z.device)
        alive.index_add_(1, self.group, hard(yw))
        yw = yw + 0.5 * (alive == 0).float()[:, self.group] * self.first
        x = torch.flip(torch.cumsum(torch.softmax(z[:, nw:], dim=1), dim=1), dims=(1,))
        x = torch.log(x + 1e-6) - torch.log1p(-(x - 1e-6))
        yd = torch.sigmoid((x + noise[:, nw:] + self.base) / self.t)
        return torch.cat([yw, yd[:, self.perm]], dim=1)

    def normalise(self, x: torch.Tensor) -> torch.Tensor:
        return (hard(x) * (1.0 - self.soft) + x * x[:, self.depth_col] * self.soft) * self.template

    def scores(self, gates, codes):
        u = self.normalise(gates)
        v = self.normalise(codes)
        return (u / torch.linalg.norm(u, dim=-1, keepdim=True)) @ \
            (v / torch.linalg.norm(v, dim=-1, keepdim=True)).T


def sinkhorn_assign(scores: torch.Tensor, epsilon: float = 0.05, iterations: int = 3):
    q = torch.exp((scores - scores.max()) / epsilon).T
    k, b = q.shape
    q = q / q.sum()
    tiny = torch.finfo(q.dtype).tiny
    for _ in range(iterations):
        q = q / q.sum(dim=1, keepdim=True).clamp_min(tiny) / k
        q = q / q.sum(dim=0, keepdim=True).clamp_min(tiny) / b
    return torch.argmax((q * b).T, dim=-1)


def contrastive(prompts, arch, t_prompt=0.03, t_arch=0.03):
    a = arch / torch.linalg.norm(arch, dim=1, keepdim=True)
    t = prompts / torch.linalg.norm(prompts, dim=1, keepdim=True)
    a_sim = torch.softmax((a @ a.T) / t_arch, dim=-1).clamp(1e-7, 1.0 - 1e-7)
    t_sim = torch.softmax((t @ t.T) / t_prompt, dim=-1).detach()
    return (-(t_sim * torch.log(a_sim) + (1.0 - t_sim) * torch.log(1.0 - a_sim))).mean()


# ---------------------------------------------------------------- the step

@dataclasses.dataclass
class Stage1:
    unet: ref.UNet
    vae: ref.VAE
    clip: ref.CLIPText
    hypernet: Hypernet
    codebook: Codebook
    router: Router
    resource: Resource
    config: dict
    optimizer: torch.optim.Optimizer = None

    @classmethod
    def build(cls, modules, hypernet, codebook, config, device) -> "Stage1":
        """The step over the reference modules in the order `sd.MODULES`
        lists them (U-Net, CLIP text, VAE)."""
        unet, clip, vae = modules
        rc = config["router"]
        layout = unet.layout
        router = Router(layout, rc["quantizer_T"], rc["quantizer_base"], rc["depth_order"],
                        device)
        st = cls(unet, vae, clip, hypernet, codebook, router,
                 Resource(unet.spec, layout, device), config)
        tc = config["training"]
        scale = tc["train_batch_size"] ** 0.5
        st.optimizer = torch.optim.AdamW(
            [{"params": list(hypernet.parameters()),
              "peak": tc["hypernet_learning_rate"] * scale},
             {"params": [codebook.embedding.weight],
              "peak": tc["quantizer_learning_rate"] * scale}],
            lr=0.0, betas=(tc["adam_beta1"], tc["adam_beta2"]), eps=tc["adam_epsilon"],
            weight_decay=0.0, foreach=False)
        return st

    def params(self) -> Dict[str, torch.Tensor]:
        out = {f"hypernet.{n}": p for n, p in self.hypernet.named_parameters()}
        out["quantizer.embedding.weight"] = self.codebook.embedding.weight
        return out

    def losses(self, batch, draws, rows: int = 16):
        """(total loss value, {name: gradient}) of one batch, the gradients
        in `.grad` of the trainables too."""
        sched, tc = self.config["scheduler"], self.config["training"]
        for p in self.params().values():
            p.grad = None
        ac_table = torch.as_tensor(ref.alphas_cumprod(sched), device=batch["input_ids"].device)
        with torch.no_grad():
            px = batch["pixel_values"].permute(0, 3, 1, 2).float()
            latents = self.vae.encode(px, draws["vae_eps"].permute(0, 3, 1, 2).float())
            ehs = self.clip(batch["input_ids"])
            t = draws["timesteps"]
            ac = ac_table[t]
            sa, so = ac.sqrt()[:, None, None, None], (1.0 - ac).sqrt()[:, None, None, None]
            noise = draws["noise"].permute(0, 3, 1, 2).float()
            noisy = sa * latents + so * noise
            target = sa * noise - so * latents if sched["prediction_type"] == "v_prediction" \
                else noise
            snr = ac / (1.0 - ac)
            if sched["prediction_type"] == "v_prediction":
                snr = snr + 1.0
            weights = torch.clamp(snr, max=tc["snr_gamma"]) / snr
        emb = batch["mpnet_embeddings"].float()
        logits = self.hypernet(emb)
        codes = self.router.gates(self.codebook.embedding.weight, draws["codebook_gumbel"])
        with torch.no_grad():
            own = self.router.gates(logits, draws["gates_gumbel"])
            idx = sinkhorn_assign(self.router.scores(own, codes.detach()))
        z_q = codes[idx]
        gates = self.router.gates(logits, draws["gumbel"])
        c_loss = contrastive(emb, self.router.normalise(gates))
        ratios = self.resource.ratio(z_q)
        r_loss = torch.abs(torch.log(ratios.mean()) - math.log(
            self.resource.keep_target(tc["pruning_target"])))
        std_loss = -torch.sqrt(ratios.var(unbiased=False) + 1e-12)
        max_loss = 1.0 - ratios.max()

        w = tc["loss_weights"]
        b = noisy.shape[0]
        leaf = z_q.detach().requires_grad_()
        unet_value = 0.0
        for lo in range(0, b, rows):
            sl = slice(lo, lo + rows)
            with torch.no_grad():
                t_out, t_feats = self.unet(noisy[sl], t[sl], ehs[sl], None, return_features=True)
            s_out, s_feats = self.unet(noisy[sl], t[sl], ehs[sl], leaf[sl], return_features=True)
            d = (weights[sl] * (s_out - target[sl]).square().mean(dim=(1, 2, 3))).sum() / b
            dist = (s_out - t_out).square().sum() / t_out[0].numel() / b
            block = sum((s_feats[k] - t_feats[k]).square().sum() / t_feats[k][0].numel()
                        for k in sorted(t_feats)) / len(t_feats) / b
            part = w["diffusion"] * d + w["distillation"] * dist + w["block"] * block
            part.backward()
            unet_value += float(part.detach())
        router = (w["resource"] * r_loss + w["contrastive"] * c_loss + w["std"] * std_loss
                  + w["max"] * max_loss)
        (router + (z_q * leaf.grad).sum()).backward()
        grads = {}
        for n, p in self.params().items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads[n] = p.grad.detach().clone()
        return unet_value + float(router.detach()), grads

    def step(self, batch, draws) -> tuple:
        """One update: (loss, gradients); a non-finite loss or gradient skips
        the update, as the program's step does."""
        loss, grads = self.losses(batch, draws)
        finite = math.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads.values())
        if finite:
            warm = self.config["training"]["lr_warmup_steps"]
            for g in self.optimizer.param_groups:
                st = self.optimizer.state.get(g["params"][0])
                applied = int(st["step"]) if st else 0
                g["lr"] = g["peak"] * min(1.0, applied / warm) if warm else g["peak"]
            self.optimizer.step()
        return loss, grads


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: Optional[List[str]] = None
              ) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    names = keep if keep is not None else sorted(want)
    median = float(np.median([want[n] for n in names])) if names else 0.0
    return {n: abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names}
