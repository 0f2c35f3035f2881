"""Tensor parallelism for the gated U-Net: a 2-D data × model mesh and
Megatron's column and row splits, with explicit collectives.

The JAX package's `parallel/tp.py` annotates Megatron `PartitionSpec`s and
lets XLA's partitioner place the collectives and pad uneven shards. Here a
rank is a process and the split is explicit:

* `dp_tp_mesh(n_data, n_model)` cuts the `init_distributed` world into a
  data axis (the ranks with this rank's model index) and a model axis (the
  ranks with its data index), each a `parallel.mesh.DataMesh` with its own
  group, so `psum`, `pmean_` and `all_gather` serve both axes. Rank r sits at
  (r // n_model, r % n_model), as JAX's `devices.reshape(n_data, n_model)`.
* The split rules (`tp_plan`, `split_keys`): per attention, q/k/v emit and
  to_out takes whole heads; per feed-forward, `ff.net.0.proj` emits and
  `ff.net.2` takes whole gate groups (`ff_gate_width` of them in a dense
  block), the matching slice of BOTH GEGLU halves; per resnet, conv1 and
  time_emb_proj emit, norm2 normalises and conv2 takes whole norm2 groups.
  Everything else is replicated, the row-parallel biases too: each is added
  once, after the reduction. A site's units are divided as evenly as whole
  units allow (`unit_range`: 5 heads at tp = 2 split 3 + 2); a rank may hold
  none, and then it computes nothing there, puts zeros into the reduction
  and still joins it. Two rows differ from the JAX specs on purpose: JAX
  splits the GEGLU kernel as one contiguous block (at tp = 2 one rank would
  hold the linear half and the other the GELU half), and it keeps norm2
  replicated (XLA gathers its channels); here norm2's statistics are per
  group and no group is cut, so norm2 is split with its groups.
* `shard_params` / `gather_params`: a full state dict to one model rank's
  shard and back; `gather_state` is the collective form a rank calls on its
  own shard. `shard_unet` rebuilds a `GatedUNet` (dense, or an expert's
  `GatedUNet(plan=)`) at this rank's widths and loads its shard.
* Megatron's two collectives as autograd Functions: f (`copy_to_model`:
  identity forward, the gradients' all_reduce backward), once a site on its
  column-parallel inputs, and g (`reduce_from_model`: all_reduce forward,
  identity backward) at each row-parallel output (to_out.0, ff.net.2,
  conv2): 70 a forward of the SD-2.1 U-Net (16 transformers × 3 + 22
  resnets). Partial products are summed in f32 and rounded once, as a
  one-process matmul accumulates. (`torch.distributed.nn.functional.
  all_reduce` would reduce the gradient a second time in its backward.)
* `tp_forward` (the counterpart of `tp_jit_forward`) and `shard_pipeline`.

`tp_stats` counts the forward reductions, the backward ones and the host
seconds spent inside both.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from diffusion_pruning_tpu_torch.parallel.mesh import DataMesh, all_gather, data_mesh, rank_slice

DATA_AXIS = "data"
MODEL_AXIS = "model"

tp_stats = {"reductions": 0, "grad_reductions": 0, "reduce_seconds": 0.0}


def reset_tp_stats() -> None:
    tp_stats.update(reductions=0, grad_reductions=0, reduce_seconds=0.0)


# ---------------------------------------------------------------- the mesh

@dataclasses.dataclass(frozen=True)
class DpTpMesh(DataMesh):
    """The whole world as a `DataMesh` (rank 0 writes, a barrier spans every
    rank) with its two axes."""
    data: Optional[DataMesh] = None
    model: Optional[DataMesh] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.world_size, MODEL_AXIS: self.model.world_size}


def dp_tp_mesh(n_data: int, n_model: int, device=None) -> DpTpMesh:
    """The n_data × n_model mesh of the process group `init_distributed`
    formed, or of this process alone (1 × 1). Every rank creates every group
    of an axis longer than 1, in the same order. A world of another size
    raises: there is no 1-D fallback."""
    world = data_mesh(device)
    if world.world_size != n_data * n_model:
        raise ValueError(f"a {n_data} × {n_model} mesh needs {n_data * n_model} ranks; the world "
                         f"has {world.world_size}")
    d, m = divmod(world.rank, n_model)

    def axis(index: int, size: int, mine: int, members) -> DataMesh:
        if size == 1:
            return DataMesh(0, 1, world.device)
        groups = [dist.new_group(members(j)) for j in range(world.world_size // size)]
        return DataMesh(index, size, world.device, world.backend, groups[mine])

    model = axis(m, n_model, d, lambda j: [j * n_model + i for i in range(n_model)])
    data = axis(d, n_data, m, lambda j: [i * n_model + j for i in range(n_data)])
    return DpTpMesh(world.rank, world.world_size, world.device, world.backend, world.group,
                    data=data, model=model)


# ---------------------------------------------------------------- the split rules

@dataclasses.dataclass(frozen=True)
class SiteSplit:
    """One split site of a U-Net (dense or expert) as its module holds it:
    `units` whole units of `unit` channels."""
    name: str     # the subblock, as `StructureSpec` names it ('down.0.attn.1')
    kind: str     # 'resnet' | 'attn1' | 'attn2' | 'ff'
    prefix: str   # the state-dict prefix of the module the site splits
    units: int
    unit: int


def unit_range(units: int, rank: int, n: int) -> Tuple[int, int]:
    """[lo, hi) of the units rank `rank` of n holds: one more than
    units // n for the first units % n ranks (5 at 2: 3 + 2; 1 at 2: 1 + 0)."""
    per, extra = divmod(units, n)
    lo = rank * per + min(rank, extra)
    return lo, lo + per + (1 if rank < extra else 0)


def named_subblocks(unet):
    """(subblock name, its state-dict prefix, module) of every resnet and
    transformer a U-Net holds, in forward order (a dropped one is absent)."""
    from diffusion_pruning_tpu_torch.models.unet.pruned import module_name

    def blocks(kind: str, block):
        for j, res in enumerate(block.resnets):
            yield f"{kind}.resnet.{j}", res
        for j, attn in enumerate(getattr(block, "attentions", ())):
            yield f"{kind}.attn.{j}", attn

    parts = [(f"down.{i}", b) for i, b in enumerate(unet.down_blocks)]
    parts += [("mid", unet.mid_block)] + [(f"up.{i}", b) for i, b in enumerate(unet.up_blocks)]
    for kind, block in parts:
        for name, module in blocks(kind, block):
            if module is not None:
                yield name, module_name(name), module


def tp_plan(unet) -> Tuple[SiteSplit, ...]:
    """The split sites of a U-Net at the widths it holds: a dense block's
    units are its norm2 groups, heads and `ff_gate_width` gate groups, an
    expert's only the kept ones (unit sizes are the dense model's)."""
    cfg = unet.cfg
    out = []
    for name, prefix, m in named_subblocks(unet):
        if "resnet" in name:
            unit = m.conv2.out_channels // cfg.norm_num_groups
            out.append(SiteSplit(name, "resnet", prefix, m.conv1.out_channels // unit, unit))
            continue
        tb, p = m.transformer_blocks[0], f"{prefix}.transformer_blocks.0"
        ff_unit = tb.ff.net[2].out_features * cfg.ff_mult // cfg.ff_gate_width
        out += [SiteSplit(name, kind, f"{p}.{kind}", a.heads, a.head_dim)
                for kind, a in (("attn1", tb.attn1), ("attn2", tb.attn2))]
        out.append(SiteSplit(name, "ff", f"{p}.ff", tb.ff.net[2].in_features // ff_unit, ff_unit))
    return tuple(out)


def _site_keys(site: SiteSplit) -> Dict[str, Tuple[int, bool]]:
    """{key: (split dim, whether it holds both GEGLU halves)} of a site."""
    p = site.prefix
    if site.kind == "resnet":
        out = {f"{p}.{k}": (0, False) for k in ("conv1.weight", "conv1.bias",
                                                 "time_emb_proj.weight", "time_emb_proj.bias",
                                                 "norm2.weight", "norm2.bias")}
        out[f"{p}.conv2.weight"] = (1, False)
        return out
    if site.kind == "ff":
        return {f"{p}.net.0.proj.weight": (0, True), f"{p}.net.0.proj.bias": (0, True),
                f"{p}.net.2.weight": (1, False)}
    out = {f"{p}.{k}.weight": (0, False) for k in ("to_q", "to_k", "to_v")}
    out[f"{p}.to_out.0.weight"] = (1, False)
    return out


def split_keys(plan: Sequence[SiteSplit]) -> Dict[str, Tuple[SiteSplit, int, bool]]:
    """{state-dict key: (site, split dim, both GEGLU halves)} of every split
    tensor; every other key is replicated."""
    return {k: (site, dim, halves) for site in plan
            for k, (dim, halves) in _site_keys(site).items()}


def local_index(site: SiteSplit, rank: int, n: int, halves: bool, device=None) -> torch.Tensor:
    """The channels of rank `rank`'s units along a split dim (with `halves`,
    the same slice of both GEGLU halves)."""
    lo, hi = unit_range(site.units, rank, n)
    idx = torch.arange(lo * site.unit, hi * site.unit, device=device)
    return torch.cat([idx, idx + site.units * site.unit]) if halves else idx


def shard_params(state_dict: Dict[str, torch.Tensor], rank: int, n_model: int,
                 plan: Sequence[SiteSplit]) -> Dict[str, torch.Tensor]:
    """Model rank `rank`'s shard of a full state dict: each split tensor's
    slice (a copy), every other entry the tensor itself. A pure function of
    its arguments."""
    keys = split_keys(plan)
    out = {}
    for k, v in state_dict.items():
        if k in keys:
            site, dim, halves = keys[k]
            v = v.index_select(dim, local_index(site, rank, n_model, halves, v.device))
        out[k] = v
    return out


def gather_params(shards: Sequence[Dict[str, torch.Tensor]], plan: Sequence[SiteSplit]
                  ) -> Dict[str, torch.Tensor]:
    """The full state dict of every model rank's shard, in rank order (the
    inverse of `shard_params`); replicated entries are rank 0's."""
    keys = split_keys(plan)
    out = {}
    for k, v in shards[0].items():
        if k not in keys:
            out[k] = v
            continue
        _, dim, halves = keys[k]
        parts = [s[k] for s in shards]
        if halves:
            h = [p.chunk(2, dim) for p in parts]
            parts = [x[0] for x in h] + [x[1] for x in h]
        out[k] = torch.cat(parts, dim)
    return out


def gather_state(axis: DataMesh, local: Dict[str, torch.Tensor], plan: Sequence[SiteSplit]
                 ) -> Dict[str, torch.Tensor]:
    """The full state dict on every rank of the model axis, each rank passing
    its own shard (a collective): each split tensor placed at its channels in
    zeros and summed over the axis (exact: every other term is zero; half
    types travel as f32); replicated entries are this rank's."""
    keys = split_keys(plan)
    out = {}
    for k, v in local.items():
        if k not in keys:
            out[k] = v
            continue
        site, dim, halves = keys[k]
        shape = list(v.shape)
        shape[dim] = site.units * site.unit * (2 if halves else 1)
        wide = v.dtype if v.dtype in (torch.float32, torch.float64) else torch.float32
        full = torch.zeros(shape, dtype=wide, device=v.device)
        full.index_copy_(dim, local_index(site, axis.rank, axis.world_size, halves, v.device),
                         v.detach().to(wide))
        if axis.distributed:
            dist.all_reduce(full, group=axis.group)
        out[k] = full.to(v.dtype)
    return out


# ---------------------------------------------------------------- a rank's share of a site

@dataclasses.dataclass(frozen=True)
class Split:
    """What a block of a sharded U-Net holds of its site: units [lo, hi) on
    the model axis `axis`."""
    axis: DataMesh
    lo: int
    hi: int

    @property
    def empty(self) -> bool:
        return self.hi == self.lo


@dataclasses.dataclass(frozen=True)
class UNetShard:
    """This rank's share of every split site of a U-Net: what
    `GatedUNet(cfg, plan, shard=)` builds its blocks at."""
    axis: DataMesh
    plan: Tuple[SiteSplit, ...]

    def __post_init__(self):
        object.__setattr__(self, "_sites", {(s.name, s.kind): s for s in self.plan})

    def split(self, name: str, kind: str) -> Split:
        site = self._sites[(name, kind)]
        return Split(self.axis, *unit_range(site.units, self.axis.rank, self.axis.world_size))

    def local_channels(self, name: str, kind: str) -> int:
        s = self.split(name, kind)
        return (s.hi - s.lo) * self._sites[(name, kind)].unit

    def local_units(self, name: str, kind: str) -> int:
        s = self.split(name, kind)
        return s.hi - s.lo

    @property
    def split_keys(self) -> Dict[str, Tuple[SiteSplit, int, bool]]:
        return split_keys(self.plan)


def shard_unet(unet, mesh: DpTpMesh):
    """This rank's slice of `unet` (a `GatedUNet`, dense or an expert) on the
    model axis of `mesh`: the same class rebuilt at the rank's widths
    (`GatedUNet(cfg, plan, shard=)`) on the meta device, holding
    `shard_params` of its state dict (split tensors copied, replicated ones
    shared with `unet`), in `unet`'s mode and trainability. Every rank must
    hold the same `unet`."""
    from diffusion_pruning_tpu_torch.models.unet.unet import GatedUNet
    axis = mesh.model
    plan = tp_plan(unet)
    with torch.device("meta"), warnings.catch_warnings():
        # a rank holding no unit of a site has zero-element weights there
        warnings.filterwarnings("ignore", "Initializing zero-element tensors is a no-op")
        local = GatedUNet(unet.cfg, plan=unet.plan, shard=UNetShard(axis, plan))
    with torch.inference_mode(False):
        state = shard_params(unet.state_dict(), axis.rank, axis.world_size, plan)
    local.load_state_dict(state, strict=True, assign=True)
    trainable = any(p.requires_grad for p in unet.parameters())
    return local.train(unet.training).requires_grad_(trainable)


# ---------------------------------------------------------------- the collectives

def _layout(t: torch.Tensor) -> torch.memory_format:
    """channels_last where t is held so (and not also contiguous), else
    contiguous."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _reduce_f32(axis: DataMesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Σ over the axis of each tensor, in f32, in one all_reduce of their
    elements in logical order (the ranks may hold the same tensor in other
    layouts: a rank with no unit of a site gets a contiguous zero gradient
    where another's conv gives a channels_last one): new contiguous f32
    tensors."""
    t0 = time.perf_counter()
    wides = [t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
             for t in tensors]
    flat = wides[0].view(-1) if len(wides) == 1 else torch.cat([w.view(-1) for w in wides])
    dist.all_reduce(flat, group=axis.group)
    if len(wides) > 1:
        torch._foreach_copy_([w.view(-1) for w in wides],
                             list(flat.split([w.numel() for w in wides])))
    tp_stats["reduce_seconds"] += time.perf_counter() - t0
    return wides


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; backward, the gradients summed over the model
    axis in one all_reduce."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        ctx.formats = [(x.dtype, _layout(x)) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, g in enumerate(grads) if ctx.needs_input_grad[i + 1] and g is not None]
        out = list(grads)
        if need:  # every rank's node has the same inputs, so the same `need`
            tp_stats["grad_reductions"] += 1
            summed = _reduce_f32(ctx.axis, [grads[i] for i in need])
            for i, g in zip(need, summed):
                # the layout of the (replicated) input, not of this rank's gradient, so
                # that every rank's backward goes on with the same bits
                dtype, fmt = ctx.formats[i]
                out[i] = g.to(dtype, memory_format=fmt)
        return (None, *out)


def copy_to_model(axis: DataMesh, *xs: Optional[torch.Tensor]):
    """f on a site's column-parallel inputs: one node over those that need a
    gradient (the others, and None, pass through), whose backward sums their
    gradients over the model axis. Apply it once a site, on every rank, so
    that every rank's backward runs the same reductions in the same order."""
    given = [i for i, x in enumerate(xs) if x is not None and x.requires_grad]
    if not axis.distributed or not given or not torch.is_grad_enabled():
        return xs
    outs = list(xs)
    for i, y in zip(given, _CopyToModel.apply(axis, *[xs[i] for i in given])):
        outs[i] = y
    return tuple(outs)


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial products summed over the model axis in f32; backward,
    the identity (cast to the partial's dtype)."""

    @staticmethod
    def forward(ctx, axis, partial):
        ctx.dtype = partial.dtype
        return _reduce_f32(axis, [partial])[0]

    @staticmethod
    def backward(ctx, grad):
        return None, grad.to(ctx.dtype)


def reduce_from_model(axis: DataMesh, partial: torch.Tensor, bias: Optional[torch.Tensor],
                      like: torch.Tensor) -> torch.Tensor:
    """g on a row-parallel output: Σ of the ranks' partial products in f32,
    + the replicated bias once (on the channel dim: last for a linear's
    (B, S, C), 1 for a conv's (B, C, H, W)), rounded once to the partial's
    dtype, in the layout of `like` (a replicated tensor of the site: every
    rank's output then has the same strides)."""
    tp_stats["reductions"] += 1
    out = (_ReduceFromModel.apply(axis, partial) if axis.distributed
           else partial.float())
    if bias is not None:
        b = bias.float()
        out = out + (b[:, None, None] if partial.dim() == 4 else b)
    return out.to(partial.dtype, memory_format=_layout(like))


def empty_partial(shape, x: torch.Tensor, *inputs: Optional[torch.Tensor]) -> torch.Tensor:
    """The zeros (x's dtype and device) a rank that holds no unit of a site
    puts into the reduction, joined (through an empty slice) to the first of
    its f outputs (x, then `inputs`) that needs a gradient, so that its f
    node runs in the backward as every other rank's does. Launches no
    product."""
    z = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled():
        src = next((t for t in (x, *inputs) if t is not None and t.requires_grad), None)
        if src is not None:
            z = z + src.reshape(-1)[:0].sum().to(z.dtype)
    return z


# ---------------------------------------------------------------- forward and pipeline

def tp_forward(unet, mesh: DpTpMesh):
    """fwd(sample, timesteps, encoder_hidden_states, arch=None) of a sharded
    U-Net (`shard_unet`): this rank's rows of the batch on the data axis
    (an arch of one row stays whole; any other is tiled to the batch first),
    the model axis splitting each site, and the output gathered whole on
    every rank (the JAX forward returns a global array). No gradient."""
    from diffusion_pruning_tpu_torch.ops.gates import match_batch

    def fwd(sample, timesteps, encoder_hidden_states, arch=None):
        n = sample.shape[0]
        rows = rank_slice(mesh.data, n)
        if arch is not None and arch.shape[0] != 1:
            arch = match_batch(arch, n)[rows]
        out = unet(sample[rows], timesteps[rows], encoder_hidden_states[rows], arch=arch)
        return all_gather(mesh.data, out)

    return fwd


def shard_pipeline(pipe, mesh: DpTpMesh):
    """A new `PruningPipeline` that carries `mesh`: its U-Net sharded on the
    model axis (`shard_unet`), its VAE, text tower, hypernet and quantizer
    this one's, replicated on every rank (each rank builds them alike, as
    from one seed or one checkpoint). Batches are cut on the data axis and
    the images gathered (`PruningPipeline._data_shard`)."""
    out = pipe.with_unet(shard_unet(pipe.unet, mesh))
    out.mesh = mesh
    return out
