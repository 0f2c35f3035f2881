"""Gate layout + analytic MAC model, derived statically from a `UNetConfig`.

The port's own copy of the JAX package's `core/structure.py` (the port
imports nothing from that package). The original APTP code discovers its
gate structure by traversing a mutable module tree and measures MACs with
forward hooks; here both are computed **once, in Python, at config time**:

* `StructureSpec` pins the exact flat architecture-vector layout
  ``[width logits (subblock order: per block, resnets then attentions),
  depth logits (order of appearance)]`` — 1606 width + 14 depth logits for
  SD-2.1. A `Transformer2D` that stacks N transformer layers (SDXL's
  `transformer_layers_per_block`) holds N (attn1, attn2, ff) groups of
  sites, layer by layer, under its one depth gate (`layer_sites`).
* Each gate site carries its prunable-MAC coefficient (ptflops conventions,
  including their quirks: attention score MACs use the query length squared
  even for cross-attention; linear bias MACs are not scaled by token count),
  so the resource model (`resource.py`) is a dot product with the
  hard-concrete gates.

Everything in this file is plain Python floats — no tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from diffusion_pruning_tpu_torch.models.unet.config import UNetConfig


@dataclasses.dataclass(frozen=True)
class GateSite:
    """One width-gate group: `width` gate units masking `channels` channels."""
    kind: str          # 'resnet' | 'attn1' | 'attn2' | 'ff'
    width: int         # number of gate units
    channels: int      # channels covered (channels % width == 0)
    start: int         # offset into the flat width-logit segment
    prunable_macs: float


@dataclasses.dataclass(frozen=True)
class SubBlock:
    """A resnet or a transformer: the unit at which depth gating happens."""
    name: str          # e.g. 'down.0.resnet.1', 'up.2.attn.0'
    kind: str          # 'resnet' | 'transformer'
    sites: Tuple[GateSite, ...]
    depth_index: int   # index into the depth segment; -1 = not depth-gated
    nonprunable_macs: float  # block MACs outside the gated sites
    # static shape info used by the model modules
    in_channels: int
    out_channels: int
    heads: int = 0     # transformers only

    @property
    def total_macs(self) -> float:
        return self.nonprunable_macs + sum(s.prunable_macs for s in self.sites)

    @property
    def prunable_macs(self) -> float:
        return sum(s.prunable_macs for s in self.sites)


@dataclasses.dataclass(frozen=True)
class StructureSpec:
    subblocks: Tuple[SubBlock, ...]
    num_width: int          # total width logits (1606 for SD-2.1)
    num_depth: int          # depth gates (14 for SD-2.1)
    other_macs: float       # ungated modules: conv_in/time-embed/samplers/out

    @property
    def vq_dim(self) -> int:
        return self.num_width + self.num_depth

    @property
    def width_list(self) -> Tuple[int, ...]:
        """Flat per-group widths — the reference hypernet's `width_list`."""
        return tuple(s.width for sb in self.subblocks for s in sb.sites)

    @property
    def subblock_widths(self) -> Tuple[Tuple[int, ...], ...]:
        """Nested widths, one tuple per subblock (reference structure['width'])."""
        return tuple(tuple(s.width for s in sb.sites) for sb in self.subblocks)

    @property
    def depth_list(self) -> Tuple[int, ...]:
        """0/1 per subblock (reference structure['depth'] flattened)."""
        return tuple(1 if sb.depth_index >= 0 else 0 for sb in self.subblocks)

    @property
    def total_macs(self) -> float:
        return self.other_macs + sum(sb.total_macs for sb in self.subblocks)

    @property
    def prunable_macs(self) -> float:
        return sum(sb.prunable_macs for sb in self.subblocks)

    @property
    def cur_prunable_macs_dense(self) -> float:
        """`cur_prunable_macs` at all-ones gates — the resource-ratio
        denominator (trainer.py:1232-1233). Depth-gated subblocks contribute
        their non-prunable MACs too (skip connections etc.)."""
        total = 0.0
        for sb in self.subblocks:
            total += sb.prunable_macs
            if sb.depth_index >= 0:
                total += sb.nonprunable_macs
        return total

    def subblocks_by_prefix(self, prefix: str) -> Tuple[SubBlock, ...]:
        return tuple(sb for sb in self.subblocks if sb.name.startswith(prefix))


def layer_sites(sites) -> List[Dict[str, object]]:
    """The sites of a subblock (of a `SubBlock`, or of an expert plan's
    `SubBlockPlan`), one {kind: site} per stacked transformer layer: each
    layer's group starts at its `attn1` (a resnet's one site is one group)."""
    layers: List[Dict[str, object]] = []
    for site in sites:
        if site.kind == "attn1" or not layers:
            layers.append({})
        layers[-1][site.kind] = site
    return layers


# ---------------------------------------------------------------------------
# MAC primitives (ptflops conventions — op_counter.py:37-180)
# ---------------------------------------------------------------------------

def _conv_macs(k: int, cin: int, cout: int, h: int, w: int, bias: bool = True) -> float:
    m = float(k * k * cin * cout * h * w)
    if bias:
        m += float(cout * h * w)
    return m


def _linear_macs(tokens: int, din: int, dout: int, bias: bool = True) -> float:
    m = float(tokens * din * dout)
    if bias:
        m += float(dout)  # reference quirk: bias MACs not scaled by tokens
    return m


def _gn_macs(numel: int) -> float:
    return 2.0 * numel


def _ln_macs(numel: int) -> float:
    return float(numel)


def _silu_macs(numel: int) -> float:
    return 2.0 * numel


def _attn_core_macs(seq: int, heads: int, head_dim: int) -> float:
    """QK^T + softmax + AV. Reference quirk preserved: uses the query
    sequence length for both dims, even in cross-attention
    (op_counter.py:291-298)."""
    return float(heads) * (2.0 * seq * seq * head_dim + seq * seq)


# ---------------------------------------------------------------------------
# Structure builder
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, cfg: UNetConfig):
        self.cfg = cfg
        self.subblocks: List[SubBlock] = []
        self.width_cursor = 0
        self.depth_cursor = 0
        self.other_macs = 0.0

    def _site(self, kind: str, width: int, channels: int, prunable: float) -> GateSite:
        site = GateSite(kind, width, channels, self.width_cursor, prunable)
        self.width_cursor += width
        return site

    def add_resnet(self, name: str, cin: int, cout: int, h: int, depth: bool):
        cfg = self.cfg
        temb = cfg.time_embed_dim
        prunable = (
            _conv_macs(3, cin, cout, h, h)
            + _linear_macs(1, temb, cout)
            + _gn_macs(h * h * cout)
            + _conv_macs(3, cout, cout, h, h)
        )
        nonprunable = _gn_macs(h * h * cin)
        if cin != cout:
            nonprunable += _conv_macs(1, cin, cout, h, h)
        site = self._site("resnet", cfg.norm_num_groups, cout, prunable)
        d = self.depth_cursor if depth else -1
        if depth:
            self.depth_cursor += 1
        self.subblocks.append(
            SubBlock(name, "resnet", (site,), d, nonprunable, cin, cout)
        )

    def add_transformer(self, name: str, channels: int, heads: int, h: int, depth: bool,
                        layers: int = 1):
        """A `Transformer2D` of `layers` stacked transformer layers, each with
        its own attn1, attn2 and ff sites, under one depth gate."""
        cfg = self.cfg
        c = channels
        seq = h * h
        head_dim = c // heads
        # attn1 (self): q,k,v (no bias) + core + out proj (bias)
        attn1 = 3 * _linear_macs(seq, c, c, bias=False)
        attn1 += _attn_core_macs(seq, heads, head_dim)
        attn1 += _linear_macs(seq, c, c, bias=True)
        # attn2 (cross): q from x; k,v from context
        d_ctx = cfg.cross_attention_dim
        attn2 = _linear_macs(seq, c, c, bias=False)
        attn2 += 2 * _linear_macs(cfg.max_text_len, d_ctx, c, bias=False)
        attn2 += _attn_core_macs(seq, heads, head_dim)
        attn2 += _linear_macs(seq, c, c, bias=True)
        inner = c * cfg.ff_mult
        ff = _linear_macs(seq, c, 2 * inner, bias=True) + _linear_macs(seq, inner, c, bias=True)

        nonprunable = _gn_macs(seq * c)  # input GroupNorm
        if cfg.use_linear_projection:
            nonprunable += 2 * _linear_macs(seq, c, c, bias=True)  # proj_in/out
        else:
            nonprunable += 2 * _conv_macs(1, c, c, h, h)
        nonprunable += layers * 3 * _ln_macs(seq * c)  # norm1/2/3 of each layer
        if not cfg.gated_ff:
            # Reference quirk: an ungated FF is absent from block calc_macs
            # entirely (blocks.py:906-909); keep totals consistent with it.
            ff = 0.0

        sites = []
        for _ in range(layers):
            sites.append(self._site("attn1", heads, c, attn1))
            sites.append(self._site("attn2", heads, c, attn2))
            if cfg.gated_ff:
                sites.append(self._site("ff", cfg.ff_gate_width, inner, ff))
        d = self.depth_cursor if depth else -1
        if depth:
            self.depth_cursor += 1
        self.subblocks.append(
            SubBlock(name, "transformer", tuple(sites), d, nonprunable, c, c, heads)
        )


def _depth_flags(block_type: str, num_layers: int) -> List[bool]:
    """Which subblocks of a block carry a depth gate.

    'HalfGated'  -> only the last resnet/transformer pair (blocks.py:1717-1807)
    'Gated'      -> every pair (fully depth-gated variants)
    plain        -> none
    """
    if "HalfGated" in block_type:
        return [i == num_layers - 1 for i in range(num_layers)]
    if "Gated" in block_type:
        return [True] * num_layers
    return [False] * num_layers


def build_structure(cfg: UNetConfig) -> StructureSpec:
    """Derive the full gate layout + MAC table for a U-Net config.

    Subblock order matches the reference exactly: down blocks, mid, up
    blocks; within each block all resnets first, then all attentions
    (blocks.py:1814-1831)."""
    b = _Builder(cfg)
    L = cfg.num_levels
    s = cfg.sample_size

    # conv_in + time embedding (ungated)
    h0 = s
    b.other_macs += _conv_macs(3, cfg.in_channels, cfg.block_out_channels[0], h0, h0)
    temb = cfg.time_embed_dim
    b.other_macs += _linear_macs(1, cfg.block_out_channels[0], temb)
    b.other_macs += _silu_macs(temb)
    b.other_macs += _linear_macs(1, temb, temb)
    if cfg.addition_embed_type == "text_time":  # add_embedding, as the time embedding
        b.other_macs += _linear_macs(1, cfg.projection_class_embeddings_input_dim, temb)
        b.other_macs += _silu_macs(temb)
        b.other_macs += _linear_macs(1, temb, temb)

    # --- down blocks ---
    out_ch = cfg.block_out_channels[0]
    for i, block_type in enumerate(cfg.down_block_types):
        in_ch = out_ch
        out_ch = cfg.block_out_channels[i]
        h = s // (2 ** i)
        is_final = i == L - 1
        gated = "Gated" in block_type
        flags = _depth_flags(block_type, cfg.layers_per_block)
        cross = block_type.startswith("CrossAttn")
        for j in range(cfg.layers_per_block):
            cin = in_ch if j == 0 else out_ch
            if gated:
                b.add_resnet(f"down.{i}.resnet.{j}", cin, out_ch, h, flags[j])
            else:
                b.other_macs += _resnet_total(cfg, cin, out_ch, h)
        if cross:
            for j in range(cfg.layers_per_block):
                if gated:
                    b.add_transformer(f"down.{i}.attn.{j}", out_ch, cfg.heads_at(i), h, flags[j],
                                      cfg.transformer_layers_at(i))
                else:
                    b.other_macs += _transformer_total(cfg, out_ch, cfg.heads_at(i), h,
                                                       cfg.transformer_layers_at(i))
        if not is_final:  # downsampler
            b.other_macs += _conv_macs(3, out_ch, out_ch, h // 2, h // 2)

    # --- mid block ---
    mid_ch = cfg.block_out_channels[-1]
    hm = s // (2 ** (L - 1))
    mid_heads = cfg.heads_at(L - 1)
    if "Gated" in cfg.mid_block_type:
        b.add_resnet("mid.resnet.0", mid_ch, mid_ch, hm, False)
        b.add_resnet("mid.resnet.1", mid_ch, mid_ch, hm, False)
        b.add_transformer("mid.attn.0", mid_ch, mid_heads, hm, False,
                          cfg.transformer_layers_at(L - 1))
    else:
        b.other_macs += 2 * _resnet_total(cfg, mid_ch, mid_ch, hm)
        b.other_macs += _transformer_total(cfg, mid_ch, mid_heads, hm,
                                           cfg.transformer_layers_at(L - 1))

    # --- up blocks ---
    rev = list(reversed(cfg.block_out_channels))
    out_ch = rev[0]
    n_up_layers = cfg.layers_per_block + 1
    for i, block_type in enumerate(cfg.up_block_types):
        prev_out = out_ch
        out_ch = rev[i]
        in_ch = rev[min(i + 1, L - 1)]
        level = L - 1 - i
        h = s // (2 ** level)
        is_final = i == L - 1
        gated = "Gated" in block_type
        flags = _depth_flags(block_type, n_up_layers)
        cross = block_type.startswith("CrossAttn")
        heads = cfg.heads_at(level)
        for j in range(n_up_layers):
            skip_ch = in_ch if j == n_up_layers - 1 else out_ch
            cin = (prev_out if j == 0 else out_ch) + skip_ch
            if gated:
                b.add_resnet(f"up.{i}.resnet.{j}", cin, out_ch, h, flags[j])
            else:
                b.other_macs += _resnet_total(cfg, cin, out_ch, h)
        if cross:
            for j in range(n_up_layers):
                if gated:
                    b.add_transformer(f"up.{i}.attn.{j}", out_ch, heads, h, flags[j],
                                      cfg.transformer_layers_at(level))
                else:
                    b.other_macs += _transformer_total(cfg, out_ch, heads, h,
                                                       cfg.transformer_layers_at(level))
        if not is_final:  # upsampler (conv after nearest-2x)
            b.other_macs += _conv_macs(3, out_ch, out_ch, 2 * h, 2 * h)

    # conv_norm_out + conv_act + conv_out
    c0 = cfg.block_out_channels[0]
    b.other_macs += _gn_macs(s * s * c0) + _silu_macs(s * s * c0)
    b.other_macs += _conv_macs(3, c0, cfg.out_channels, s, s)

    return StructureSpec(
        subblocks=tuple(b.subblocks),
        num_width=b.width_cursor,
        num_depth=b.depth_cursor,
        other_macs=b.other_macs,
    )


def _resnet_total(cfg: UNetConfig, cin: int, cout: int, h: int) -> float:
    temb = cfg.time_embed_dim
    total = (
        _gn_macs(h * h * cin)
        + _conv_macs(3, cin, cout, h, h)
        + _linear_macs(1, temb, cout)
        + _gn_macs(h * h * cout)
        + _conv_macs(3, cout, cout, h, h)
    )
    if cin != cout:
        total += _conv_macs(1, cin, cout, h, h)
    return total


def _transformer_total(cfg: UNetConfig, c: int, heads: int, h: int, layers: int = 1) -> float:
    seq = h * h
    total = _gn_macs(seq * c)
    if cfg.use_linear_projection:
        total += 2 * _linear_macs(seq, c, c)
    else:
        total += 2 * _conv_macs(1, c, c, h, h)
    return total + layers * _transformer_layer_total(cfg, c, heads, seq)


def _transformer_layer_total(cfg: UNetConfig, c: int, heads: int, seq: int) -> float:
    head_dim = c // heads
    total = 3 * _ln_macs(seq * c)
    total += 3 * _linear_macs(seq, c, c, bias=False) + _linear_macs(seq, c, c)
    total += _attn_core_macs(seq, heads, head_dim)
    total += _linear_macs(seq, c, c, bias=False)
    total += 2 * _linear_macs(cfg.max_text_len, cfg.cross_attention_dim, c, bias=False)
    total += _attn_core_macs(seq, heads, head_dim)
    total += _linear_macs(seq, c, c)
    inner = c * cfg.ff_mult
    if cfg.gated_ff:
        total += _linear_macs(seq, c, 2 * inner) + _linear_macs(seq, inner, c)
    return total
