"""Prepared serving programs: the denoise trajectory as captured CUDA graphs.

The port's counterpart of the JAX package's `pipelines/aot.py`. The JAX
package runs each serving stage as one compiled program and dispatches a
request to the program prepared for its operands' abstract signature
(`ShapeDispatch`). The port's prepared program is a `torch.cuda.CUDAGraph`
of the whole CFG sampler loop (`capture`): the U-Net's launches of every
step, the CFG combination and the sampler's updates, replayed with one host
call instead of issued one by one.

What carries over and what does not:

- `signature` and `ShapeDispatch` keep the JAX module's names and
  semantics: a dispatch key hashes the operands only (`args[1:]`), never the
  leading model, and an unseen signature runs the fallback.
- A graph holds this process's device addresses (its static input buffers,
  its memory pool, the weights and the packed conv weights it read, the TMA
  tensor maps the kernels encoded at capture), so it cannot be written to
  disk as a JAX export is: there is no `program_path`, `try_load` or
  `export_to`. What a restart keeps is the kernel libraries, cached in
  `build/torch_kernels/` by source hash (`ops/build.py`).
- A program reads the weights it was captured on: after a weight changes
  (a reload, an optimizer step), capture again.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from diffusion_pruning_tpu_torch.ops import flash_attention as _fa
from diffusion_pruning_tpu_torch.ops import group_norm as _gn
from diffusion_pruning_tpu_torch.ops import norm_conv as _nc

# every kernel wrapper's launch count (`.launches`); the forward kernels are
# also counted apart in `ops.flash_attention.forward_launches`
COUNTED_WRAPPERS = (_fa.gated_flash_attention, _fa.gated_flash_forward_lse,
                    _fa.gated_flash_bwd_fused, _fa.gated_flash_bwd_reduce, _fa.gated_flash_bwd_dq,
                    _fa.gated_flash_bwd_dkv, _gn.group_norm_silu_forward, _nc.norm_conv3x3,
                    _nc.conv_split_reduce, _nc.norm_linear)


def signature(args) -> str:
    """Stable hash of a call's abstract signature: the tree's structure, and
    each tensor leaf's shape, dtype, device, layout and strides; other leaves
    by repr."""
    leaves, treedef = pytree.tree_flatten(args)
    parts = [str(treedef)]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            parts.append(f"{tuple(x.shape)}:{x.dtype}:{x.device}:{x.layout}:{x.stride()}")
        else:
            parts.append(repr(x))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by wrapper name, and each forward
    kernel's (`ops.flash_attention.forward_launches`)."""
    counts = {fn.__name__: fn.launches for fn in COUNTED_WRAPPERS}
    counts.update(_fa.forward_launches)
    return counts


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    for fn in COUNTED_WRAPPERS:
        fn.launches += sign * delta[fn.__name__]
    for name in _fa.forward_launches:
        _fa.forward_launches[name] += sign * delta[name]


class CapturedProgram:
    """`fn` at one operand signature, as one CUDA graph (`capture` builds it).

    A call copies its tensor operands into the graph's static input buffers,
    replays the graph on the current stream and returns fresh copies of the
    outputs, so the next replay never overwrites what a caller holds. Its
    other operands (the model, None) must be the objects it was captured
    with. The kernel wrappers count their launches on the host, where a
    replay issues none: each replay adds the launches the capture recorded.
    Replays hold `lock`, which programs that share a memory pool share, so
    two of them never run at once (`ServingQueue.flush_async` replays on a
    thread of its own)."""

    def __init__(self, fn: Callable, args: tuple, pool=None,
                 lock: Optional[threading.Lock] = None, warm: Optional[Callable] = None):
        leaves, self._treedef = pytree.tree_flatten(tuple(args))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not tensors:
            raise ValueError("capture needs at least one tensor operand")
        off_card = sorted({str(x.device) for x in tensors if x.device.type != "cuda"})
        if off_card:
            raise ValueError(f"capture takes CUDA tensors only, got tensors on {off_card}: "
                             "a CPU program runs eagerly")
        device = tensors[0].device
        self.lock = lock or threading.Lock()
        with torch.inference_mode(False), torch.no_grad():
            self._static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        call_args = pytree.tree_unflatten(self._static, self._treedef)
        # one eager run on a side stream: the lazy work (kernel builds and
        # library loads, packed conv weights, per-device tables) happens
        # outside the graph
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (warm or fn)(*call_args)
        torch.cuda.current_stream(device).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            out = fn(*call_args)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        _add_launches(self.launches, -1)  # the capture recorded them; nothing ran
        self._out = out
        self.replays = 0

    def __call__(self, *args):
        leaves, treedef = pytree.tree_flatten(tuple(args))
        if treedef != self._treedef:
            raise ValueError("operands of another structure than the captured ones")
        with self.lock:
            for static, x in zip(self._static, leaves):
                if isinstance(static, torch.Tensor):
                    static.copy_(x)
                elif static is not x and static != x:
                    raise ValueError(f"operand {x!r} differs from the captured {static!r}")
            self.graph.replay()
            _add_launches(self.launches)
            self.replays += 1
            return pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, self._out)


def capture(fn: Callable, args: tuple, pool=None, lock: Optional[threading.Lock] = None,
            warm: Optional[Callable] = None) -> CapturedProgram:
    """`fn(*args)` captured as a CUDA graph at the operands' signature, after
    one eager warm run on a side stream: of `fn`, or of `warm` (the same
    operands), a shorter call that does the same lazy work, such as one step
    of a trajectory. `pool` (`torch.cuda.graph_pool_handle()`) lets programs
    share one memory pool; give them one `lock` then. Raises on CPU
    tensors."""
    return CapturedProgram(fn, args, pool=pool, lock=lock, warm=warm)


class ShapeDispatch:
    """Dispatch a call to the program prepared for its operands' exact
    signature; fall back to `fallback` for any other. Drop-in replacement for
    a pipeline's cached denoise function (the calling convention
    `(model, *operands)`). Keys hash only the operands (`args[1:]`): the
    leading model is constant for a pipeline. `hits` counts the calls that
    ran a prepared program and `misses` those that fell back."""

    def __init__(self, fallback: Callable):
        self.fallback = fallback
        self._by_sig: Dict[str, Callable] = {}
        self.hits = 0
        self.misses = 0

    def add(self, args, fn: Callable) -> None:
        self._by_sig[signature(args[1:])] = fn

    def __call__(self, *args):
        fn = self._by_sig.get(signature(args[1:]))
        if fn is not None:
            self.hits += 1
            return fn(*args)
        self.misses += 1
        return self.fallback(*args)

    @property
    def programs(self):
        """The prepared programs, in the order they were added."""
        return list(self._by_sig.values())
