"""A step's cost, traced on ``meta`` tensors: the port's counterpart of
XLA's ``compiled.cost_analysis()`` and ``memory_analysis()``.

:class:`CostTrace` is a ``TorchDispatchMode`` under which the cell's real
step (``lm_loss`` with its backward and the optimizer update, ``prefill``,
``decode_step``) runs on ``meta`` tensors: shapes and dtypes, no data, no
device.  For every aten operation it counts

* FLOPs: 2·M·N·K for the matmul family, as ``torch.utils.flop_counter``
  counts them; one an output element for a pointwise operation and one an
  input element for a reduction, as XLA counts them (4 an element for a
  softmax, 3 for its backward);
* bytes: operands read once (a broadcast dimension once) plus outputs
  written (a view moves nothing; a
  write into part of a buffer, ``copy_`` or ``index_put_``, moves the part
  written; a gather of rows, ``index`` or ``embedding``, reads the rows it
  gathers; ``empty`` writes nothing);
* live bytes: every storage the trace allocates, from its first output to
  its release, so :meth:`CostTrace.peak` is the largest sum alive at once.

A model kernel on ``meta`` charges its own work instead
(:mod:`repro_torch.kernels.meta_cost`): what the kernel does, not what its
plain version would.

These are global counts: the whole step, every device's share.
:func:`plan_collectives` gives the per-device collective traffic that a
mesh adds, from the sharding plan (no compiler inserts collectives on
``meta``).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import meta_cost
from ..models.config import (ATTN, DENSE, LOCAL_ATTN, MLA, MOE, RGLRU,
                             RWKV6, BlockSpec, layer_groups)
from ..train.tree import flatten
from .mesh import dp_size
from .roofline import CollectiveStats
from .shardings import Plan, is_spec

__all__ = ["CostTrace", "plan_collectives"]

aten = torch.ops.aten

_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.logsumexp, aten.var, aten.std, aten.prod,
               aten.norm, aten.linalg_vector_norm, aten.argmax, aten.argmin,
               aten.cumsum, aten.var_mean, aten.std_mean, aten.all,
               aten.any}
_SOFTMAX = {aten._softmax: 4, aten._log_softmax: 4,
            aten._softmax_backward_data: 3,
            aten._log_softmax_backward_data: 3}
_EMPTY = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
          aten.new_empty_strided}
# writes into part of a buffer: (name of the written values, of the
# indices or None)
_PART_WRITES = {aten.index_put_: ("values", "indices"),
                aten.index_put: ("values", "indices"),
                aten._index_put_impl_: ("values", "indices"),
                aten.index_copy_: ("source", "index"),
                aten.index_copy: ("source", "index"),
                aten.scatter_: ("src", "index"),
                aten.scatter: ("src", "index"),
                aten.scatter_add_: ("src", "index"),
                aten.scatter_add: ("src", "index"),
                aten.index_add_: ("source", "index"),
                aten.index_add: ("source", "index"),
                aten.copy_: ("src", None),
                aten.slice_scatter: ("src", None),
                aten.select_scatter: ("src", None)}
# reads of some rows of a table: the rows read, the output written
_GATHERS = {aten.index, aten.embedding, aten.index_select, aten.gather,
            aten.take_along_dim}
# writes of a whole buffer that read nothing
_OVERWRITES = {aten.zero_, aten.fill_, aten.uniform_, aten.normal_,
               aten.random_, aten.bernoulli_, aten.exponential_}


def _nbytes(x) -> int:
    """The bytes a tensor's elements span in memory: a broadcast (stride-0)
    dimension is read once, whatever its size."""
    if not isinstance(x, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride:
            n *= size
    return n * x.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in an operation's (nested) arguments or results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostTrace(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage of the operations run under
    it (see the module docstring); ``kernels`` holds each kernel's calls,
    FLOPs and bytes charged on ``meta``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernels: Dict[str, Counter] = {}
        self.ops = 0
        self.region: Optional[str] = None  # set by meta_cost.region
        self._events: List[tuple] = []     # (allocation id, +-bytes, region)
        self._live: Dict[int, tuple] = {}  # storage key -> (id, bytes)
        self._next = 0

    def __enter__(self):
        meta_cost._COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        meta_cost._COUNTERS.remove(self)
        return super().__exit__(*exc)

    # ---- kernels --------------------------------------------------------
    def charge_kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.kernels.setdefault(name, Counter())
        c["calls"] += 1
        c["flops"] += flops
        c["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self.kernel_flops += flops
        self.kernel_bytes += nbytes

    # ---- operations -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops, nbytes = self._count(func, args, kwargs, ins, outs, out)
        self.flops += flops
        self.bytes += nbytes
        held = {_key(t) for t in ins}
        for t in outs:
            if _key(t) not in held:       # a new allocation, not a view
                self._track(t)
        return out

    def _count(self, func, args, kwargs, ins, outs, out):
        packet, pointwise, mutates = _info(func)
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        elif pointwise:
            flops = float(sum(t.numel() for t in outs))
        elif packet in _SOFTMAX:
            flops = float(_SOFTMAX[packet] * outs[0].numel())
        elif packet in _REDUCTIONS:
            first = _tensors(args[:1])
            flops = float(first[0].numel()) if first else 0.0
        else:
            flops = 0.0
        if packet in _EMPTY:
            return flops, 0.0
        if packet in _PART_WRITES:
            vals, idx = _PART_WRITES[packet]
            bound = _bind(func, args, kwargs)
            src = bound.get(vals)
            written = src.numel() * outs[0].element_size() \
                if isinstance(src, torch.Tensor) else 0
            return flops, float(_nbytes(src) + written + sum(
                _nbytes(t) for t in _tensors(bound.get(idx))))
        if packet in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs))
                   if not t.is_floating_point()]
            return flops, float(2 * sum(_nbytes(t) for t in outs)
                                + sum(_nbytes(t) for t in idx))
        if packet in _OVERWRITES:
            return flops, float(sum(_nbytes(t) for t in outs))
        if not mutates and outs and _aliases(outs, ins):
            return flops, 0.0                     # a view: nothing moves
        return flops, float(sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))

    # ---- live storage ---------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        ident, nb = self._next, st.nbytes()
        self._next += 1
        self._live[key] = (ident, nb, self.region)
        self._events.append((ident, nb, self.region))
        weakref.finalize(st, self._free, key, ident)

    def _free(self, key: int, ident: int) -> None:
        got = self._live.get(key)
        if got is not None and got[0] == ident:
            del self._live[key]
            self._events.append((ident, -got[1], got[2]))

    def allocation_ids(self, tensors: Iterable[torch.Tensor]) -> set:
        """The allocations (of this trace) that hold ``tensors``."""
        out = set()
        for t in tensors:
            got = self._live.get(_key(t))
            if got is not None:
                out.add(got[0])
        return out

    def peak(self, exclude: Optional[set] = None, split: float = 1.0,
             region_split: Optional[Dict[str, float]] = None) -> float:
        """The most bytes the trace's allocations held at once, leaving
        out the allocations ``exclude`` (the step's outputs, say), each
        divided by ``split`` (the devices it is spread over), or by
        ``region_split[region]`` for one allocated in a tagged region."""
        exclude = exclude or set()
        region_split = region_split or {}
        cur = best = 0.0
        for ident, nb, region in self._events:
            if ident not in exclude:
                cur += nb / region_split.get(region, split)
                best = max(best, cur)
        return best


def _bind(func, args, kwargs) -> Dict[str, Any]:
    names = [a.name for a in func._schema.arguments]
    out = dict(zip(names, args))
    out.update(kwargs)
    return out


_INFO: Dict[Any, tuple] = {}


def _info(func) -> tuple:
    """(overload packet, pointwise, writes an argument) of an operation."""
    got = _INFO.get(func)
    if got is None:
        got = _INFO[func] = (
            func.overloadpacket, torch.Tag.pointwise in func.tags,
            any(a.alias_info is not None and a.alias_info.is_write
                for a in func._schema.arguments))
    return got


def _aliases(outs, ins) -> bool:
    keys = {_key(t) for t in ins}
    return any(_key(t) in keys for t in outs)


# --------------------------------------------------------------------------- #
# collectives from the plan                                                    #
# --------------------------------------------------------------------------- #
def _dtype_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _mixer_sharded(plan: Plan, spec: BlockSpec) -> bool:
    """Whether a layer's mixer ends in a ``model``-sharded (row-parallel)
    projection, so its output is a partial sum to reduce."""
    if spec.kind in (ATTN, LOCAL_ATTN, MLA):
        return plan.rules.get("heads") == "model"
    if spec.kind == RGLRU:
        return plan.rules.get("lru") == "model"
    return False            # RWKV6's time mix: rwkv_d2 has no rule


def _on(spec, axis: str) -> bool:
    return any(axis in ((d,) if isinstance(d, str) else (d or ()))
               for d in spec)


def _local_bytes(plan: Plan, p, spec) -> int:
    n = 1
    for d in plan.local_shape(tuple(p.shape), spec):
        n *= d
    return n * p.element_size()


def _model_gathered(plan: Plan, sub, sub_specs, count: int = 1) -> float:
    """Bytes of the ``model``-sharded leaves of a parameter subtree,
    gathered over ``model``, for one of its ``count`` stacked layers."""
    m = plan.mesh.shape["model"]
    total = sum(_local_bytes(plan, p, spec) * m
                for p, spec in zip(flatten(sub)[0],
                                   flatten(sub_specs, is_spec)[0])
                if _on(spec, "model"))
    return total / count


def plan_collectives(plan: Plan, kind: str, B: int, T: int, dtype,
                     params: Any, param_specs: Any, remat: bool = True,
                     S_cache: int = 0, S_enc: int = 0) -> CollectiveStats:
    """Per-device collective traffic of one step of ``kind`` ("train",
    "prefill", "decode"; T = 1 for decode) under ``plan``: the layout the
    reference's docstring names (``launch/shardings.py``), in the forms
    the reference's partitioner gave it on the reduced cells (their HLO).
    A layer term counts once for the forward, twice more in a train step
    and once more under remat ("reps"); a weight gather once a pass that
    reads the weights (forward, remat, backward).

    * Each use of ``model``-sharded weights (a layer's mixer, its MLP;
      the embedding and the head in prefill and decode) takes the cheaper
      of moving the activations — an all-reduce of the (B_local, T, D)
      output of a row-parallel projection, under SP (T > 1) a
      reduce-scatter plus an all-gather — and gathering the weights over
      ``model``, with a reduce-scatter of their gradient.
    * Attention under SP gathers its queries along the sequence each pass
      and reduce-scatters their gradient; keys and values stay in their
      shards.
    * A recurrence under SP (the WKV, the RG-LRU) moves its inputs from
      the sequence onto its heads or channels (an all-to-all; an
      all-gather when they do not divide ``model``); the projection after
      it then contracts a sharded axis: a reduce-scatter and an
      all-gather of its output.
    * EP: each device runs its experts over every token of its routing
      groups, and the combine all-reduces each token's k routed rows and
      their sum (not the all-to-all the docstring names).
    * A train step with a ``model``-sharded vocabulary keeps the tables in
      their shards: the embedding rows' all-reduce and their gradient's
      all-gather, the logits' input gathered, their max, sum and gold
      logit reduced, the input's gradient all-reduced.
    * A decode over caches sharded on their sequence: the partial-softmax
      all-reduce of each attention layer's output, max and sum.
    * FSDP: an all-gather of every ``data``-sharded weight each forward
      and again in the backward, a reduce-scatter of its gradient; every
      other gradient leaf all-reduced over dp (ZeRO-1 / DP)."""
    cfg, mesh = plan.cfg, plan.mesh
    m = mesh.shape["model"]
    dp = dp_size(mesh)
    Bl = B // dp if B % dp == 0 else B
    ab = _dtype_bytes(dtype)
    D = cfg.d_model
    train = kind == "train"
    reps = 1 if not train else (4 if remat else 3)
    passes = 1 if not train else (3 if remat else 2)
    seq = kind != "decode" and plan.sp
    stats = CollectiveStats()

    def payload(ops):
        probe = CollectiveStats()
        for op in ops:
            probe.add(*op)
        return probe.payload_bytes

    def cheaper(act_ops, gathered):
        wt_ops = [("all-gather", gathered, m)] * passes
        if train:
            wt_ops.append(("reduce-scatter", gathered / m, m))
        ops = act_ops if (not gathered or payload(act_ops)
                          <= payload(wt_ops)) else wt_ops
        for op in ops:
            stats.add(*op)

    def block(Tb, sharded, gathered):
        X = Bl * Tb * D * ab
        if sharded:
            one = ([("reduce-scatter", X / m, m), ("all-gather", X, m)]
                   if seq else [("all-reduce", X, m)])
            cheaper(one * reps, gathered)

    def q_gather(Tq, width):
        # width: elements a token over every head
        if not seq:
            return
        q = Bl * Tq * width * ab
        for _ in range(passes):
            stats.add("all-gather", q, m)
        if train:
            stats.add("reduce-scatter", q / m, m)

    def recurrence(Tb, width, heads):
        # width: its inputs' bytes a token; returns whether it took the heads
        if not seq:
            return False
        split = heads % m == 0
        X = Bl * Tb * D * ab
        for _ in range(reps):
            if split:
                stats.add("all-to-all", Bl * Tb * width / m, m)
                stats.add("reduce-scatter", X / m, m)
                stats.add("all-gather", X, m)
            else:
                stats.add("all-gather", Bl * Tb * width, m)
        return split

    def moe_block(Tb):
        rows = Bl * Tb * (cfg.top_k + 1) * D * ab
        group = dp * m if plan.ep2 else m
        for _ in range(reps):
            stats.add("all-reduce", rows, group)

    def decode_reduce(spec: BlockSpec, cross_frames):
        H = cfg.n_heads
        widths = []
        if spec.kind == ATTN and S_cache % m == 0:
            widths.append(cfg.head_dim)
        if spec.kind == LOCAL_ATTN and min(S_cache, cfg.window) % m == 0:
            widths.append(cfg.head_dim)
        if spec.kind == MLA and S_cache % m == 0:
            widths.append(cfg.kv_lora_rank)
        if spec.cross_attn and cross_frames and cross_frames % m == 0:
            widths.append(cfg.head_dim)
        for width in widths:
            stats.add("all-reduce", Bl * H * (width + 2) * 4, m)

    def layer(spec: BlockSpec, p, ps, count, Tb, cross_frames=0):
        H, hd = cfg.n_heads, cfg.head_dim
        mix_w = _model_gathered(plan, p["mix"], ps["mix"], count)
        if spec.kind in (ATTN, LOCAL_ATTN):
            q_gather(Tb, H * hd)
        elif spec.kind == MLA:
            q_gather(Tb, H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        if spec.kind == RWKV6:
            # the time mix: r, k, v (and w in fp32) onto the heads; the
            # channel mix: an MLP over d_ff
            d = H * cfg.rwkv_head_dim
            recurrence(Tb, 3 * d * ab + 4 * d, H)
            block(Tb, plan.rules.get("d_ff") == "model", mix_w)
        elif spec.kind == RGLRU:
            # a and b in fp32 onto the channels; or, without SP, the
            # row-parallel w_out of a sharded width
            if not recurrence(Tb, 8 * cfg.lru_width, cfg.lru_width):
                block(Tb, _mixer_sharded(plan, spec), mix_w)
        else:
            block(Tb, _mixer_sharded(plan, spec), mix_w)
        if spec.kind != RWKV6:
            if spec.cross_attn:
                q_gather(Tb, H * hd)
                block(Tb, plan.rules.get("heads") == "model",
                      _model_gathered(plan, p["cross"], ps["cross"], count))
            w = _model_gathered(plan, p["mlp"], ps["mlp"], count)
            if spec.mlp == MOE and plan.ep:
                moe_block(Tb)
            else:
                sharded = (plan.rules.get("d_ff") == "model"
                           if spec.mlp != MOE else
                           plan.rules.get("d_expert") == "model"
                           or plan.rules.get("d_shared") == "model")
                block(Tb, sharded, w)
        if kind == "decode":
            decode_reduce(spec, cross_frames)

    T_dec = 1 if kind == "decode" else T
    groups = layer_groups(cfg)
    for (spec, count), p, ps in zip(groups, params["groups"],
                                    param_specs["groups"]):
        for _ in range(count):
            layer(spec, p, ps, count, T_dec, S_enc)
    if cfg.is_encdec and kind != "decode":
        enc, enc_s = params["enc"]["groups"][0], param_specs["enc"]["groups"][0]
        for _ in range(cfg.encoder_layers):
            layer(BlockSpec(ATTN, DENSE), enc, enc_s, cfg.encoder_layers,
                  S_enc)
    if cfg.mtp and train:
        layer(BlockSpec(ATTN, DENSE), params["mtp"]["block"],
              param_specs["mtp"]["block"], 1, T - 2)

    if plan.rules.get("vocab") == "model":
        embed = _model_gathered(plan, params["embed"], param_specs["embed"])
        head = (embed if cfg.tie_embeddings else
                _model_gathered(plan, params["head"], param_specs["head"]))
        if train:
            # the tables stay in their shards, where their gradients land
            X = Bl * T * D * ab
            stats.add("all-reduce", X, m)          # the embedding's rows
            stats.add("all-gather", X, m)          # ... their gradient
            stats.add("all-gather", X, m)          # the logits' input
            for _ in range(3):                     # max, sum, gold logit
                stats.add("all-reduce", Bl * (T - 1) * 4, m)
            stats.add("all-reduce", X, m)          # the input's gradient
        else:
            cheaper([("all-reduce", Bl * T_dec * D * ab, m)], embed)
            cheaper([("all-gather", Bl * cfg.vocab * ab, m)], head)

    # weights over data: FSDP gathers, gradient reductions
    dsz = mesh.shape.get("data", 1)
    for p, spec in zip(flatten(params)[0], flatten(param_specs, is_spec)[0]):
        nb = _local_bytes(plan, p, spec)
        if plan.fsdp and _on(spec, "data"):
            for _ in range(2 if train else 1):
                stats.add("all-gather", nb * dsz, dsz)
            if train:
                stats.add("reduce-scatter", nb, dsz)
        elif train and dp > 1:
            stats.add("all-reduce", nb, dp)
    return stats
