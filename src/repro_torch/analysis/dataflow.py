"""GBA-FLOW: the staleness-taint pass over the port's eager steps.

Counterpart of ``repro.analysis.dataflow``.  The reference interprets a
traced jaxpr; the port has none, so :class:`FlowMode`, a
``TorchDispatchMode``, runs the audited step itself on the CPU (at
``.reduced()`` size) and keeps a tag set from the reference's lattice for
each tensor *storage*::

    raw        per-token gradient before Eq. (1) weighting
    decayed    gradient after a decay-mask multiply (sanitized)
    residual   quantization error-feedback state
    decay_mask the Eq. (1) weight ((gstep - tokens) <= iota)
    pad_mask   a validity mask derived from comparing ids to a bound
    token      per-slot token (arrival order) values
    step       the global step counter
    ids        embedding-row indices
    param      optimizer state (params / accumulators / f32 master)

Tags live on storages, not on tensor objects: the fused step writes its
buffer row by row (``core.gba.flat_buffer_push``) and its params and
accumulator through ``copy_`` (``kernels.gba_apply``), writes that tags
kept on the tensor objects would lose.  A view shares its base's tags; an
operator that writes its whole storage sets the storage's tags, one that
writes part of it adds to them.  Every operator, the backward's included
(``torch.autograd.grad`` dispatches through the mode), propagates the
union of its inputs' tags, with the reference's transfer rules:

* a comparison with a ``token`` operand makes a ``decay_mask`` (the
  reference asks for ``token`` and ``step``; the port passes the global
  step as a Python int, ``kernels.gba_apply``, ``kernels.ref``,
  ``core.gba.decay_weights``, which carries no tag); a comparison of
  ``ids`` against an untagged bound makes a ``pad_mask``;
* a multiply of a ``raw``/``decayed`` value by a ``decay_mask`` operand
  (one that is neither ``raw`` nor ``decayed`` itself), or a ``where``
  selected by one, *sanitizes*: ``raw`` is cleared, ``decayed`` added,
  and the mask's per-slot weights are recorded.  The step really runs, so
  the weights are the ones it used: the values of the slot-shaped mask
  the operand was derived from (FLOW-002 proves a tombstone's weight is
  exactly 0.0 from them, where the reference forward-evaluates its
  jaxpr);
* a division of a ``raw``/``decayed`` numerator records its divisor's
  tags and whether it is a constant (FLOW-005).

The kernel wrappers run their plain versions on CPU tensors inside
``kernels.runtime.plain_region``.  ``quantize_minmax`` and
``quantize_sign`` are the one sanctioned producer of ``residual``: on
leaving their region every storage made inside it (the codes, the
sidebands) drops the tag, and the payload, which the wrapper overwrites
with the next residual in place, keeps it.

Checks (see ``rules.RULES`` for the contracts):

* **FLOW-001** no ``raw`` tag on a params/optimizer-state output;
* **FLOW-002** every recorded per-slot weight is 0.0 for stale slots and
  nonzero for fresh ones;
* **FLOW-003** no ``residual`` tag on a params/optimizer-state output;
* **FLOW-004** no sub-f32 float arithmetic on ``decayed`` values, and
  every narrowing convert of one to a sub-f32 float is terminal: only
  data movement and copies may read it (a float64 -> float32 convert of
  the plain versions, which copy XLA's fused multiply-add in float64, is
  not a narrowing to a sub-f32 float);
* **FLOW-005** a gradient aggregate is divided by a divisor carrying both
  ``pad_mask`` and ``decay_mask`` (never by a constant).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.rules import Finding, finding
from repro_torch.kernels import runtime

# tags -------------------------------------------------------------------
RAW = "raw"
DECAYED = "decayed"
RESIDUAL = "residual"
DECAY_MASK = "decay_mask"
PAD_MASK = "pad_mask"
TOKEN = "token"
STEP = "step"
IDS = "ids"
PARAM = "param"

MAX_CONCRETE = 1 << 16   # cap on the recorded per-slot weights (elements)


@dataclass(frozen=True)
class Taint:
    """The tag set of one tensor's storage."""

    tags: frozenset


EMPTY = Taint(frozenset())


def taint(*tags) -> Taint:
    return Taint(frozenset(tags))


@dataclass
class FlowContext:
    """Events recorded while one step runs under :class:`FlowMode`."""

    site: str
    slots: int = 1            # M: the length of a per-slot weight vector
    sanitize_masks: list = field(default_factory=list)  # np arrays or None
    div_events: list = field(default_factory=list)      # (num_tags, den_tags,
    #                                                      den_is_const)
    findings: list = field(default_factory=list)
    f32_chain: bool = False   # enable FLOW-004


_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}

_ARITH = {"add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg",
          "abs", "mm", "bmm", "addmm", "matmul", "sum", "mean", "amax",
          "amin", "sqrt", "rsqrt", "exp", "log", "pow", "remainder", "sign",
          "tanh", "sigmoid", "erf", "cumsum", "cumprod", "addcmul",
          "addcdiv", "lerp", "fmod", "reciprocal", "square"}

# what a terminal downcast may feed: data movement and copies
_TERMINAL_OK = {"view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
                "slice", "select", "as_strided", "t", "transpose", "permute",
                "unsqueeze", "squeeze", "unbind", "split", "split_with_sizes",
                "alias", "detach", "copy", "_to_copy", "clone", "cat",
                "stack", "flip", "index_put", "slice_scatter",
                "select_scatter", "narrow", "unfold"}


def _base(func) -> str:
    """The operator's name without its in-place ``_`` (``add_`` ->
    ``add``)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        return name[:-1]
    return name


def _narrow_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point and t.element_size() < 4


class FlowMode(TorchDispatchMode):
    """Run a step with a tag set on every tensor storage (see the module
    docstring); events go to ``ctx``."""

    def __init__(self, ctx: FlowContext):
        super().__init__()
        self.ctx = ctx
        self._tags = WeakIdKeyDictionary()
        self._weights = WeakIdKeyDictionary()   # storage -> per-slot np
        self._narrowed = WeakIdKeyDictionary()
        self._made: list[list] = []             # storages made per region

    # -- seeds and reads --------------------------------------------------

    def seed(self, t: torch.Tensor, tags: frozenset) -> None:
        st = t.untyped_storage()
        self._tags[st] = self._tags.get(st, frozenset()) | tags

    def tags(self, t: torch.Tensor) -> frozenset:
        return self._tags.get(t.untyped_storage(), frozenset())

    def enter_region(self, name: str) -> None:
        self._made.append([])

    def exit_region(self, name: str) -> None:
        made = self._made.pop()
        if name.startswith("quantize_"):
            for ref in made:
                st = ref()
                if st is not None and st in self._tags:
                    self._tags[st] = self._tags[st] - {RESIDUAL}
        elif self._made:
            self._made[-1].extend(made)

    # -- transfer rules -----------------------------------------------------

    def _slot_weights(self, t: torch.Tensor):
        w = self._weights.get(t.untyped_storage())
        if w is None and t.numel() == self.ctx.slots:
            w = t.detach().double().reshape(-1).numpy().copy()
        return w

    def _sanitize(self, mask: torch.Tensor, out_tags: frozenset
                  ) -> frozenset:
        self.ctx.sanitize_masks.append(self._slot_weights(mask))
        return (out_tags - {RAW}) | {DECAYED}

    @staticmethod
    def _is_mask(tags: frozenset) -> bool:
        return DECAY_MASK in tags and not tags & {RAW, DECAYED}

    def _transfer(self, base: str, ins: list, in_tags: list,
                  out_tags: frozenset) -> frozenset:
        if base in _CMP:
            if TOKEN in out_tags:
                out_tags = out_tags | {DECAY_MASK}
            if IDS in out_tags and (len(ins) < 2
                                    or any(not t for t in in_tags)):
                # ids against a literal / untagged bound: the validity
                # (padding / capacity) mask
                out_tags = out_tags | {PAD_MASK}
        elif base == "mul" and len(ins) == 2:
            for data, mask in ((0, 1), (1, 0)):
                if self._is_mask(in_tags[mask]) and \
                        in_tags[data] & {RAW, DECAYED}:
                    return self._sanitize(ins[mask], out_tags)
        elif base == "where" and ins:
            if self._is_mask(in_tags[0]) and any(
                    t & {RAW, DECAYED} for t in in_tags[1:]):
                return self._sanitize(ins[0], out_tags)
        elif base == "div" and in_tags and in_tags[0] & {RAW, DECAYED}:
            den = in_tags[1] if len(ins) > 1 else frozenset()
            self.ctx.div_events.append((in_tags[0], den, not den))
        return out_tags

    def _flow_004(self, base: str, name: str, ins: list, outs: list,
                  out_tags: frozenset) -> None:
        ctx = self.ctx
        read_narrowed = any(t.untyped_storage() in self._narrowed
                            for t in ins)
        if read_narrowed and base not in _TERMINAL_OK:
            ctx.findings.append(finding(
                "GBA-FLOW-004", ctx.site,
                f"narrowed update value feeds '{name}' — the downcast "
                f"must be the final op of the update chain"))
            self._narrowed = WeakIdKeyDictionary()   # one finding a chain
            return
        if DECAYED not in out_tags:
            return
        if base in _ARITH and any(_narrow_float(t) for t in ins + outs):
            ctx.findings.append(finding(
                "GBA-FLOW-004", ctx.site,
                f"'{name}' on a decayed-gradient value uses "
                f"{next(t.dtype for t in ins + outs if _narrow_float(t))} "
                f"— the update chain must stay f32 until the final "
                f"downcast"))
            return
        src = ins[-1] if base == "copy" else (ins[0] if ins else None)
        narrowing = (base in ("_to_copy", "copy") and src is not None
                     and src.dtype.is_floating_point
                     and not _narrow_float(src)
                     and any(_narrow_float(t) for t in outs))
        if narrowing or read_narrowed:
            for t in outs:
                self._narrowed[t.untyped_storage()] = True

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        in_tags = [self.tags(t) for t in ins]
        out_tags = frozenset().union(*in_tags)
        base = _base(func)
        out_tags = self._transfer(base, ins, in_tags, out_tags)
        if self.ctx.f32_chain:
            self._flow_004(base, func.overloadpacket.__name__, ins, outs,
                           out_tags)
        in_st = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            new = id(st) not in in_st
            whole = t.is_contiguous() and \
                t.numel() * t.element_size() == st.nbytes()
            if whole or st not in self._tags:
                self._tags[st] = out_tags
            else:
                self._tags[st] = self._tags[st] | out_tags
            if new and self._made:
                self._made[-1].append(weakref.ref(st))
            if new and DECAY_MASK in out_tags:
                self._inherit_weights(t, st, ins, in_tags)
        return out

    def _inherit_weights(self, t, st, ins, in_tags) -> None:
        if t.numel() == self.ctx.slots:
            self._weights[st] = t.detach().double().reshape(-1).numpy()
            return
        for x, tg in zip(ins, in_tags):
            w = self._weights.get(x.untyped_storage())
            if DECAY_MASK in tg and w is not None:
                self._weights[st] = w
                return


# -- seeds and the run ------------------------------------------------------

def flatten_with_paths(tree: Any, prefix: str = "") -> list:
    """``(path, tensor)`` for every tensor of nested dicts (keys sorted,
    as ``core.gba.tree_paths`` walks them), lists and tuples, paths in
    ``jax.tree_util.keystr`` form (``"['params']['embed']"``); other
    leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pt for k in sorted(tree)
                for pt in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pt for i, v in enumerate(tree)
                for pt in flatten_with_paths(v, f"{prefix}[{i}]")]
    return []


def out_paths(tree: Any) -> list[str]:
    """Tensor paths of a result, aligned with :func:`analyze`'s taints."""
    return [p for p, _ in flatten_with_paths(tree)]


def seed_taints(args: tuple, specs) -> list:
    """``(tensor, Taint)`` for every tensor of ``args``, one spec per
    positional arg: ``specs[i]`` is a :class:`Taint` applied to every
    tensor of ``args[i]``, or a callable ``(path_str, tensor) ->
    Taint``."""
    if len(args) != len(specs):
        raise ValueError(f"one spec per positional arg: {len(specs)} specs "
                         f"for {len(args)} args")
    out = []
    for arg, spec in zip(args, specs):
        for path, t in flatten_with_paths(arg):
            out.append((t, spec(path, t) if callable(spec) else spec))
    return out


def analyze(fn: Callable, args: tuple, specs, *, site: str,
            f32_chain: bool = False, slots: int = 1):
    """Run ``fn(*args)`` under :class:`FlowMode` with ``args``' storages
    seeded by ``specs`` (:func:`seed_taints`).  Returns ``(result,
    out_taints, ctx)``: the tag set of each tensor of the result in
    :func:`out_paths` order, and the recorded events (FLOW-004 findings
    in ``ctx.findings``); ``slots`` is the length of a per-slot weight
    vector (the buffer's M)."""
    seeds = seed_taints(args, specs)
    ctx = FlowContext(site=site, slots=slots, f32_chain=f32_chain)
    mode = FlowMode(ctx)
    for t, tn in seeds:
        mode.seed(t, tn.tags)
    with runtime.observe(mode), mode:
        result = fn(*args)
    outs = [Taint(mode.tags(t)) for _, t in flatten_with_paths(result)]
    return result, outs, ctx


# -- checks --------------------------------------------------------------

def check_no_raw(out_taints, paths, guard, site) -> list[Finding]:
    """FLOW-001 over the update-state outputs selected by ``guard``
    (a predicate over the output path)."""
    out = []
    for t, p in zip(out_taints, paths):
        if guard(p) and RAW in t.tags:
            out.append(finding(
                "GBA-FLOW-001", site,
                f"raw per-token gradient reaches update output '{p}' "
                f"without passing the Eq. (1) decay multiply"))
    return out


def check_no_residual(out_taints, paths, guard, site) -> list[Finding]:
    """FLOW-003 over the update-state outputs selected by ``guard``."""
    out = []
    for t, p in zip(out_taints, paths):
        if guard(p) and RESIDUAL in t.tags:
            out.append(finding(
                "GBA-FLOW-003", site,
                f"error-feedback residual reaches update output '{p}' — "
                f"the residual may only feed the next quantize"))
    return out


def check_tombstone(ctx, stale_rows, site) -> list[Finding]:
    """FLOW-002: every recorded per-slot weight vector must weight the
    stale slots (``stale_rows`` bool array, length M) EXACTLY 0.0 and
    the fresh slots nonzero."""
    stale_rows = np.asarray(stale_rows, dtype=bool)
    m = stale_rows.size
    out = []
    concrete = [w for w in ctx.sanitize_masks if w is not None]
    if not concrete:
        out.append(finding(
            "GBA-FLOW-002", site,
            "no concretely-evaluable decay mask found on the update path "
            "— tombstone weights cannot be proven exactly zero"))
        return out
    for w in concrete:
        flat = np.asarray(w, dtype=np.float64).reshape(-1)
        if flat.size % m:
            continue                     # mask not per-slot shaped
        per_slot = flat.reshape(m, -1)
        bad_stale = stale_rows & np.any(per_slot != 0.0, axis=1)
        bad_fresh = (~stale_rows) & np.all(per_slot == 0.0, axis=1)
        if bad_stale.any():
            out.append(finding(
                "GBA-FLOW-002", site,
                f"tombstone slot(s) {np.where(bad_stale)[0].tolist()} get "
                f"nonzero decay weight "
                f"{per_slot[bad_stale].reshape(-1)[:4].tolist()} — the "
                f"contract is weight EXACTLY 0, not just small"))
            break
        if bad_fresh.any():
            out.append(finding(
                "GBA-FLOW-002", site,
                f"fresh slot(s) {np.where(bad_fresh)[0].tolist()} get "
                f"decay weight 0 — live gradients must not be dropped"))
            break
    return out


def check_divisor(ctx, site) -> list[Finding]:
    """FLOW-005: some divide of a gradient aggregate must exist, and
    every such divide's divisor must carry both masks."""
    out = []
    grad_divs = [(n, d, const) for n, d, const in ctx.div_events
                 if RAW in n or DECAYED in n]
    if not grad_divs:
        out.append(finding(
            "GBA-FLOW-005", site,
            "no divide of the gradient aggregate found — the mean over "
            "contributors is missing"))
        return out
    for _, den, const in grad_divs:
        if const or PAD_MASK not in den or DECAY_MASK not in den:
            have = sorted(den & {PAD_MASK, DECAY_MASK})
            out.append(finding(
                "GBA-FLOW-005", site,
                "aggregate divisor is "
                + ("a constant" if const else f"masked only by {have}")
                + " — the divisor must count exactly the valid "
                "(non-padding, non-tombstone) contributors"))
            break
    return out


# -- audited sites -------------------------------------------------------

def _wire_spec(path: str, t) -> Taint:
    return taint(RESIDUAL) if "residual" in path else taint(RAW)


def flow_fused_step(step: Callable, args: tuple, *, site: str
                    ) -> list[Finding]:
    """FLOW-001 (and FLOW-003 when the wire state is passed) on the
    layer-grouped fused psum step (``core.gba_shard_map``): ``args`` are
    ``(param_flat, accum_flat, batch, tokens, gstep[, wire])``; the
    outputs ``(param_flat, accum_flat, loss[, wire])``."""
    specs = [taint(PARAM), taint(PARAM), taint(RAW), taint(TOKEN),
             EMPTY, _wire_spec][:len(args)]
    _, outs, _ = analyze(step, args, specs, site=site)
    paths = ["new_param_flat", "new_accum_flat"]
    guard = lambda p: True
    return (check_no_raw(outs[:2], paths, guard, site)
            + check_no_residual(outs[:2], paths, guard, site))


def _tomb_tokens(m: int, step: int, iota: int) -> np.ndarray:
    """Buffer token seeds with one tombstone slot (index 1: staler than
    ``iota`` by exactly one — the Alg. 1 excluded-slot encoding) among
    fresh slots; slot m-1 is overwritten by the pushed token."""
    tokens = np.full((m,), step, dtype=np.int32)
    if m > 1:
        tokens[1] = step - iota - 1
    tokens[m - 1] = 0        # replaced by the push before the apply
    return tokens


def flow_fused_train_step(step: Callable, state: dict, batch: dict, *,
                          site: str, m: int, iota: int,
                          f32_chain: bool = True,
                          step_seed: int = 9) -> list[Finding]:
    """FLOW-001/002/004 on the single-host fused train step
    (``launch.programs.make_fused_train_step``).  The buffer is set at
    fill m-1 with the tokens of :func:`_tomb_tokens` and ``step_seed``,
    so the push of ``step_seed`` fills it and the apply weighs one
    tombstone slot among fresh ones.  ``state`` is consumed (the step
    writes it in place)."""
    buf = state["buffer"]
    buf["tokens"].copy_(torch.from_numpy(_tomb_tokens(m, step_seed, iota)))
    buf["fill"], buf["step"] = m - 1, step_seed

    def state_spec(path, t):
        if "tokens" in path:
            return taint(TOKEN)
        if "grads" in path:
            return taint(RAW)
        return taint(PARAM)          # params + accum

    token = torch.tensor(step_seed, dtype=torch.int32)
    result, outs, ctx = analyze(step, (state, batch, token),
                                [state_spec, taint(RAW), taint(TOKEN)],
                                site=site, f32_chain=f32_chain, slots=m)
    paths = out_paths(result)
    guard = lambda p: ("params" in p or "accum" in p)
    final_tokens = _tomb_tokens(m, step_seed, iota)
    final_tokens[m - 1] = step_seed
    stale = (step_seed - final_tokens) > iota
    return (check_no_raw(outs, paths, guard, site)
            + check_tombstone(ctx, stale, site)
            + list(ctx.findings))


def flow_pytree_step(step: Callable, make_state: Callable, batch: dict, *,
                     site: str, m: int, iota: int,
                     step_seed: int = 9) -> list[Finding]:
    """FLOW-001/002 on the per-leaf pytree train step
    (``launch.programs.make_train_step``), at its applying microstep (micro
    m-1).  One token per microstep, so the step runs twice, each on a
    fresh state from ``make_state()``: a tombstone token must weigh
    exactly 0, a fresh one nonzero.  (FLOW-004 is not asserted here: the
    pytree mode deliberately accumulates in the arch's ``acc_dtype``; the
    f32-master contract belongs to the fused/flat path.)"""
    findings: list[Finding] = []
    guard = lambda p: ("params" in p or "opt" in p or "acc" in p)
    for token_val, stale in ((step_seed - iota - 1, [True]),
                             (step_seed, [False])):
        state = make_state()
        state["micro"], state["gstep"] = m - 1, step_seed
        token = torch.tensor(token_val, dtype=torch.int32)
        result, outs, ctx = analyze(step, (state, batch, token),
                                    [taint(PARAM), taint(RAW),
                                     taint(TOKEN)], site=site)
        findings += check_no_raw(outs, out_paths(result), guard, site)
        findings += check_tombstone(ctx, np.asarray(stale), site)
        if findings:
            break
    return findings


def flow_sync_step(step: Callable, args: tuple, *, site: str
                   ) -> list[Finding]:
    """FLOW-001 on the sync psum step ``(params, opt, batch, tokens,
    gstep) -> (params, opt, loss)``."""
    result, outs, _ = analyze(
        step, args, [taint(PARAM), taint(PARAM), taint(RAW), taint(TOKEN),
                     EMPTY], site=site)
    if len(result) != 3:
        return [finding("GBA-FLOW-001", site,
                        f"sync step output arity {len(result)} != params, "
                        f"opt, loss — cannot prove the update path")]
    paths = out_paths(result)
    n_loss = len(out_paths(result[2]))
    return check_no_raw(outs[:len(outs) - n_loss], paths, lambda p: True,
                        site)


def flow_aggregate_embedding(*, site, m=4, n=8, dim=8, capacity=64,
                             iota=4, seed=0) -> list[Finding]:
    """FLOW-005 on the Alg. 2 per-ID aggregate
    (``core.gba.aggregate_embedding``): the divide that turns the
    scattered sum into a mean must be by the masked contributor count.
    Inputs drawn from ``seed``, with padding ids and a stale slot."""
    from repro_torch.core.gba import aggregate_embedding
    rng = np.random.default_rng(seed)
    gstep = 9
    ids = torch.from_numpy(rng.integers(-1, capacity + 1, (m, n),
                                        dtype=np.int32))
    rows = torch.from_numpy(rng.standard_normal((m, n, dim),
                                                dtype=np.float32))
    tokens = torch.from_numpy(np.array([gstep, gstep - iota - 1]
                                       + [gstep] * (m - 2), dtype=np.int32))
    last = torch.from_numpy(rng.integers(0, gstep + 1, (capacity,),
                                         dtype=np.int32))

    def agg(ids, rows, tokens, last):
        return aggregate_embedding(ids, rows, tokens, last, gstep, iota,
                                   capacity)

    _, _, ctx = analyze(agg, (ids, rows, tokens, last),
                        [taint(IDS), taint(RAW), taint(TOKEN), taint(STEP)],
                        site=site)
    return check_divisor(ctx, site)
