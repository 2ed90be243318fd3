"""The collective census, the dtype lints and the in-place lint.

Counterpart of ``repro.analysis.jaxpr_audit``.  The reference reads the
collectives of a traced jaxpr; the port's steps issue theirs through a
*world* (``distributed.inprocess``, ``distributed.process_group.
ProcessGroupBackend`` or ``launch.dryrun.MetaWorld``), so
:class:`RecordingWorld` wraps one and logs every call in issue order, its
kind, operand shapes and dtypes, while the step runs for real.
:class:`CensusMode`, a ``TorchDispatchMode``, also counts every
``c10d`` / ``_c10d_functional`` operator (a collective issued around the
world), every float64 value and every widening float convert outside the
kernel wrappers' plain-version regions (``kernels.runtime.plain_region``;
the plain versions use float64 to copy XLA's fused multiply-add,
``kernels/ref.py``).

The census is the machine-checked form of the schedule documented on
``core.gba_shard_map.make_gba_fused_psum_step``: one tiled gather per
layer group (``world.gather_group``, the exact group-shard shape, group
order), then one route of an ``(M, group_shard)`` block per group and
held worker (``world.route``), every gather before any route, and the
only reduction left the scalar losses (``world.all_losses``).  The
reference also gathers each device's token, ``(1,)``; the port's steps
take the ``(M,)`` tokens whole on every process, so that gather has no
counterpart and the schedule does not ask for it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.rules import Finding, finding
from repro_torch.kernels import runtime

_C10D = ("c10d", "_c10d_functional")


@dataclass(frozen=True)
class Collective:
    """One collective call: its kind (``all_gather``, ``all_to_all``,
    ``psum`` for a reduction of losses or gradients, or a ``c10d``
    operator's name) and its operands' shapes and dtypes."""

    op: str
    in_shapes: tuple[tuple[int, ...], ...]
    in_dtypes: tuple[str, ...]
    call: str = ""          # the world function (or operator) issued

    def scalar_only(self) -> bool:
        return all(s == () for s in self.in_shapes)


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class RecordingWorld:
    """A world that logs every collective call to ``calls`` and passes
    it to ``world``.  Attributes that issue nothing (``size``, ``rank``,
    ``workers``, ``model_shards``) are the wrapped world's."""

    def __init__(self, world):
        self.world = world
        self.calls: list[Collective] = []

    def __getattr__(self, name):
        return getattr(self.world, name)

    def _log(self, op: str, call: str, tensors) -> None:
        self.calls.append(Collective(
            op, tuple(tuple(t.shape) for t in tensors),
            tuple(_dt(t) for t in tensors), call))

    def gather_group(self, layout, g: int, param_flat: torch.Tensor):
        lo, hi = layout.group_shard_bounds(g)
        k = param_flat.shape[0] // layout.shard_size
        self._log("all_gather", "gather_group",
                  [param_flat.view(k, layout.shard_size)[:, lo:hi]])
        return self.world.gather_group(layout, g, param_flat)

    def all_gather(self, layout, param_flat: torch.Tensor):
        self._log("all_gather", "all_gather", [param_flat])
        return self.world.all_gather(layout, param_flat)

    def gather_flat(self, run: torch.Tensor):
        self._log("all_gather", "gather_flat", [run])
        return self.world.gather_flat(run)

    def route(self, dst, worker: int, lo: int, hi: int,
              src: torch.Tensor) -> None:
        self._log("all_to_all", "route", [src])
        return self.world.route(dst, worker, lo, hi, src)

    def all_losses(self, losses: list) -> list:
        self._log("psum", "all_losses", losses)
        return self.world.all_losses(losses)

    def worker_sum(self, terms, like: list) -> list:
        self._log("psum", "worker_sum", like)
        return self.world.worker_sum(terms, like)

    def reduce_scatter(self, flat: torch.Tensor):
        self._log("reduce_scatter", "reduce_scatter", [flat])
        return self.world.reduce_scatter(flat)

    def data_gather(self, parts: list, dim: int):
        self._log("all_gather", "data_gather", parts)
        return self.world.data_gather(parts, dim)

    def data_reduce(self, whole: torch.Tensor, dim: int):
        self._log("reduce_scatter", "data_reduce", [whole])
        return self.world.data_reduce(whole, dim)

    def data_sum(self, partial: torch.Tensor):
        self._log("psum", "data_sum", [partial])
        return self.world.data_sum(partial)

    def model_gather(self, parts: list) -> list:
        self._log("all_gather", "model_gather", parts)
        return self.world.model_gather(parts)


def _widening(src: torch.Tensor, dst: torch.Tensor) -> bool:
    return (src.dtype.is_floating_point and dst.dtype.is_floating_point
            and dst.element_size() > src.element_size())


class CensusMode(TorchDispatchMode):
    """Count, outside the plain-version regions, the ``c10d`` operators
    (``collectives``), the operators that make a float64 value (``f64``)
    and the widening float converts of at least ``min_elements`` elements
    (``widening``: ``_to_copy`` and ``copy_`` to a wider float)."""

    def __init__(self, min_elements: int = 8):
        super().__init__()
        self.min_elements = min_elements
        self.collectives: list[Collective] = []
        self.f64: list[tuple[str, tuple]] = []
        self.widening: list[tuple[tuple, str, str]] = []

    def enter_region(self, name: str) -> None:
        pass

    def exit_region(self, name: str) -> None:
        pass

    def __enter__(self):
        self._observing = runtime.observe(self)
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observing.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if runtime.regions:
            return out
        name = func.overloadpacket.__name__
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.namespace in _C10D:
            self.collectives.append(Collective(
                name, tuple(tuple(t.shape) for t in ins),
                tuple(_dt(t) for t in ins), name))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                self.f64.append((name, tuple(t.shape)))
        pair = None
        if name == "_to_copy" and ins:
            pair = (ins[0], next(t for t in tree_leaves(out)
                                 if isinstance(t, torch.Tensor)))
        elif name == "copy_" and len(ins) >= 2:
            pair = (ins[1], ins[0])
        if pair and _widening(*pair) and \
                pair[0].numel() >= self.min_elements:
            self.widening.append((tuple(pair[0].shape), _dt(pair[0]),
                                  _dt(pair[1])))
        return out


def census_counts(census: list[Collective]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for c in census:
        counts[c.op] = counts.get(c.op, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# GBA-COLL rules
# ---------------------------------------------------------------------------

def expected_fused_collectives(layout, m: int):
    """The declared schedule of ``make_gba_fused_psum_step`` for this
    layout on a process holding all ``m`` workers and shards (in process,
    or one rank): (per-group gather operand shapes, in group order: the
    shards' ``(m, group_shard)`` sub-slices; per-route operand shapes:
    for each worker, one ``(m, group_shard)`` block a group, in group
    order)."""
    gathers = [(m, gsn) for gsn in layout.group_shard_sizes]
    return gathers, gathers * m


def check_fused_psum_schedule(calls: list[Collective], layout, m: int,
                              site: str, c10d: list | None = None
                              ) -> list[Finding]:
    """GBA-COLL-001 + GBA-COLL-002 over a recorded fused-psum step.
    ``c10d`` is the census mode's ``c10d`` operators, if the world issued
    any outside the recorded calls (it may not: the recorded calls are
    the world's)."""
    findings = []
    exp_gathers, exp_routes = expected_fused_collectives(layout, m)
    got_gathers = [c.in_shapes[0] for c in calls if c.op == "all_gather"]
    got_routes = [c.in_shapes[0] for c in calls if c.op == "all_to_all"]
    if got_gathers != exp_gathers:
        findings.append(finding(
            "GBA-COLL-001", site,
            f"all_gather operands {got_gathers} != per-group "
            f"{exp_gathers} (group_table order)"))
    if got_routes != exp_routes:
        findings.append(finding(
            "GBA-COLL-001", site,
            f"all_to_all operands {got_routes} != per-group {exp_routes}"))
    first_route = next((i for i, c in enumerate(calls)
                        if c.op == "all_to_all"), len(calls))
    late = [c.in_shapes[0] for c in calls[first_route:]
            if c.op == "all_gather"]
    if late:
        findings.append(finding(
            "GBA-COLL-001", site,
            f"param gathers {late} issued after gradient routing"))
    stray = [c.call for c in calls
             if c.call not in ("gather_group", "route", "all_losses")]
    stray += [c.op for c in c10d or ()]
    if stray:
        findings.append(finding(
            "GBA-COLL-001", site, f"unexpected collectives {stray}"))
    findings += check_scalar_psum_only(calls, site)
    return findings


def expected_wire_collectives(layout, m: int, policy, warm: bool = False):
    """The declared wire of a compressed fused-psum step: the route
    operands' ``(shape, dtype)`` lists, one a group in group order for
    each of the ``m`` workers.  Past warmup each group routes its int8 payload
    then the per-tile f32 sideband(s) (scale, and zero-point for int8
    min-max); during warmup (or scheme ``none``) one f32 ``(m,
    group_shard)`` block."""
    per_group = []
    for gsn in layout.group_shard_sizes:
        if warm or policy.scheme == "none":
            per_group.append([((m, gsn), "float32")])
            continue
        n_tiles = gsn // layout.tile
        ops = [((m, gsn), "int8"), ((m, n_tiles), "float32")]
        if policy.scheme == "int8":
            ops.append(((m, n_tiles), "float32"))    # zero-point sideband
        per_group.append(ops)
    return per_group * m


def check_wire_dtypes(calls: list[Collective], layout, m: int, policy,
                      site: str, warm: bool = False) -> list[Finding]:
    """GBA-COLL-005: every route operand on a recorded fused-psum step
    matches the declared ``CompressionPolicy`` (an f32 ``(m,
    group_shard)`` operand past warmup is full-precision leakage), and
    every param gather travels float32 (compression is a routing-stage
    transform)."""
    findings = []
    expected = [op for group in expected_wire_collectives(
        layout, m, policy, warm=warm) for op in group]
    routes = [(c.in_shapes[0], c.in_dtypes[0])
              for c in calls if c.op == "all_to_all"]
    if routes != expected:
        findings.append(finding(
            "GBA-COLL-005", site,
            f"all_to_all wire {routes} != declared "
            f"{policy.scheme}{' warmup' if warm else ''} wire {expected}"))
    for c in calls:
        if c.op == "all_gather" and c.in_dtypes[0] != "float32":
            findings.append(finding(
                "GBA-COLL-005", site,
                f"all_gather operand {c.in_shapes[0]} has dtype "
                f"{c.in_dtypes[0]}, expected float32 (params travel full "
                f"precision; compression is routing-stage only)"))
    return findings


def check_scalar_psum_only(calls: list[Collective], site: str
                           ) -> list[Finding]:
    """GBA-COLL-002: every reduction reduces scalars only."""
    bad = [c.in_shapes for c in calls
           if c.op in ("psum", "reduce_scatter") and not c.scalar_only()]
    if bad:
        return [finding("GBA-COLL-002", site,
                        f"non-scalar psum operands: {bad}")]
    return []


def check_no_collectives(calls: list[Collective], site: str
                         ) -> list[Finding]:
    """GBA-COLL-003: the path issues no collectives at all."""
    counts = census_counts(calls)
    if counts:
        return [finding("GBA-COLL-003", site, f"collectives found: {counts}")]
    return []


def check_sync_psum_schedule(calls: list[Collective], leaf_shapes,
                             site: str) -> list[Finding]:
    """GBA-COLL-004: the sync step sums exactly the per-leaf decayed
    gradients (one ``worker_sum`` over every leaf) plus the scalar
    losses (one ``all_losses``); no gathers or routing."""
    findings = []
    others = census_counts([c for c in calls if c.op != "psum"])
    if others:
        findings.append(finding(
            "GBA-COLL-004", site,
            f"sync step should only psum; found {others}"))
    sums = [c for c in calls if c.call == "worker_sum"]
    losses = [c for c in calls if c.call == "all_losses"]
    got = sorted(s for c in sums for s in c.in_shapes)
    want = sorted(tuple(s) for s in leaf_shapes)
    if len(sums) != 1 or got != want:
        findings.append(finding(
            "GBA-COLL-004", site,
            f"worker_sum operand shapes {got} in {len(sums)} call(s) != "
            f"one over the per-leaf gradients {want}"))
    if len(losses) != 1 or not losses[0].scalar_only():
        findings.append(finding(
            "GBA-COLL-004", site,
            f"loss reductions {[c.in_shapes for c in losses]} != one of "
            f"scalar losses"))
    return findings


# ---------------------------------------------------------------------------
# GBA-DTYPE rules
# ---------------------------------------------------------------------------

def check_widening_budget(widening: list, budget: int, site: str
                          ) -> list[Finding]:
    """GBA-DTYPE-001: at most ``budget`` widening float converts (run on
    probe-loss steps, where the sanctioned count is exactly derivable: a
    real mixed-precision LM forward has legitimate upcasts)."""
    if len(widening) > budget:
        return [finding(
            "GBA-DTYPE-001", site,
            f"{len(widening)} widening float converts > sanctioned {budget} "
            f"(per-leaf ravel/loss casts); e.g. {widening[:6]}")]
    return []


def check_no_f64(f64: list, site: str) -> list[Finding]:
    """GBA-DTYPE-002: float64 never appears on a hot path outside the
    plain versions of the kernels."""
    if f64:
        return [finding("GBA-DTYPE-002", site,
                        f"float64 values produced by {f64[:6]}")]
    return []


# ---------------------------------------------------------------------------
# GBA-DON: the in-place lint
# ---------------------------------------------------------------------------

def check_in_place(before: dict, after: dict, largest: int,
                   buffer_bytes: int, site: str) -> list[Finding]:
    """GBA-DON-001: the step gave back the storages it was given for each
    name of ``before`` (name -> tensor; ``after`` the same names in the
    returned state) and allocated no storage of ``buffer_bytes`` or more
    (``largest``, the biggest storage an operator made during the step)."""
    moved = [name for name, t in before.items()
             if after[name].untyped_storage().data_ptr()
             != t.untyped_storage().data_ptr()]
    findings = []
    if moved:
        findings.append(finding(
            "GBA-DON-001", site,
            f"{moved} come back in new storage — the step must update "
            f"them in place"))
    if largest >= buffer_bytes:
        findings.append(finding(
            "GBA-DON-001", site,
            f"the step allocated a {largest}-byte tensor, as large as the "
            f"{buffer_bytes}-byte buffer (double allocation)"))
    return findings
