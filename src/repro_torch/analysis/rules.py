"""Rule registry of the port's static auditor.

Counterpart of ``repro.analysis.rules``.  Every check carries the
reference's stable rule ID (``GBA-<FAM>-<NNN>``) and text, so a finding,
a suppression and a baseline entry name the same rule in both packages.
A violation is a :class:`Finding`; suppression is by rule ID, globally
(``"GBA-COLL-001"``) or at one site (``"GBA-COLL-001@granite-8b/
fused_psum"``).

Departures.  ``GBA-DON-001`` is restated for eager PyTorch, which
donates nothing: the step must write the buffer and the accumulator in
place and allocate no tensor of the buffer's size.  GBA-TILE-001,
GBA-VMEM-001/002 and GBA-GRID-001 are restated for Hopper's CUDA launches
(``launch_check``): vectors and tensor maps for the TPU's tiles, shared
memory for VMEM, CUDA's grid for the BlockSpec index maps.  The rule in
:data:`NOT_PORTED` checks what the port does not have (a compiler's trace
cache); a finding, a suppression or a baseline entry naming it is refused
with its reason, as an unknown ID is.
"""
from __future__ import annotations

from dataclasses import dataclass

RULES: dict[str, str] = {
    "GBA-COLL-001": (
        "layer-grouped fused-psum collective schedule matches "
        "ShardedFlatLayout.group_table: one tiled all_gather per group "
        "(exact per-group shapes, group order) + one (M,) token gather, "
        "one all_to_all per group (exact (M, group_shard) shapes, group "
        "order), gathers before routing"),
    "GBA-COLL-002": (
        "every psum on the audited path reduces scalars only — the "
        "gradient buffer is routed, never summed"),
    "GBA-COLL-003": (
        "the serving decode path launches no collectives"),
    "GBA-COLL-004": (
        "the sync psum step reduces exactly the per-leaf decayed "
        "gradients plus one scalar loss — no gathers, no all_to_all"),
    "GBA-COLL-005": (
        "every all_to_all/all_gather operand dtype on the fused-psum "
        "wire matches the declared CompressionPolicy: per group, one "
        "int8 payload + the per-tile f32 sideband(s) past warmup, one "
        "f32 operand during warmup/none — full-precision leakage after "
        "warmup is a CI failure"),
    "GBA-DTYPE-001": (
        "no silent f32 upcast on the gradient path: widening float "
        "convert_element_type count equals the sanctioned per-leaf "
        "ravel/loss casts of the probe trace"),
    "GBA-DTYPE-002": (
        "no float64 anywhere in a traced hot path (x64/weak-type leak)"),
    "GBA-DON-001": (
        "the fused train step updates the flat (M, shard) buffer and the "
        "Adagrad accumulator in place (the same storages come back) and "
        "allocates no tensor of the buffer's size during the step (no "
        "double allocation)"),
    "GBA-TILE-001": (
        "every vectorised access divides its operand's rows into whole "
        "vectors of at most 16 bytes, every block is whole warps, and every "
        "TMA tensor map is legal on Hopper: the inner box a multiple of 16 "
        "bytes no wider than its swizzle span (128 B), each box dimension "
        "<= 256, each global stride a multiple of 16 bytes"),
    "GBA-VMEM-001": (
        "the kernel's declared shared-memory formula (ring_smem_bytes-, "
        "resident_smem_bytes-, apply_smem_bytes-style) equals the sum of "
        "the named regions of its launch meta that it counts"),
    "GBA-VMEM-002": (
        "static plus dynamic shared memory fits what a block may use "
        "(232,448 B on an H100, static alone 48 KB), and where the plan "
        "counts on k blocks an SM, k x (shared memory + the 1,024 B "
        "reserved a block) fits the SM's 233,472 B"),
    "GBA-GRID-001": (
        "the grid and block fit the device's limits, every index map keeps "
        "every block's tile inside its operand over the whole grid (a "
        "masked ragged edge allowed), every grid-stride walk covers its "
        "rows, every element offset and int argument fits its width, and "
        "a cooperative grid is resident at once"),
    "GBA-FLOW-001": (
        "no path from a raw per-token gradient to the optimizer update "
        "bypasses the Eq. (1) decay-weight multiply (taint pass over the "
        "traced step: a 'raw' tag must be cleared by a decay-mask mul "
        "before it reaches a params/accum output)"),
    "GBA-FLOW-002": (
        "tombstone tokens propagate symbolic zero into the aggregate: at "
        "the decay multiply, the concretely-evaluated weight of every "
        "slot staler than iota is EXACTLY 0.0 (not just small) and every "
        "fresh slot's weight is nonzero"),
    "GBA-FLOW-003": (
        "the error-feedback residual feeds only the next quantize, never "
        "the apply: a 'residual' tag may reach params/accum outputs only "
        "through the quantize kernel's code path"),
    "GBA-FLOW-004": (
        "bf16-param models update through an f32 master chain: no "
        "sub-f32 float arithmetic on decayed-gradient values, and every "
        "narrowing convert of an updated value is a single final "
        "downcast (feeds outputs/stores, never further compute)"),
    "GBA-FLOW-005": (
        "the per-ID aggregate divisor counts only valid contributors: "
        "the divide of a gradient aggregate must be by a count carrying "
        "both the padding mask and the token-decay mask, never by a "
        "constant"),
    "GBA-RACE-001": (
        "no unlocked shared mutation: an attribute written by the sync "
        "thread, or one that is lock-guarded anywhere in its class, is "
        "only mutated under the instance lock (a single plain attribute "
        "assignment of a never-mutated-in-place object is blessed as an "
        "immutable snapshot swap)"),
    "GBA-RACE-002": (
        "no torn multi-attribute view: a method reading two or more "
        "lock-guarded attributes outside the lock can observe a torn "
        "version/step pair; one unlocked guarded read (the snapshot "
        "idiom) is blessed"),
    "GBA-RACE-003": (
        "no callback invoked while holding the lock: a method that calls "
        "stored listener callables must not be reached from inside a "
        "with-lock region (deadlock/reentrancy escape of shared state)"),
}

NOT_PORTED: dict[str, str] = {
    "GBA-RETRACE-001": ("checks jax.jit's trace cache; the port runs "
                        "eagerly and compiles nothing"),
}


@dataclass(frozen=True)
class Finding:
    """One rule violation at one call site."""

    rule: str
    site: str
    detail: str

    def __str__(self) -> str:
        return f"{self.rule} @ {self.site}: {self.detail}"


def _validate(rule: str) -> None:
    if rule in NOT_PORTED:
        raise KeyError(f"rule {rule!r} is not ported: {NOT_PORTED[rule]}")
    if rule not in RULES:
        raise KeyError(f"unknown rule ID {rule!r}; known: {sorted(RULES)}")


def finding(rule: str, site: str, detail: str) -> Finding:
    _validate(rule)
    return Finding(rule, site, detail)


def parse_suppressions(items) -> tuple[tuple[str, str | None], ...]:
    """``["GBA-X-001", "GBA-Y-002@site"]`` -> ((rule, site-or-None), ...).
    Unknown and not-ported rule IDs are rejected so a typo can't silently
    disable nothing."""
    out = []
    for item in items:
        rule, _, site = str(item).partition("@")
        _validate(rule)
        out.append((rule, site or None))
    return tuple(out)


def is_suppressed(f: Finding,
                  suppressions: tuple[tuple[str, str | None], ...]) -> bool:
    return any(rule == f.rule and (site is None or site == f.site)
               for rule, site in suppressions)


def apply_suppressions(findings, suppressions):
    """-> (kept, suppressed) finding lists."""
    kept, dropped = [], []
    for f in findings:
        (dropped if is_suppressed(f, suppressions) else kept).append(f)
    return kept, dropped
