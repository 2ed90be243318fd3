"""The audit matrix: every registered arch x every ported hot-path rule.

Counterpart of ``repro.analysis.audit``.  For each arch, at its
``.reduced()`` config (the same code paths at sizes the CPU runs in
seconds), the auditor runs each step once on the CPU, with weights and
data drawn from a seed, and reads it with the census (``census``) and the
taint pass (``dataflow``):

a. the layer-grouped **fused psum step**
   (``core.gba_shard_map.make_gba_fused_psum_step``), M = ``AUDIT_M``
   workers in process, with the real LM loss -> GBA-COLL-001/002 (the
   recorded schedule against the layout's), GBA-DTYPE-002, GBA-FLOW-001;
b. the same step with a **probe loss** whose sanctioned widening-convert
   count is exactly derivable -> GBA-DTYPE-001;
g. the same step on the **compressed wire** (int8, onebit; probe loss)
   past warmup -> GBA-COLL-005/002, GBA-DTYPE-002, GBA-FLOW-001/003, and
   the int8 warmup step -> GBA-COLL-005 (f32 wire) and GBA-COLL-001;
c. the **sync psum step** (``make_gba_psum_step``, Adagrad) ->
   GBA-COLL-004, GBA-FLOW-001;
d. the single-host **fused train step**
   (``launch.programs.make_fused_train_step``) at its applying microstep
   -> GBA-DON-001 (in place, no second buffer) and GBA-FLOW-001/002/004;
d2. the **pytree train step** (``launch.programs.make_train_step``, the
   arch's optimizer and accumulator dtype) -> GBA-FLOW-001/002;
e. the **decode step** (``models.transformer.decode_step``) ->
   GBA-COLL-003, GBA-DTYPE-002;
f. the arch's own **gba_apply launch** at its real sharded layout
   (:func:`arch_apply_meta`) -> GBA-TILE-001, GBA-VMEM-001/002,
   GBA-GRID-001 (``launch_check``).

Beside the archs, :func:`audit_kernels` checks every other kernel's
launch meta at its shapes (:func:`kernel_metas`) with the same rules.

The steps run on the CPU by design, as ``launch/dryrun.py`` runs on no
device: the audit never looks for a card and never launches a kernel (the
wrappers take their plain versions on CPU tensors; the launch rules read
static metas).  There is no retrace check (the port compiles nothing).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from repro_torch.analysis import census as CS
from repro_torch.analysis import dataflow as DFL
from repro_torch.analysis import launch_check as LC
from repro_torch.analysis import race_lint as RL
from repro_torch.analysis.rules import Finding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import GBAConfig, InputShape
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.distributed import inprocess
from repro_torch.kernels import (embedding_bag, flash_decode, fused_adagrad,
                                 gba_aggregate, gba_apply, quantize)
from repro_torch.kernels.launch_meta import HOPPER, DeviceLimits, LaunchMeta
from repro_torch.launch.dryrun import LiveBytes
from repro_torch.launch.programs import (ARCH_ACC_DTYPE, ARCH_OPTIMIZER,
                                         init_fused_train_state,
                                         init_train_state, make_loss_fn,
                                         make_fused_train_step,
                                         make_train_step)
from repro_torch.launch.steps import _memory_len, model_inputs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer

AUDIT_M = 4            # workers / PS shards of the audited steps
AUDIT_SEQ = 16         # sequence length (shapes don't change collectives)
AUDIT_IOTA = 4
AUDIT_LR = 1e-3
AUDIT_GSTEP = 9
AUDIT_SEED = 0
DECODE_BATCH, DECODE_CACHE = 2, 64


def audit_tokens(m: int) -> torch.Tensor:
    """The workers' tokens of the psum steps at ``AUDIT_GSTEP``: all fresh
    but worker 2, staler than ``AUDIT_IOTA``."""
    tokens = torch.full((m,), AUDIT_GSTEP, dtype=torch.int32)
    if m > 2:
        tokens[2] = AUDIT_GSTEP - AUDIT_IOTA - 1
    return tokens


def probe_loss(params, batch):
    """Loss with an exactly countable upcast budget: per non-f32 leaf,
    one widening ``.float()`` here (forward) and one in
    ``ravel_group`` (its gradient into the float32 block), nothing
    else."""
    sq = sum(torch.sum(leaf.float() ** 2) for _, leaf in tree_paths(params))
    return torch.mean(batch["x"]) * sq


def widening_budget(layout: ShardedFlatLayout, workers: int) -> int:
    """Sanctioned widening-convert count of a probe-loss fused step run
    by ``workers`` workers in one process: each worker's loss casts every
    non-f32 leaf up once and ``ravel_group`` copies each such leaf's
    gradient into float32 once, so ``2 * workers`` per non-f32 leaf.  The
    reference's ``widening_budget`` is ``2`` per non-f32 leaf: its trace
    is one device's program, one worker."""
    return 2 * workers * sum(1 for dt in layout.dtypes
                             if dt != torch.float32)


def _draw(tree, cfg, gen: torch.Generator):
    """Real CPU tensors for the meta ``tree`` of ``launch.steps``'
    ``model_inputs``: token ids below the vocabulary, floats at 0.02."""
    out = {}
    for k, t in tree.items():
        if t.dtype.is_floating_point:
            out[k] = (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   dtype=t.dtype)
    return out


def train_batch(cfg, rows: int, gen: torch.Generator) -> dict:
    return _draw(model_inputs(cfg, InputShape("audit", AUDIT_SEQ, rows,
                                              "train")), cfg, gen)


def arch_layout(cfg, params, m: int = AUDIT_M) -> ShardedFlatLayout:
    """The arch's real layer-grouped flat layout at ``m`` PS shards."""
    return ShardedFlatLayout.from_params(params, m,
                                         group_by=T.param_group_key)


def psum_args(layout: ShardedFlatLayout, params, m: int, batch: dict,
              compress: CompressionPolicy | None = None) -> tuple:
    """Fresh arguments of the fused psum step in process: the params'
    shard-major vector, the accumulator, ``batch``, the workers' tokens,
    the global step, and zero wire state for a lossy ``compress``."""
    args = (layout.ravel(params), torch.full((layout.padded_total,), 0.1),
            batch, audit_tokens(m), AUDIT_GSTEP)
    if compress is not None and compress.stateful:
        args += (compress.init_wire_state(layout, m, torch.device("cpu")),)
    return args


def census_run(fn, *args):
    """``fn(*args)`` under :class:`census.CensusMode`: (result, mode)."""
    with CS.CensusMode() as mode:
        result = fn(*args)
    return result, mode


def fused_psum_census(layout, m: int, loss_fn, args: tuple, *,
                      compress=None, warm: bool = False, world=inprocess):
    """Run the fused psum step once over a :class:`census.RecordingWorld`
    around ``world``: (recorded calls, census mode)."""
    rec = CS.RecordingWorld(world)
    step = make_gba_fused_psum_step(m, loss_fn, layout, iota=AUDIT_IOTA,
                                    lr=AUDIT_LR, compress=compress,
                                    warm=warm, world=rec)
    _, mode = census_run(step, *args)
    return rec.calls, mode


@dataclass
class AuditReport:
    """One audited site group (an arch, the dataflow sites, serving)."""

    name: str
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings


def audit_arch(arch: str, *, m: int = AUDIT_M,
               reduced: bool = True) -> AuditReport:
    """Run the full rule matrix over one registered arch."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    rep = AuditReport(arch)
    gen = torch.Generator().manual_seed(AUDIT_SEED)
    params = T.init_model(cfg, generator=gen, device="cpu")
    layout = arch_layout(cfg, params, m)
    lm_loss = make_loss_fn(cfg)
    batch = train_batch(cfg, m, gen)
    probe_batch = {"x": torch.randn((m * 8,), generator=gen)}

    def fused(loss_fn, compress=None):
        return make_gba_fused_psum_step(m, loss_fn, layout, iota=AUDIT_IOTA,
                                        lr=AUDIT_LR, compress=compress)

    # a. fused psum step, real LM loss: collective schedule + f64 ban
    site = f"{arch}/fused_psum"
    calls, mode = fused_psum_census(layout, m, lm_loss,
                                    psum_args(layout, params, m, batch))
    rep.findings += CS.check_fused_psum_schedule(calls, layout, m, site,
                                                 c10d=mode.collectives)
    rep.findings += CS.check_no_f64(mode.f64, site)
    rep.findings += DFL.flow_fused_step(
        fused(lm_loss), psum_args(layout, params, m, batch),
        site=site)
    counts = CS.census_counts(calls)
    rep.stats.update(
        all_gather=counts.get("all_gather", 0),
        all_to_all=counts.get("all_to_all", 0),
        psum=counts.get("psum", 0),
        num_groups=layout.num_groups,
        shard_size=layout.shard_size,
        peak_gather_bytes=layout.peak_gather_bytes)

    # b. probe loss: exact widening-convert budget
    _, mode = fused_psum_census(layout, m, probe_loss,
                                psum_args(layout, params, m, probe_batch))
    rep.stats["widening_converts"] = len(mode.widening)
    rep.findings += CS.check_widening_budget(
        mode.widening, widening_budget(layout, m),
        f"{arch}/fused_psum/probe")

    # g. the compressed wire past warmup, and the int8 warmup step
    for scheme in ("int8", "onebit"):
        pol = CompressionPolicy(scheme=scheme, warmup_steps=1)
        site = f"{arch}/fused_psum/{scheme}"
        calls, mode = fused_psum_census(
            layout, m, probe_loss,
            psum_args(layout, params, m, probe_batch, pol), compress=pol)
        rep.findings += CS.check_wire_dtypes(calls, layout, m, pol, site)
        rep.findings += CS.check_scalar_psum_only(calls, site)
        rep.findings += CS.check_no_f64(mode.f64, site)
        rep.findings += DFL.flow_fused_step(
            fused(probe_loss, pol),
            psum_args(layout, params, m, probe_batch, pol), site=site)
        if scheme == "int8":
            rep.stats.update(
                wire_dtype=pol.wire_dtype(),
                wire_bytes=pol.wire_bytes(layout),
                compression_ratio=round(pol.compression_ratio(layout), 4),
                compressed_all_to_all=CS.census_counts(calls).get(
                    "all_to_all", 0))
            wsite = f"{arch}/fused_psum/warmup"
            calls, _ = fused_psum_census(
                layout, m, probe_loss,
                psum_args(layout, params, m, probe_batch, pol),
                compress=pol, warm=True)
            rep.findings += CS.check_wire_dtypes(calls, layout, m, pol,
                                                 wsite, warm=True)
            rep.findings += CS.check_fused_psum_schedule(calls, layout, m,
                                                         wsite)

    # c. sync psum step: per-leaf grads + scalar losses, nothing else
    site = f"{arch}/sync_psum"
    opt = get_optimizer("adagrad", AUDIT_LR)

    def sync_args():
        return (params, opt.init(params), probe_batch, audit_tokens(m),
                AUDIT_GSTEP)

    rec = CS.RecordingWorld(inprocess)
    census_run(make_gba_psum_step(m, probe_loss, opt, AUDIT_IOTA,
                                  world=rec), *sync_args())
    rep.findings += CS.check_sync_psum_schedule(
        rec.calls, [tuple(x.shape) for _, x in tree_paths(params)], site)
    rep.findings += DFL.flow_sync_step(
        make_gba_psum_step(m, probe_loss, opt, AUDIT_IOTA), sync_args(),
        site=site)

    # d. fused train step at its applying microstep: in place + FLOW
    site = f"{arch}/fused_train_step"
    gba = GBAConfig(local_batch=2, buffer_size=m,
                    staleness_tolerance=AUDIT_IOTA)
    tbatch = train_batch(cfg, 2, gen)

    def fused_state():
        flat_layout, state = init_fused_train_state(
            copy.deepcopy(params), gba)
        return flat_layout, state

    flat_layout, state = fused_state()
    step = make_fused_train_step(cfg, gba, flat_layout, lr=AUDIT_LR)
    state["buffer"]["fill"] = m - 1
    before = {"buffer": state["buffer"]["grads"], "accum": state["accum"]}
    live = LiveBytes()
    live.held((state, tbatch))
    with live:
        new_state, _ = step(state, tbatch, AUDIT_GSTEP)
    after = {"buffer": new_state["buffer"]["grads"],
             "accum": new_state["accum"]}
    grads = before["buffer"]
    rep.findings += CS.check_in_place(before, after, live.largest,
                                      grads.numel() * grads.element_size(),
                                      site)
    rep.stats["train_largest_alloc_bytes"] = live.largest
    del state, new_state, before, after, grads, live
    _, state = fused_state()
    rep.findings += DFL.flow_fused_train_step(
        step, state, tbatch, site=site, m=m, iota=AUDIT_IOTA)
    del state

    # d2. pytree train step: Eq. (1) leaf by leaf, tombstone and fresh
    site = f"{arch}/pytree_step"
    popt = get_optimizer(ARCH_OPTIMIZER.get(cfg.name, "adam"), AUDIT_LR)
    acc_dtype = ARCH_ACC_DTYPE.get(cfg.name, torch.float32)
    rep.findings += DFL.flow_pytree_step(
        make_train_step(cfg, popt, gba),
        lambda: init_train_state(copy.deepcopy(params), popt, acc_dtype),
        tbatch, site=site, m=m, iota=AUDIT_IOTA)

    # e. decode step: no collectives, no f64
    site = f"{arch}/decode"
    mem_len = _memory_len(cfg)
    memory = (torch.randn((DECODE_BATCH, mem_len, cfg.d_model),
                          generator=gen) * 0.02).to(L.dtype_of(cfg)) \
        if mem_len else None
    cache = T.init_cache(cfg, DECODE_BATCH, DECODE_CACHE, "cpu",
                         memory=memory)
    cache["pos"] = torch.tensor(DECODE_CACHE // 2, dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, 1), generator=gen,
                        dtype=torch.int32)
    _, mode = census_run(T.decode_step, params, cfg, tok, cache)
    rep.findings += CS.check_no_collectives(mode.collectives, site)
    rep.findings += CS.check_no_f64(mode.f64, site)

    # f. the arch's own gba_apply launch at its real shard geometry
    meta = arch_apply_meta(cfg, m)
    rep.findings += LC.check_launch(meta, f"{arch}/kernels/gba_apply")
    rep.stats["apply_smem_bytes"] = meta.smem_bytes(meta.smem_counted)
    return rep


def arch_apply_meta(cfg, m: int = AUDIT_M) -> LaunchMeta:
    """Row (f): the ``gba_apply`` launch of ``cfg``'s fused step over ``m``
    PS shards of its layer-grouped layout with ``m`` buffer slots, each
    shard's apply of ``layout.shard_size`` columns.  The layout is built
    from meta-device params (``transformer.param_shapes``), so nothing is
    allocated and no step runs, at any width."""
    layout = arch_layout(cfg, T.param_shapes(cfg), m)
    return gba_apply.launch_meta(layout.shard_size, m)


def kernel_metas() -> tuple[LaunchMeta, ...]:
    """Every kernel's launches at the reference's bench shapes
    (``repro.analysis.audit.kernel_metas``), and the port's own variants:
    ``flash_decode`` at decode_32k at every head dim it takes, in both
    dtypes, and its partial form, the ``embedding_bag_grad`` "counts"
    design at the replay's presence counts, and the resident oracle."""
    bf16 = torch.bfloat16
    launches = [
        fused_adagrad.launch_meta(1 << 16),
        gba_aggregate.launch_meta(1 << 16, 8),
        embedding_bag.fwd_launch_meta(32, 26, 100_000, 128),
        embedding_bag.bwd_launch_meta(32, 26, 100_000, 128),
        embedding_bag.bwd_launch_meta(1, 53_248, 1_600_048, 0),
        embedding_bag.resident_launch_meta(32, 26, 100_000, 64),
        *(f(8, 1 << 14, 2048, mode) for mode in ("minmax", "sign")
          for f in (quantize.quantize_launch_meta,
                    quantize.dequant_launch_meta)),
        *(flash_decode.launch_meta(4, 32_768, 8, 4, hd, dtype)
          for hd in flash_decode.HEAD_DIMS for dtype in (torch.float32,
                                                         bf16)),
        *(flash_decode.launch_meta(4, 32_768, 8, 4, 128, dtype, partial=True)
          for dtype in (torch.float32, bf16))]
    return tuple(x for one in launches
                 for x in (one if isinstance(one, tuple) else (one,)))


def audit_kernels(limits: DeviceLimits = HOPPER) -> AuditReport:
    """GBA-TILE-001, GBA-VMEM-001/002 and GBA-GRID-001 over every launch
    of :func:`kernel_metas` against ``limits``."""
    rep = AuditReport("kernels")
    for meta in kernel_metas():
        rep.findings += LC.check_launch(meta, f"kernels/{meta.site}", limits)
        rep.stats[f"{meta.site}_smem_bytes"] = meta.smem_bytes()
    return rep


def audit_dataflow() -> AuditReport:
    """Arch-independent dataflow sites: the Alg. 2 aggregate's masked
    divisor (GBA-FLOW-005)."""
    rep = AuditReport("dataflow")
    rep.findings += DFL.flow_aggregate_embedding(
        site="dataflow/aggregate_embedding")
    return rep


def audit_serving() -> AuditReport:
    """GBA-RACE lock-discipline lint over the port's serving modules +
    the hot-ID cache (see ``race_lint.DEFAULT_MODULES``)."""
    rep = AuditReport("serving")
    findings, stats = RL.lint_default()
    rep.findings += findings
    rep.stats.update(stats)
    return rep


def run_audit(archs=None, *, m: int = AUDIT_M,
              suppressions=()) -> list[AuditReport]:
    """Audit every requested arch plus the kernel launches, the dataflow
    sites and the serving race lint, applying ``RULE`` / ``RULE@site``
    suppressions."""
    from repro_torch.analysis.rules import (apply_suppressions,
                                            parse_suppressions)
    sup = parse_suppressions(suppressions)
    reports = [audit_arch(a, m=m) for a in (archs or ARCH_IDS)]
    reports.append(audit_kernels())
    reports.append(audit_dataflow())
    reports.append(audit_serving())
    for rep in reports:
        rep.findings, dropped = apply_suppressions(rep.findings, sup)
        rep.suppressed += dropped
    return reports
