"""The port's static auditor: the hot paths run on the CPU and checked
against their invariants.

Counterpart of ``repro.analysis``.  The staleness-taint pass over the
steps (``dataflow``, GBA-FLOW), the collective census and the dtype and
in-place lints (``census``, GBA-COLL, GBA-DTYPE, GBA-DON), the kernels'
launch checks (``launch_check``, GBA-TILE, GBA-VMEM, GBA-GRID) and the
serving-thread lock-discipline lint (``race_lint``, GBA-RACE), wired into
the per-arch matrix in ``audit`` and the ``python -m repro_torch.analysis``
CLI.  Rule IDs, texts and what is not ported live in ``rules``.
"""
from repro_torch.analysis.audit import (AuditReport, arch_apply_meta,
                                        audit_arch, audit_dataflow,
                                        audit_kernels, audit_serving,
                                        kernel_metas, probe_loss, run_audit,
                                        widening_budget)
from repro_torch.analysis.census import (CensusMode, Collective,
                                         RecordingWorld, census_counts,
                                         check_fused_psum_schedule,
                                         check_in_place,
                                         check_no_collectives, check_no_f64,
                                         check_scalar_psum_only,
                                         check_sync_psum_schedule,
                                         check_widening_budget,
                                         check_wire_dtypes,
                                         expected_fused_collectives,
                                         expected_wire_collectives)
from repro_torch.analysis.dataflow import (FlowContext, FlowMode, Taint,
                                           analyze, check_divisor,
                                           check_no_raw, check_no_residual,
                                           check_tombstone,
                                           flow_aggregate_embedding,
                                           flow_fused_step,
                                           flow_fused_train_step,
                                           flow_pytree_step, flow_sync_step,
                                           out_paths, seed_taints, taint)
from repro_torch.analysis.launch_check import (check_grid, check_launch,
                                               check_smem, check_tiles)
from repro_torch.analysis.race_lint import (analyze_classes, lint_classes,
                                            lint_default, lint_sources)
from repro_torch.analysis.rules import (NOT_PORTED, RULES, Finding,
                                        apply_suppressions, finding,
                                        is_suppressed, parse_suppressions)

__all__ = [
    "AuditReport", "CensusMode", "Collective", "Finding", "FlowContext",
    "FlowMode", "NOT_PORTED", "RULES", "RecordingWorld", "Taint", "analyze",
    "analyze_classes", "apply_suppressions", "arch_apply_meta", "audit_arch",
    "audit_dataflow", "audit_kernels", "audit_serving", "census_counts",
    "check_divisor", "check_fused_psum_schedule", "check_grid",
    "check_in_place", "check_launch", "check_no_collectives",
    "check_no_f64", "check_no_raw", "check_no_residual",
    "check_scalar_psum_only", "check_smem", "check_sync_psum_schedule",
    "check_tiles", "check_tombstone", "check_widening_budget",
    "check_wire_dtypes", "expected_fused_collectives",
    "expected_wire_collectives", "finding", "flow_aggregate_embedding",
    "flow_fused_step", "flow_fused_train_step", "flow_pytree_step",
    "flow_sync_step", "is_suppressed", "kernel_metas", "lint_classes",
    "lint_default", "lint_sources", "out_paths", "parse_suppressions",
    "probe_loss", "run_audit", "seed_taints", "taint", "widening_budget",
]
