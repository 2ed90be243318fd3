"""CLI: audit every registered arch config against the port's hot-path
rules, on the CPU.

    PYTHONPATH=src python -m repro_torch.analysis --check
    PYTHONPATH=src python -m repro_torch.analysis --arch granite-8b
    PYTHONPATH=src python -m repro_torch.analysis --check \
        --suppress GBA-COLL-001@granite-8b/fused_psum
    PYTHONPATH=src python -m repro_torch.analysis --check \
        --baseline .gba-audit-torch.toml
    PYTHONPATH=src python -m repro_torch.analysis --markdown

Counterpart of ``python -m repro.analysis``.

Exit status under ``--check`` is the number of unsuppressed findings
(0 == every audited hot path clean).

``--baseline`` reads the checked-in suppression file — deliberate,
reviewable exceptions with a required reason per entry::

    [[suppress]]
    rule = "GBA-COLL-001"
    site = "granite-8b/fused_psum"          # optional: all sites if absent
    reason = "why this exception is deliberate"

A baseline entry that suppresses nothing prints an unused-suppression
warning so stale exceptions get cleaned up instead of hiding future
regressions.  A suppression naming a rule of ``rules.NOT_PORTED`` is
refused with its reason.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis.audit import AUDIT_M, run_audit
from repro_torch.analysis.rules import RULES, parse_suppressions
from repro_torch.configs import ARCH_IDS


def _parse_minimal_toml(text: str) -> dict:
    """Fallback for pythons without :mod:`tomllib` (3.10): just enough
    TOML for the baseline format — ``[[suppress]]`` table arrays of
    ``key = "string"`` pairs, comments, blank lines."""
    data: dict = {}
    current = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            data.setdefault(name, []).append(current)
            continue
        key, sep, value = line.partition("=")
        if not sep or current is None:
            raise ValueError(
                f"baseline line {lineno}: expected '[[suppress]]' or "
                f"'key = \"value\"', got {raw!r}")
        value = value.split("#", 1)[0].strip()
        if not (value.startswith('"') and value.endswith('"')):
            raise ValueError(
                f"baseline line {lineno}: values must be quoted strings")
        current[key.strip()] = value[1:-1]
    return data


def load_baseline(path) -> list[tuple[str, str | None, str]]:
    """``.gba-audit-torch.toml`` -> ``[(rule, site_or_None, reason),
    ...]``."""
    p = Path(path)
    if not p.is_file():
        raise SystemExit(f"baseline file not found: {path}")
    try:
        import tomllib
        data = tomllib.loads(p.read_text())
    except ModuleNotFoundError:
        data = _parse_minimal_toml(p.read_text())
    entries = []
    for entry in data.get("suppress", []):
        if "rule" not in entry:
            raise SystemExit(
                f"baseline {path}: every [[suppress]] needs a 'rule'")
        if not entry.get("reason"):
            raise SystemExit(
                f"baseline {path}: entry for {entry['rule']} needs a "
                f"'reason' — exceptions must be reviewable")
        entries.append((entry["rule"], entry.get("site") or None,
                        entry["reason"]))
    return entries


def unused_baseline_entries(entries, reports):
    """Baseline entries whose (rule, site) suppressed no finding."""
    return [(rule, site, reason) for rule, site, reason in entries
            if not any(f.rule == rule and (site is None or f.site == site)
                       for rep in reports for f in rep.suppressed)]


MAX_INLINE_STATS = 16


def render_text(reports, elapsed: float) -> str:
    lines = []
    for rep in reports:
        mark = "ok" if rep.ok else f"{len(rep.findings)} FINDINGS"
        stats = " ".join(f"{k}={v}" for k, v in rep.stats.items())
        if len(rep.stats) > MAX_INLINE_STATS:     # the kernels: one a line
            lines.append(f"[{mark:>11s}] {rep.name}")
            lines += [f"    {k} = {v}" for k, v in rep.stats.items()]
        else:
            lines.append(f"[{mark:>11s}] {rep.name}" + (f"  ({stats})"
                                                        if stats else ""))
        for f in rep.findings:
            lines.append(f"    FAIL {f}")
        for f in rep.suppressed:
            lines.append(f"    supp {f.rule} @ {f.site}")
    total = sum(len(r.findings) for r in reports)
    supp = sum(len(r.suppressed) for r in reports)
    lines.append(
        f"audited {len(reports)} site groups x {len(RULES)} rules in "
        f"{elapsed:.1f}s: {total} finding(s), {supp} suppressed")
    return "\n".join(lines)


def render_markdown(reports, elapsed: float) -> str:
    total = sum(len(r.findings) for r in reports)
    lines = [
        "### Static audit (`python -m repro_torch.analysis`)", "",
        f"{len(reports)} site groups x {len(RULES)} rules in "
        f"{elapsed:.1f}s — "
        + ("**all clean**" if total == 0 else f"**{total} finding(s)**"),
        "", "| site group | status | collectives (gather/route/psum) |",
        "|---|---|---|",
    ]
    for rep in reports:
        status = "✅ clean" if rep.ok else f"❌ {len(rep.findings)}"
        if rep.suppressed:
            status += f" ({len(rep.suppressed)} suppressed)"
        s = rep.stats
        coll = (f"{s['all_gather']}/{s['all_to_all']}/{s['psum']}"
                if "all_gather" in s else "—")
        lines.append(f"| {rep.name} | {status} | {coll} |")
    for rep in reports:
        for f in rep.findings:
            lines.append(f"- `{f.rule}` @ `{f.site}`: {f.detail}")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--arch", action="append", choices=ARCH_IDS,
                    help="audit only this arch (repeatable; default all)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any unsuppressed finding")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="RULE[@site]",
                    help="drop findings for RULE (optionally one site)")
    ap.add_argument("--workers", type=int, default=AUDIT_M,
                    help="PS shards / workers in the audited mesh")
    ap.add_argument("--markdown", action="store_true",
                    help="GitHub step-summary markdown instead of text")
    ap.add_argument("--baseline", metavar="TOML",
                    help="checked-in suppression file "
                         "(.gba-audit-torch.toml)")
    args = ap.parse_args(argv)

    baseline = load_baseline(args.baseline) if args.baseline else []
    suppressions = list(args.suppress) + [
        rule + (f"@{site}" if site else "")
        for rule, site, _ in baseline]
    try:
        parse_suppressions(suppressions)
    except KeyError as e:          # unknown or not ported: say which
        raise SystemExit(f"{args.baseline or '--suppress'}: {e.args[0]}")

    t0 = time.perf_counter()
    reports = run_audit(args.arch, m=args.workers,
                        suppressions=suppressions)
    elapsed = time.perf_counter() - t0
    render = render_markdown if args.markdown else render_text
    print(render(reports, elapsed))
    for rule, site, reason in unused_baseline_entries(baseline, reports):
        print(f"warning: unused baseline suppression {rule}"
              + (f"@{site}" if site else "")
              + f" ({reason}) — remove it from {args.baseline}",
              file=sys.stderr)
    total = sum(len(r.findings) for r in reports)
    return min(total, 125) if args.check else 0


if __name__ == "__main__":
    sys.exit(main())
