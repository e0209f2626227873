"""Report generation: JSON + txt + console summary.

Format parity with the reference's ``generate_report`` /
``_generate_report_from_db`` (general_method_paper_reproduction.py:546-641,
1826-2021): totals, per-depth counts, known (paper) solutions found, and
novel-solution equivalence classes with a cost-ranked canonical
representative.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

from . import spans


def _canonical_class_key(expr_str: str, problem) -> str:
    """Equivalence-class key for novel-solution grouping (reference
    general:1919-2008: together→cancel→powsimp→powdenest→simplify→srepr)."""
    import sympy as sp
    try:
        u = problem.tape_to_sympy(problem.parse(expr_str))
        u = sp.together(sp.cancel(u))
        u = sp.powsimp(u, force=False)
        u = sp.powdenest(u)
        u = sp.simplify(u)
        return sp.srepr(u)
    except Exception:
        return f"<unparsed:{expr_str}>"


def _expr_cost(expr_str: str) -> tuple:
    """Cost ranking for choosing a class representative (reference
    general:1958-1999: count_ops, depth, srepr length, penalties)."""
    import sympy as sp
    try:
        u = sp.sympify(expr_str)
        penalty = 1000 if u.has(sp.oo, sp.zoo, sp.nan) else 0
        return (penalty + sp.count_ops(u), len(expr_str))
    except Exception:
        return (10_000, len(expr_str))


def build_report(problem, rows: Optional[List] = None,
                 stats: Optional[List] = None,
                 run_id: str = "", max_depth: int = 0,
                 classify_novel: bool = True,
                 max_novel_classes: int = 200,
                 by_depth_counts: Optional[Dict] = None,
                 valid_rows: Optional[List] = None,
                 family_breakdown: Optional[Dict] = None,
                 novel_class_rows: Optional[List] = None,
                 novel_class_note: str = "") -> Dict:
    """Either pass ``rows`` (all rows, in-memory path) or the precomputed
    ``by_depth_counts`` + ``valid_rows`` (SQL-aggregate path — mega-runs
    never hold every row in memory).

    ``family_breakdown`` (utils/families.summarize) is attached verbatim.
    ``novel_class_rows`` overrides which rows feed the SymPy novel-class
    grouping — the mega-run path passes only the non-degenerate family,
    so classing covers representatives instead of being skipped;
    ``novel_class_note`` explains the
    restriction in the report text."""
    paper_found = {}
    if rows is not None:
        by_depth = defaultdict(lambda: {"generated": 0, "valid": 0})
        valid_rows = []
        for r in rows:
            d = r.depth if hasattr(r, "depth") else r["depth"]
            valid = (r.is_valid if hasattr(r, "is_valid")
                     else bool(r["is_valid"]))
            by_depth[d]["generated"] += 1
            if valid:
                by_depth[d]["valid"] += 1
                valid_rows.append(r)
        total_generated = len(rows)
    else:
        # saved generator states hold str keys (JSON): one int key per
        # depth, so that partial depths below merge and sort with them
        by_depth = {int(d): v for d, v in (by_depth_counts or {}).items()}
        valid_rows = list(valid_rows or [])
        total_generated = sum(v["generated"] for v in by_depth.values())
        # an aborted-mid-depth run stores valid rows for a depth whose
        # generated/unique totals never reached a barrier — show them as
        # a partial depth instead of silently dropping the row counts
        # from the table (no-audit runs take this path; reject rows are
        # not persisted, so 'generated' for the partial depth is
        # genuinely unknown)
        seen = set(by_depth)
        partial = defaultdict(int)
        for r in valid_rows:
            d = int(r.depth if hasattr(r, "depth") else r["depth"])
            if d not in seen:
                partial[d] += 1
        for d, nv in partial.items():
            by_depth[d] = {"generated": 0, "valid": nv, "partial": True}
    for r in valid_rows:
        name = (r.paper_solution_name if hasattr(r, "paper_solution_name")
                else r["paper_solution_name"])
        if name:
            expr = (r.expression if hasattr(r, "expression")
                    else r["expression"])
            paper_found.setdefault(name, expr)

    # Novel-class grouping (valid, non-paper)
    novel_classes = []
    novel_note = novel_class_note
    novel = [r for r in valid_rows
             if not (r.paper_solution_name if hasattr(r, "paper_solution_name")
                     else r["paper_solution_name"])]
    if novel_class_rows is not None:
        novel = list(novel_class_rows)
        classify_novel = True
    if not classify_novel:
        novel_note = (f"novel-class grouping SKIPPED ({len(novel)} novel "
                      "rows exceed the SymPy classing limit; rerun with "
                      "--print-run-id for full classing)")
    if classify_novel:
        with spans.span("report.classing"):
            cap = max_novel_classes * 10
            if len(novel) > cap:
                extra = (f"novel-class grouping covers the first {cap} of "
                         f"{len(novel)} novel rows")
                novel_note = f"{novel_note}; {extra}" if novel_note else extra
            # shortest-first so a cap keeps the most interpretable rows
            def _elen(r):
                return len(r.expression if hasattr(r, "expression")
                           else r["expression"])
            novel = sorted(novel, key=_elen)
            classes: Dict[str, List[str]] = defaultdict(list)
            for r in novel[:cap]:
                expr = (r.expression if hasattr(r, "expression")
                        else r["expression"])
                classes[_canonical_class_key(expr, problem)].append(expr)
            for key, members in classes.items():
                rep = min(members, key=_expr_cost)
                novel_classes.append({
                    "representative": rep,
                    "count": len(members),
                })
            novel_classes.sort(key=lambda c: _expr_cost(c["representative"]))

    return {
        "run_id": run_id,
        "problem": problem.name,
        "problem_slug": problem.slug,
        "max_depth": max_depth,
        "timestamp": time.strftime("%Y%m%d_%H%M%S"),
        "total_generated": total_generated,
        "total_valid": len(valid_rows),
        "by_depth": {str(d): v for d, v in sorted(by_depth.items())},
        "paper_solutions_found": paper_found,
        "paper_solutions_expected": dict(problem.known_solutions),
        "anchor_only_knowns": dict(
            getattr(problem, "anchor_only_knowns", {}) or {}),
        "novel_classes": novel_classes,
        "novel_classes_note": novel_note,
        "family_breakdown": family_breakdown or {},
        "validator": problem.describe(),
        # the spans' events stay in the run's stats
        "stats": [{k: v for k, v in vars(s).items() if k != "span_events"}
                  for s in (stats or [])],
    }


def write_report_files(report: Dict, output_dir: str) -> Dict[str, str]:
    os.makedirs(output_dir, exist_ok=True)
    ts = report["timestamp"]
    json_path = os.path.join(output_dir, f"reproduction_{ts}.json")
    txt_path = os.path.join(output_dir, f"report_{ts}.txt")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    with open(txt_path, "w") as f:
        f.write(format_report_text(report))
    return {"json": json_path, "txt": txt_path}


def format_report_text(report: Dict) -> str:
    lines = []
    lines.append("=" * 70)
    lines.append(f"DISCOVERY REPORT — {report['problem']}")
    lines.append(f"run_id: {report['run_id']}   max_depth: "
                 f"{report['max_depth']}")
    lines.append("=" * 70)
    lines.append(f"Total generated (unique): {report['total_generated']}")
    lines.append(f"Total valid:              {report['total_valid']}")
    lines.append("")
    lines.append("By depth:")
    for d, v in report["by_depth"].items():
        if v.get("partial"):
            lines.append(f"  depth {d}: (aborted mid-depth) "
                         f"{v['valid']:6d} valid rows stored; "
                         "generated count not recorded")
        else:
            lines.append(f"  depth {d}: {v['generated']:8d} generated, "
                         f"{v['valid']:6d} valid")
    lines.append("")
    expected = report["paper_solutions_expected"]
    found = report["paper_solutions_found"]
    anchor = report.get("anchor_only_knowns", {})
    discoverable = [n for n in expected.values() if n not in anchor]
    n_found = sum(1 for n in discoverable if n in found)
    lines.append(f"Known (paper) solutions found: {n_found}/"
                 f"{len(discoverable)}")
    for name in expected.values():
        if name in anchor and name not in found:
            lines.append(f"  [ANCHR] {name} — {anchor[name]}")
            continue
        mark = "FOUND" if name in found else "  -  "
        via = f"  via {found[name]}" if name in found else ""
        lines.append(f"  [{mark}] {name}{via}")
    lines.append("")
    fams = report.get("family_breakdown") or {}
    if fams:
        total_fam = sum(v["count"] for v in fams.values())
        lines.append(f"Valid-set family breakdown ({total_fam} rows, "
                     "array-level tagging):")
        for nm, v in sorted(fams.items(), key=lambda kv: -kv[1]["count"]):
            note = v.get("note", "")
            note = f"  [{note}]" if note else ""
            lines.append(f"  {v['count']:9d}  {nm}{note}")
            for rep in v.get("representatives", [])[:3]:
                lines.append(f"             e.g. {rep}")
        lines.append("")
    if report.get("novel_classes"):
        lines.append(f"Novel solution classes: {len(report['novel_classes'])}")
        for c in report["novel_classes"][:25]:
            lines.append(f"  ({c['count']:4d}x) {c['representative']}")
    if report.get("novel_classes_note"):
        lines.append(f"  NOTE: {report['novel_classes_note']}")
    lines.append("")
    lines.append(f"Validator: {report['validator'].get('math_definition')}")
    return "\n".join(lines) + "\n"
