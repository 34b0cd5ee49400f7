"""ZT-lint CLI: ``python -m zipkin_tpu_torch.lint [paths] [options]``.

Exit code 0 = clean (after pragmas, --select/--ignore, and --baseline
filtering); 1 = live findings or unparsable files. Designed to gate
tier-1 (tests/test_lint_clean.py runs the same entry in-process).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from zipkin_tpu_torch.lint.core import (
    all_checkers,
    iter_py_files,
    load_baseline,
    run_paths,
    write_baseline,
)


def _rule_set(spec):
    if not spec:
        return None
    rules = {r.strip().upper() for r in spec.split(",") if r.strip()}
    known = set(all_checkers())
    unknown = rules - known
    if unknown:
        raise SystemExit(
            f"zt-lint: unknown rule(s) {sorted(unknown)}; "
            f"known: {sorted(known)}"
        )
    return rules


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m zipkin_tpu_torch.lint",
        description="ZT-lint: static analysis of the PyTorch/CUDA port's invariants",
    )
    p.add_argument(
        "paths",
        nargs="*",
        default=["zipkin_tpu_torch"],
        help="files or directories to lint (default: zipkin_tpu_torch)",
    )
    p.add_argument(
        "--select",
        metavar="RULES",
        help="comma-separated rule ids to run (e.g. ZT01,ZT04); "
        "ZT00 always runs",
    )
    p.add_argument(
        "--ignore",
        metavar="RULES",
        help="comma-separated rule ids to skip (ZT00 cannot be skipped)",
    )
    p.add_argument(
        "--baseline",
        metavar="FILE",
        help="JSON baseline of accepted findings to filter out",
    )
    p.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="write the current live findings as a baseline and exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    p.add_argument(
        "-q", "--quiet", action="store_true", help="findings only, no summary"
    )
    p.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format: human-readable text (default) or one JSON "
        "document (findings + suppressions + run stats) on stdout",
    )
    p.add_argument(
        "--stats",
        action="store_true",
        help="print run statistics (files, call-graph size, wall time) "
        "after the summary",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, checker in all_checkers().items():
            print(f"{rule}  {checker.name:28s} {checker.doc}")
        return 0
    baseline = load_baseline(args.baseline) if args.baseline else None
    result = run_paths(
        args.paths,
        select=_rule_set(args.select),
        ignore=_rule_set(args.ignore),
        baseline=baseline,
        root=Path.cwd(),
    )
    if args.format == "json" and not args.write_baseline:
        # one machine-readable document on stdout, nothing else — the
        # CI consumer parses stdout and keys off the exit code
        print(json.dumps(result.to_dict(), indent=2, sort_keys=True))
        return result.exit_code
    for err in result.errors:
        print(f"ERROR {err}", file=sys.stderr)
    if args.write_baseline:
        # fingerprints need each finding's source-line context
        entries = []
        by_path = {}
        for f in result.findings:
            lines = by_path.setdefault(
                f.path, Path(f.path).read_text().splitlines()
            )
            ctx = lines[f.line - 1].strip() if f.line <= len(lines) else ""
            entries.append((f, ctx))
        write_baseline(args.write_baseline, entries)
        print(
            f"wrote {len(entries)} finding(s) to baseline "
            f"{args.write_baseline}"
        )
        return 0
    for f in result.findings:
        print(f.render())
    if not args.quiet:
        n_files = len(list(iter_py_files(args.paths)))
        print(
            f"zt-lint: {len(result.findings)} finding(s) in {n_files} "
            f"file(s); {len(result.suppressed)} suppressed by pragma, "
            f"{len(result.baselined)} baselined",
            file=sys.stderr,
        )
    if args.stats:
        s = result.stats
        print(
            "zt-lint stats: {files} file(s), {functions} function(s), "
            "{edges} call edge(s), {rules} rule(s), {elapsed_ms:.0f} ms".format(
                **{k: s.get(k, 0) for k in
                   ("files", "functions", "edges", "rules", "elapsed_ms")}
            ),
            file=sys.stderr,
        )
    return result.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
