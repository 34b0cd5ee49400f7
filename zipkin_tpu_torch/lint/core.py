"""ZT-lint core: findings, checker registry, pragmas, baselines, runner.

The framework is deliberately dependency-free (ast + tokenize from the
stdlib) so it runs everywhere tier-1 runs. A checker is a class with a
``rule`` id, a ``severity``, and a ``check(module)`` generator; the
runner parses each file ONCE into a :class:`Module` (tree, parent map,
comment pragmas) shared by every checker, then filters findings through
inline suppressions and an optional baseline.

Suppression pragma grammar (``# zt-lint: disable=ZT01[,ZT04] — reason``):

- on the offending line: suppresses matching findings on that line;
- on its own comment line: applies to the next code line (so long
  justifications don't fight the line length), skipping blank and
  further comment lines;
- either placement on a ``def`` / ``class`` / ``with`` header line:
  suppresses matching findings anywhere inside that statement's body;
- a pragma with NO justification text after the rule list is itself a
  finding (ZT00) — the acceptance bar is "suppressed WITH a reason",
  and the linter enforces its own bar mechanically.
"""

from __future__ import annotations

import ast
import io
import json
import re
import time
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(
    r"#\s*zt-lint\s*:\s*disable\s*=\s*"
    r"(?P<rules>ZT\d{2}(?:\s*,\s*ZT\d{2})*)"
    r"(?P<reason>.*)$"
)

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    rule: str            # "ZT01"
    severity: str        # "error" | "warning"
    path: str            # repo-relative posix path
    line: int            # 1-based
    col: int             # 0-based
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            out += f"  [fix: {self.hint}]"
        return out

    def fingerprint(self, context: str) -> Tuple[str, str, str]:
        """Line-number-independent identity for baseline matching: the
        stripped source line survives unrelated edits above it."""
        return (self.rule, self.path, context)


@dataclass
class Pragma:
    line: int
    rules: Set[str]
    reason: str


class Module:
    """One parsed source file, shared by every checker."""

    def __init__(self, path: Path, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        # parent links let checkers walk OUT of a node (enclosing
        # function / loop / with-block) without re-walking the tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.pragmas: List[Pragma] = list(_parse_pragmas(source))
        # a pragma on its OWN comment line governs the next code line;
        # one trailing a statement governs that statement's line
        self._pragma_by_line: Dict[int, Pragma] = {}
        for p in self.pragmas:
            self._pragma_by_line[self._pragma_target(p.line)] = p
        # the lines each pragma governs: its target line, or the whole of
        # the outermost def/class/with whose header is that line
        self._pragma_span: Dict[int, Tuple[int, int]] = {
            p.line: (self._pragma_target(p.line),) * 2 for p in self.pragmas
        }
        for node in ast.walk(self.tree):
            if not isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.With),
            ):
                continue
            p = self._pragma_by_line.get(node.lineno)
            if p is not None:
                lo, hi = self._pragma_span[p.line]
                self._pragma_span[p.line] = (lo, max(hi, node.end_lineno or node.lineno))
        # top-level import names: "imports torch" gates device-taint rules
        self.imported_roots: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imported_roots.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                self.imported_roots.add(node.module.split(".")[0])

    def _pragma_target(self, line: int) -> int:
        text = self.lines[line - 1].lstrip() if line <= len(self.lines) else ""
        if not text.startswith("#"):
            return line  # trailing pragma: governs its own line
        for nxt in range(line + 1, len(self.lines) + 1):
            t = self.lines[nxt - 1].strip()
            if t and not t.startswith("#"):
                return nxt
        return line  # pragma at EOF: nothing to govern

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def enclosing(self, node: ast.AST, kinds) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                yield cur
            cur = self.parents.get(cur)

    def pragma_span(self, pragma: Pragma) -> Tuple[int, int]:
        """First and last line that ``pragma`` governs."""
        return self._pragma_span[pragma.line]

    def suppressed(self, finding: Finding) -> Optional[Pragma]:
        """The pragma suppressing this finding, if any: exact line, or a
        scoped pragma on a def/class/with header whose span covers it."""
        p = self._pragma_by_line.get(finding.line)
        if p is not None and finding.rule in p.rules:
            return p
        for p in sorted(self.pragmas, key=lambda p: self._pragma_span[p.line]):
            lo, hi = self._pragma_span[p.line]
            if finding.rule in p.rules and lo <= finding.line <= hi:
                return p
        return None


def _parse_pragmas(source: str) -> Iterator[Pragma]:
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            reason = m.group("reason").strip(" \t-—:(").rstrip(")")
            yield Pragma(line=tok.start[0], rules=rules, reason=reason)
    except tokenize.TokenError:  # pragma: no cover - unparsable file
        return


class Checker:
    """Base checker. Subclasses set ``rule``/``severity``/``hint`` and
    implement :meth:`check` (per module) or — with ``whole_program =
    True`` — :meth:`check_program` (once per run, over the call graph),
    yielding findings (use :meth:`found`).

    During a run the shared :class:`~zipkin_tpu_torch.lint.callgraph.CallGraph`
    is bound to ``self.program`` (None when linting without the graph,
    e.g. a single file fed to :meth:`check` directly in a unit test), so
    per-module checkers can consult interprocedural facts — resolve a
    call, walk callers, ask for a cross-module taint summary — without
    rebuilding anything: the graph is built once and shared by every
    rule."""

    rule: str = "ZT??"
    severity: str = "error"
    name: str = ""
    doc: str = ""
    hint: str = ""
    whole_program: bool = False
    program = None  # bound by run_paths for the duration of a run

    def found(
        self, module: Module, node: ast.AST, message: str, hint: str = ""
    ) -> Finding:
        return Finding(
            rule=self.rule,
            severity=self.severity,
            path=module.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=hint or self.hint,
        )

    def check(self, module: Module) -> Iterable[Finding]:
        return ()

    def check_program(self, program) -> Iterable[Finding]:
        return ()

    def graph(self, module: Module):
        """The run's shared CallGraph, or (when a checker is driven
        directly against one module, outside run_paths) a fresh
        single-module graph — resolution semantics are identical."""
        if self.program is not None:
            return self.program
        from zipkin_tpu_torch.lint.callgraph import CallGraph

        return CallGraph([module])


_REGISTRY: Dict[str, Checker] = {}


def register(checker_cls):
    """Class decorator: instantiate + index by rule id. Importing
    ``zipkin_tpu_torch.lint.checkers`` populates the registry."""
    inst = checker_cls()
    _REGISTRY[inst.rule] = inst
    return checker_cls


def all_checkers() -> Dict[str, Checker]:
    from zipkin_tpu_torch.lint import checkers  # noqa: F401 - registers on import

    return dict(sorted(_REGISTRY.items()))


# -- baseline ------------------------------------------------------------


def load_baseline(path) -> Set[Tuple[str, str, str]]:
    """A baseline is the fingerprint set of known findings: matching
    findings are reported as suppressed, so a tree with accepted debt
    still gates NEW violations. Entries: {rule, path, context}."""
    with open(path) as f:
        data = json.load(f)
    return {
        (e["rule"], e["path"], e["context"]) for e in data.get("findings", ())
    }


def write_baseline(path, findings: Sequence[Tuple[Finding, str]]) -> None:
    data = {
        "findings": [
            {"rule": f.rule, "path": f.path, "context": ctx}
            for f, ctx in findings
        ]
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


# -- runner --------------------------------------------------------------


@dataclass
class RunResult:
    findings: List[Finding] = field(default_factory=list)        # live
    suppressed: List[Finding] = field(default_factory=list)      # pragma'd
    baselined: List[Finding] = field(default_factory=list)       # in baseline
    errors: List[str] = field(default_factory=list)              # parse errors
    # the pragma that suppressed each entry of ``suppressed``, same order
    suppressed_pragmas: List[Pragma] = field(default_factory=list)
    # the lines each of those pragmas governs (:meth:`Module.pragma_span`)
    suppressed_spans: List[Tuple[int, int]] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings or self.errors else 0

    def to_dict(self) -> Dict:
        """Machine-readable shape for ``--format json``: every finding
        with rule/path/line plus its pragma status (live findings have
        ``pragma: null``; suppressed ones carry line + reason)."""

        def one(f: Finding, pragma: Optional[Pragma], span=None) -> Dict:
            return {
                "rule": f.rule,
                "severity": f.severity,
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
                "hint": f.hint,
                "pragma": None if pragma is None else {
                    "line": pragma.line,
                    "reason": pragma.reason,
                    "governs": list(span),
                },
            }

        return {
            "findings": [one(f, None) for f in self.findings],
            "suppressed": [
                one(f, p, span)
                for f, p, span in zip(
                    self.suppressed, self.suppressed_pragmas, self.suppressed_spans
                )
            ],
            "baselined": [one(f, None) for f in self.baselined],
            "errors": list(self.errors),
            "stats": dict(self.stats),
            "exit_code": self.exit_code,
        }


def iter_py_files(paths: Sequence, root: Optional[Path] = None) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


# Parse cache: (resolved path, rel) -> (mtime_ns, size, Module). Parsing
# + parent-map construction dominates lint wall time, so repeat runs in
# one process (tier-1 runs the linter several times) only re-parse files
# whose mtime or size changed.
_MODULE_CACHE: Dict[Tuple[str, str], Tuple[int, int, Module]] = {}


def _load_module(path: Path, rel: str) -> Module:
    st = path.stat()
    key = (str(path.resolve()), rel)
    hit = _MODULE_CACHE.get(key)
    if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
        return hit[2]
    module = Module(path, rel, path.read_text())
    _MODULE_CACHE[key] = (st.st_mtime_ns, st.st_size, module)
    return module


def run_paths(
    paths: Sequence,
    select: Optional[Set[str]] = None,
    ignore: Optional[Set[str]] = None,
    baseline: Optional[Set[Tuple[str, str, str]]] = None,
    root: Optional[Path] = None,
) -> RunResult:
    """Lint every .py under ``paths``. ``select``/``ignore`` are rule-id
    sets (select wins first, then ignore removes). ZT00 (suppression
    hygiene) always runs: disabling the meta-rule would let reasonless
    pragmas rot silently.

    Two-phase: every file is parsed first (mtime-cached), the whole-
    program call graph is built ONCE over the parsed set, then each rule
    runs with the graph bound to ``checker.program`` — per-module rules
    over each file, ``whole_program`` rules once over the graph."""
    from zipkin_tpu_torch.lint.callgraph import CallGraph

    t0 = time.monotonic()
    checkers = all_checkers()
    active = {
        rule: c
        for rule, c in checkers.items()
        if (select is None or rule in select or rule == "ZT00")
        and not (ignore and rule in ignore and rule != "ZT00")
    }
    root = Path(root) if root is not None else Path.cwd()
    result = RunResult()
    modules: List[Module] = []
    by_rel: Dict[str, Module] = {}
    for path in iter_py_files(paths):
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            module = _load_module(path, rel)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            result.errors.append(f"{rel}: unparsable: {e}")
            continue
        modules.append(module)
        by_rel[module.rel] = module

    graph = CallGraph(modules)

    def file_findings(checker, module):
        for finding in checker.check(module):
            yield module, finding

    def program_findings(checker):
        # several roots can reach one sink: report each line once
        seen: Set[Tuple[str, str, int, int]] = set()
        for finding in checker.check_program(graph):
            key = (finding.rule, finding.path, finding.line, finding.col)
            if key in seen:
                continue
            seen.add(key)
            module = by_rel.get(finding.path)
            if module is not None:
                yield module, finding

    try:
        for checker in active.values():
            checker.program = graph
        for checker in active.values():
            if checker.whole_program:
                produced = program_findings(checker)
            else:
                produced = (
                    pair
                    for module in modules
                    for pair in file_findings(checker, module)
                )
            for module, finding in produced:
                pragma = module.suppressed(finding)
                if pragma is not None:
                    result.suppressed.append(finding)
                    result.suppressed_pragmas.append(pragma)
                    result.suppressed_spans.append(module.pragma_span(pragma))
                    continue
                if baseline is not None:
                    ctx = module.line_text(finding.line)
                    if finding.fingerprint(ctx) in baseline:
                        result.baselined.append(finding)
                        continue
                result.findings.append(finding)
    finally:
        for checker in active.values():
            checker.program = None
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    result.stats = {
        "files": len(modules),
        "functions": len(graph.functions),
        "edges": graph.n_edges,
        "rules": len(active),
        "elapsed_ms": round((time.monotonic() - t0) * 1000.0, 1),
    }
    return result
