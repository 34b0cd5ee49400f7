"""ZT11 — shm seqlock write/read discipline on registered regions.

The cross-process tiers share mutable state with NO locks: a writer
makes the generation word odd, mutates the payload, then re-evens the
generation; a reader snapshots the generation, copies, and retries when
the generation was odd or changed. Nothing but convention stops a new
method from writing a payload word outside the bracket — and a torn
read of that word is a once-a-week production mystery, not a test
failure. This rule makes the convention mechanical over the four
REGISTERED regions:

==================  =========================  =========================
region              generation word(s)         protected payload
==================  =========================  =========================
tpu/ring.py         ``hdr[_S_GEN]``            ``_S_PIDX``..``_S_PUBLISH_NS``
                    (slot headers)             (the ``_S_*`` payload words)
tpu/mirror.py       ``self.gen``               ``self._snap``
                    (epoch)
obs/critpath.py     ``_OFF_GEN_D``/``_OFF_GEN_W``  ``_OFF_N_D``/``_OFF_N_W``/
                    (ledger slots)             ``_OFF_D_IV``/``_OFF_W_IV``
obs/recorder.py     ``h.gen``                  ``counts``/``sums``/``maxes``
                    (snapshots)
==================  =========================  =========================

State-machine words (ring ``_S_STATE``/``_S_PID``, critpath
``_OFF_STATE``/``_OFF_FLAGS``/timestamps) are deliberately NOT
protected: they are single-word transitions whose visibility protocol
is the state value itself, not the generation.

Three shapes are flagged, per function in a region module
(``__init__`` is exempt — construction precedes sharing):

- **W1 unstamped write**: a protected-payload write in a function with
  no generation stamp (``gen_word += 1``). Relaxed interprocedurally:
  when every in-graph caller is itself a stamping function of the same
  module, the callee inherits the caller's bracket (split-helper
  idiom). A function with ONE stamp participates in a cross-function
  bracket (ring: ``try_claim`` odds, ``publish`` re-evens) and passes.
- **W2 write outside the bracket**: in a function with a full bracket
  (two or more stamps), a protected write before the first or after
  the last stamp.
- **R1 unvalidated read**: a pure reader (no protected writes, no
  stamps) that consults the generation word exactly ONCE alongside a
  protected read — it can observe a torn value and has no way to know.
  Zero generation reads is legal (the function reads an immutable
  copy someone else validated); two or more is the retry/recheck
  idiom this rule cannot distinguish further syntactically.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from zipkin_tpu_torch.lint.core import Checker, Module, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

# ring payload words: every _S_* slot-header constant EXCEPT the
# generation itself and the state-machine words
_RING_EXEMPT = {"_S_GEN", "_S_STATE", "_S_PID"}


class _Region:
    """One registered seqlock region: how to spot its generation word
    and its protected payload in source."""

    __slots__ = ("suffix", "label", "gen_kind", "gen_names",
                 "prot_kind", "prot_names", "prot_prefix", "prot_exempt")

    def __init__(self, suffix, label, gen_kind, gen_names, prot_kind,
                 prot_names=frozenset(), prot_prefix="",
                 prot_exempt=frozenset()):
        self.suffix = suffix
        self.label = label
        self.gen_kind = gen_kind          # "index" | "attr"
        self.gen_names = gen_names
        self.prot_kind = prot_kind        # "index" | "index_prefix" | "attr"
        self.prot_names = prot_names
        self.prot_prefix = prot_prefix
        self.prot_exempt = prot_exempt

    # -- matchers ---------------------------------------------------------

    def _index_names(self, node: ast.Subscript) -> Set[str]:
        return {
            n.id for n in ast.walk(node.slice) if isinstance(n, ast.Name)
        }

    def is_gen(self, node: ast.AST) -> bool:
        if self.gen_kind == "index":
            return isinstance(node, ast.Subscript) and bool(
                self._index_names(node) & self.gen_names
            )
        return isinstance(node, ast.Attribute) and node.attr in self.gen_names

    def is_protected(self, node: ast.AST) -> bool:
        if self.prot_kind == "attr":
            # h.counts, h.counts[i], self._snap ...
            if isinstance(node, ast.Subscript):
                node = node.value
            return (
                isinstance(node, ast.Attribute)
                and node.attr in self.prot_names
            )
        if not isinstance(node, ast.Subscript):
            return False
        names = self._index_names(node)
        if self.prot_kind == "index_prefix":
            return any(
                n.startswith(self.prot_prefix) and n not in self.prot_exempt
                for n in names
            )
        return bool(names & self.prot_names)


REGIONS: Tuple[_Region, ...] = (
    _Region(
        suffix="zipkin_tpu_torch/tpu/ring.py",
        label="span-ring slot header",
        gen_kind="index", gen_names=frozenset({"_S_GEN"}),
        prot_kind="index_prefix", prot_prefix="_S_",
        prot_exempt=frozenset(_RING_EXEMPT),
    ),
    _Region(
        suffix="zipkin_tpu_torch/tpu/mirror.py",
        label="mirror epoch",
        gen_kind="attr", gen_names=frozenset({"gen"}),
        prot_kind="attr", prot_names=frozenset({"_snap"}),
    ),
    _Region(
        suffix="zipkin_tpu_torch/obs/critpath.py",
        label="critpath ledger slot",
        gen_kind="index", gen_names=frozenset({"_OFF_GEN_D", "_OFF_GEN_W"}),
        prot_kind="index",
        prot_names=frozenset({"_OFF_N_D", "_OFF_N_W", "_OFF_D_IV",
                              "_OFF_W_IV"}),
    ),
    _Region(
        suffix="zipkin_tpu_torch/obs/recorder.py",
        label="recorder histogram",
        gen_kind="attr", gen_names=frozenset({"gen"}),
        prot_kind="attr", prot_names=frozenset({"counts", "sums", "maxes"}),
    ),
)


def _store_targets(stmt: ast.AST):
    if isinstance(stmt, ast.Assign):
        return stmt.targets
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    return []


@register
class SeqlockDiscipline(Checker):
    rule = "ZT11"
    severity = "error"
    name = "seqlock-discipline"
    doc = (
        "registered shm seqlock regions: payload writes bracketed by "
        "generation stamps; readers validate the generation"
    )
    hint = (
        "bracket payload writes with gen += 1 (odd) ... gen += 1 "
        "(even); readers re-read the generation after copying"
    )

    def check(self, module: Module):
        region = None
        for r in REGIONS:
            if module.rel.endswith(r.suffix) or module.rel == r.suffix:
                region = r
                break
        if region is None:
            return
        stampers: Set[str] = set()
        facts: List[Tuple[ast.AST, Dict]] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, _FUNC_KINDS) or fn.name == "__init__":
                continue
            f = self._function_facts(region, fn)
            facts.append((fn, f))
            if f["stamps"]:
                stampers.add(fn.name)
        for fn, f in facts:
            yield from self._judge(module, region, fn, f, stampers)

    # -- per-function fact extraction -------------------------------------

    def _function_facts(self, region: _Region, fn: ast.AST) -> Dict:
        stamps: List[int] = []      # lineno of each gen_word += 1
        writes: List[ast.AST] = []  # protected-payload store nodes
        prot_reads = 0
        gen_reads = 0
        own = [n for n in ast.walk(fn)
               if not (isinstance(n, _FUNC_KINDS) and n is not fn)]
        # exclude nested defs' bodies: they are their own functions
        nested: Set[int] = set()
        for n in ast.walk(fn):
            if isinstance(n, _FUNC_KINDS) and n is not fn:
                nested.update(id(x) for x in ast.walk(n))
        for node in own:
            if id(node) in nested:
                continue
            if isinstance(node, ast.AugAssign) and isinstance(
                node.op, ast.Add
            ) and region.is_gen(node.target):
                stamps.append(node.lineno)
                continue
            for tgt in _store_targets(node):
                if region.is_protected(tgt):
                    writes.append(tgt)
            if isinstance(node, (ast.Subscript, ast.Attribute)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load):
                if region.is_protected(node):
                    prot_reads += 1
                elif region.is_gen(node):
                    gen_reads += 1
        return {
            "stamps": sorted(stamps),
            "writes": writes,
            "prot_reads": prot_reads,
            "gen_reads": gen_reads,
        }

    # -- verdicts ---------------------------------------------------------

    def _judge(self, module, region, fn, f, stampers):
        stamps, writes = f["stamps"], f["writes"]
        if writes and not stamps:
            if not self._callers_all_stamp(module, fn, stampers):
                for w in writes:
                    yield self.found(
                        module, w,
                        f"unstamped write to the {region.label} — no "
                        f"generation stamp anywhere in {fn.name}(), so a "
                        "concurrent reader can observe this word torn",
                    )
            return
        if writes and len(stamps) >= 2:
            first, last = stamps[0], stamps[-1]
            for w in writes:
                if w.lineno < first or w.lineno > last:
                    side = "before the odd" if w.lineno < first else \
                        "after the closing even"
                    yield self.found(
                        module, w,
                        f"{region.label} write {side} generation stamp "
                        f"in {fn.name}() — outside the seqlock bracket",
                    )
            return
        if not writes and not stamps and f["prot_reads"]:
            if f["gen_reads"] == 1:
                yield self.found(
                    module, fn,
                    f"{fn.name}() reads the {region.label} payload but "
                    "samples the generation only once — a torn copy "
                    "cannot be detected; re-read the generation after "
                    "copying and retry on odd/changed",
                )

    def _callers_all_stamp(self, module, fn, stampers) -> bool:
        """Split-helper relaxation: every in-graph caller (same module)
        is a stamping function, so the callee runs inside the caller's
        bracket. No graph or no callers ⇒ no relaxation."""
        if self.program is None:
            return False
        qual = self.program.qual_of(fn)
        if qual is None:
            return False
        callers = [
            self.program.functions[c]
            for c in self.program.callers_of(qual)
            if c in self.program.functions
        ]
        callers = [c for c in callers if c.module_rel == module.rel]
        return bool(callers) and all(c.name in stampers for c in callers)
