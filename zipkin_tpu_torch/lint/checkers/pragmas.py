"""ZT00 — suppression hygiene (meta-rule, always active).

The acceptance bar for every other rule is "fixed or suppressed WITH a
reason"; this rule makes the linter enforce its own bar: a
``# zt-lint: disable=...`` pragma whose rule list is followed by no
justification text is itself a finding. ZT00 cannot be deselected
(core.run_paths pins it) — otherwise reasonless pragmas rot silently.
"""

from __future__ import annotations

from zipkin_tpu_torch.lint.core import Checker, Finding, Module, register


@register
class SuppressionHygiene(Checker):
    rule = "ZT00"
    severity = "error"
    name = "suppression-hygiene"
    doc = "zt-lint pragma without a justification"
    hint = "append the reason: # zt-lint: disable=ZTxx — why this is safe"

    def check(self, module: Module):
        for pragma in module.pragmas:
            if not pragma.reason:
                yield Finding(
                    rule=self.rule,
                    severity=self.severity,
                    path=module.rel,
                    line=pragma.line,
                    col=0,
                    message=(
                        "suppression without justification: "
                        f"disable={','.join(sorted(pragma.rules))}"
                    ),
                    hint=self.hint,
                )
