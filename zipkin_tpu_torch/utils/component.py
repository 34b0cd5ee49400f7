"""Component lifecycle and health contract.

The port's own copy of ``zipkin_tpu/utils/component.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/Component.java`` and ``zipkin2/CheckResult.java``
(SURVEY.md §2.1). Everything storage- or collector-shaped participates in the
same lifecycle: a ``check()`` that returns OK or an error (never raises), and
``close()`` for teardown. The server's ``/health`` endpoint aggregates
``check()`` over every registered component.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """Outcome of a health check: OK, or an error with the causing exception."""

    ok: bool
    error: Optional[BaseException] = None

    @staticmethod
    def failed(error: BaseException) -> "CheckResult":
        return CheckResult(ok=False, error=error)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return "OK" if self.ok else f"FAILED({self.error!r})"


CheckResult.OK = CheckResult(ok=True)  # type: ignore[attr-defined]


class Component:
    """Base for storages, collectors, and other lifecycle'd parts.

    ``check()`` must never raise: implementations catch and wrap failures in a
    failed :class:`CheckResult` so one sick component cannot take down the
    health endpoint.
    """

    def check(self) -> CheckResult:
        return CheckResult.OK  # type: ignore[attr-defined]

    def close(self) -> None:
        """Release resources. Idempotent."""

    def __enter__(self) -> "Component":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
