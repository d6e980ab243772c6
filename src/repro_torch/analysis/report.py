"""Shared finding type for the port's static verifier passes.

Every analysis pass (:mod:`~repro_torch.analysis.contracts`,
:mod:`~repro_torch.analysis.conservation`,
:mod:`~repro_torch.analysis.lint`) returns a flat list of
:class:`Violation` records; the CLI (``python -m repro_torch.analysis``)
aggregates them and exits nonzero when any survive. Each record names the
*invariant* that was violated (``code``), where it was violated
(``where`` — a survey name, an exchange lane, or ``file:line``), and an
actionable message saying what to change. The codes are the JAX
package's (``repro.analysis``), so a finding means the same in both.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Violation:
    """One violated invariant, found statically (no device execution)."""

    passname: str   # "contracts" | "conservation" | "lint"
    code: str       # stable invariant id, e.g. "fold-carry-dtype-drift"
    where: str      # survey / lane / file:line the finding anchors to
    message: str    # what is wrong and how to fix it

    def __str__(self) -> str:
        return f"[{self.passname}:{self.code}] {self.where}: {self.message}"


def format_report(violations: list[Violation]) -> str:
    """Human-readable multi-line report, grouped by pass."""
    if not violations:
        return "OK: no violations"
    lines = [f"{len(violations)} violation(s):"]
    for v in violations:
        lines.append(f"  {v}")
    return "\n".join(lines)
