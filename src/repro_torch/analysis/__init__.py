"""Static determinism & plan-conservation verifier of the port
(``python -m repro_torch.analysis``), the counterpart of the JAX
package's ``repro.analysis``, with its codes.

Three passes, none of which runs on a card:

1. :mod:`~repro_torch.analysis.contracts` — each survey's
   ``init``/``update``/``merge``/``merge_epochs`` algebra, run on small
   CPU tensors, and its determinism verdict (``bitwise`` /
   ``order_sensitive`` / ``unknown``), which the planner stamps into
   ``EngineConfig.determinism``;
2. :mod:`~repro_torch.analysis.conservation` — plan/exchange
   conservation: the transports' static routing maps are injective and
   fully covered, a mesh's round schedule covers its caps exactly once,
   and the stamped plan reconciles word for word with its
   ``VolumeReport``;
3. :mod:`~repro_torch.analysis.lint` — AST hygiene rules (no host
   coercion of fold values, no float scatter-add accumulators in core,
   stamps read only via the provenance helper, every CUDA kernel has a
   host oracle and a plain version, every CUDA source is bound).
"""
from repro_torch.analysis.conservation import (check_exchange, check_plan,
                                               check_schedule)
from repro_torch.analysis.contracts import (BITWISE, DEFAULT_WIDTHS,
                                            ORDER_SENSITIVE, UNKNOWN,
                                            VERDICTS, builtin_surveys,
                                            check_fold_contract,
                                            classify_determinism)
from repro_torch.analysis.lint import (check_kernel_oracles, lint_file,
                                       lint_repo)
from repro_torch.analysis.report import Violation, format_report

__all__ = [
    "BITWISE", "DEFAULT_WIDTHS", "ORDER_SENSITIVE", "UNKNOWN", "VERDICTS",
    "Violation", "builtin_surveys", "check_exchange", "check_fold_contract",
    "check_kernel_oracles", "check_plan", "check_schedule",
    "classify_determinism", "format_report", "lint_file", "lint_repo",
]
