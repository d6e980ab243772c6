"""Static checks of the port's surveys (the counterpart of the JAX
package's ``repro.analysis``). So far: the fold-determinism verdict that
the planner stamps into ``EngineConfig.determinism``."""
from repro_torch.analysis.contracts import (BITWISE, DEFAULT_WIDTHS,
                                            ORDER_SENSITIVE, UNKNOWN,
                                            classify_determinism)

__all__ = ["BITWISE", "DEFAULT_WIDTHS", "ORDER_SENSITIVE", "UNKNOWN",
           "classify_determinism"]
