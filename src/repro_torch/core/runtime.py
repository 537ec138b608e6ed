"""ScALPEL runtime — the live (spec, params, counters) triple (paper §3.3).

The step loop hands the runtime its newest counters (``on_step`` /
``observe``) and reads the runtime's live params back through
``Monitor.sync``; swapping params (``set_params``) reselects among the
compiled plans and never changes them.  ``on_step`` only swaps a reference:
it reads nothing from the device.  ``snapshot``/``report`` are the
synchronous readers (they wait for the device).

The JAX package's runtime also owns a telemetry ring with a background
drain thread, config-file reload and adaptive hooks; those belong to later
slices of the port.
"""
from __future__ import annotations

import threading

from . import plan as plan_lib
from . import report as report_lib
from .context import MonitorSpec
from .counters import MonitorParams


class ScalpelRuntime:
    def __init__(self, spec: MonitorSpec, params: MonitorParams | None = None,
                 device="cuda"):
        self.spec = spec
        self._lock = threading.Lock()
        self.params = params if params is not None \
            else MonitorParams.all_on(spec)
        self.state = plan_lib.CompactDelta.zeros(spec, device)
        self.steps = 0

    def set_params(self, params: MonitorParams) -> None:
        with self._lock:
            self.params = params

    @property
    def plan_fingerprint(self) -> str:
        """Hash of the compiled probe plans; constant across set_params."""
        return self.spec.fingerprint

    def describe_plans(self) -> str:
        return plan_lib.describe_plans(self.spec)

    def on_step(self, counters) -> None:
        """Record a step's counters: a reference swap, no device read."""
        self.state = counters
        self.steps += 1

    def observe(self, counters) -> None:
        """Update the live counters without counting a step."""
        self.state = counters

    def snapshot(self) -> list[report_lib.ScopeReport]:
        return report_lib.build(self.spec, self.state)

    def estimates(self) -> dict[str, dict[str, float]]:
        return report_lib.estimates(self.spec, self.state)

    def report(self, title: str = "ScALPEL report") -> str:
        return report_lib.format_text(self.snapshot(), title=title)
