"""ScALPEL core in PyTorch: the JAX package's ``repro.core`` API, eager.

    spec    = scalpel.MonitorSpec / spec_from_mapping / spec_from_discovery
    mon     = scalpel.Monitor(spec, params, device="cuda")
    step    = mon.wrap(step_fn)
    mstate  = mon.init()
    out, mstate = step(mstate, *args)
    print(mon.report(mstate))
"""
from .context import (  # noqa: F401
    EventSpec,
    MonitorSpec,
    ScopeContext,
    spec_from_mapping,
)
from .counters import CounterState, MonitorParams  # noqa: F401
from .events import (  # noqa: F401
    CHANNELS,
    EXTENSIVE,
    INTENSIVE,
    channels_for,
    compute,
    lookup,
    registered,
)
from .instrument import (  # noqa: F401
    Collector,
    current_collector,
    discover,
    function,
    probe,
    scan_with_counters,
    spec_from_discovery,
)
from .monitor import Monitor, MonitorState  # noqa: F401
from .plan import (  # noqa: F401
    CompactDelta,
    MomentPlan,
    ScopePlans,
    SlotLayout,
    compile_scope_plans,
    describe_plans,
    spec_fingerprint,
    spec_layout,
)
from .report import build, estimates, format_text  # noqa: F401
from .runtime import ScalpelRuntime  # noqa: F401
