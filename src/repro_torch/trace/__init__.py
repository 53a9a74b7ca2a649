"""DES observability: per-rank timelines, Chrome-trace export, and
critical-path analysis.

Turn it on at any public layer — ``Engine(trace=True)``,
``HPLSim(cfg, platform, trace=True)``, ``platform.des(trace=True)``,
``TransformerStepSim(..., trace=True)`` — then::

    res = HPLSim(cfg, platform, trace=True).run()
    res.trace.to_chrome_json("run.json")     # open in ui.perfetto.dev
    res.trace.summary()                      # breakdowns + critical path

See DESIGN.md §13 for the recorder lifecycle and overhead contract.
"""
from .analysis import (CriticalPath, collective_breakdown, critical_path,
                       phase_breakdown, rank_breakdown, summarize)
from .chrome import REQUIRED_KEYS, to_chrome_json, validate_chrome_events
from .recorder import NULL_RECORDER, Message, Span, TraceRecorder

__all__ = [
    "TraceRecorder", "NULL_RECORDER", "Span", "Message",
    "to_chrome_json", "validate_chrome_events", "REQUIRED_KEYS",
    "rank_breakdown", "phase_breakdown", "collective_breakdown",
    "critical_path", "CriticalPath", "summarize",
]
