"""Serving core: Engine x StemmerWorkload (and TextAnalysisWorkload, text
in) over a versioned DictStore, and Engine x LMDecodeWorkload (the
ServeEngine facade) for the dense-attention LMs. ``faults`` is the
deterministic fault-injection harness (FaultPlan/FaultInjector) and the
FailureInfo that terminally failed requests carry; ``journal`` the
write-ahead request log behind ``Engine.recover``; ``health`` the event
stream and the degradation ladder."""
from repro_torch.serve.dict_store import (DictSnapshotError, DictStore,
                                          DictValidationError, DictVersion,
                                          validate_handle)
from repro_torch.serve.engine import (DrainReport, Engine, EngineUndrained,
                                      InflightTile, LMDecodeWorkload,
                                      QueueFull, Request, ServeEngine,
                                      StemmerWorkload, StemRequest, Workload)
from repro_torch.serve.faults import (DeviceLost, FailureInfo, FaultInjector,
                                      FaultPlan, FaultSpec, InjectedFault)
from repro_torch.serve.health import (DegradationPolicy, EngineEvent,
                                      EventLog, ServingMode, build_ladder)
from repro_torch.serve.journal import (Journal, JournalError, RecoveryReport,
                                       payload_digest, response_digest)
from repro_torch.serve.text import TextAnalysisWorkload, TextRequest

__all__ = [
    "DegradationPolicy", "DeviceLost", "DictSnapshotError", "DictStore",
    "DictValidationError", "DictVersion", "DrainReport", "Engine",
    "EngineEvent", "EngineUndrained", "EventLog", "FailureInfo",
    "FaultInjector", "FaultPlan", "FaultSpec", "InflightTile",
    "InjectedFault", "Journal", "JournalError", "LMDecodeWorkload",
    "QueueFull", "RecoveryReport", "Request", "ServeEngine",
    "ServingMode", "StemRequest", "StemmerWorkload",
    "TextAnalysisWorkload", "TextRequest", "Workload", "build_ladder",
    "payload_digest", "response_digest", "validate_handle",
]
