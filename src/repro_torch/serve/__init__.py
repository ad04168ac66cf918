"""Serving core: Engine x StemmerWorkload (and TextAnalysisWorkload, text
in) over a versioned DictStore, and Engine x LMDecodeWorkload (the
ServeEngine facade) for the dense-attention LMs."""
from repro_torch.serve.dict_store import (DictStore, DictValidationError,
                                          DictVersion, validate_handle)
from repro_torch.serve.engine import (DrainReport, Engine, EngineUndrained,
                                      FailureInfo, InflightTile,
                                      LMDecodeWorkload, Request, ServeEngine,
                                      StemmerWorkload, StemRequest, Workload)
from repro_torch.serve.text import TextAnalysisWorkload, TextRequest

__all__ = [
    "DictStore", "DictValidationError", "DictVersion", "DrainReport",
    "Engine", "EngineUndrained", "FailureInfo", "InflightTile",
    "LMDecodeWorkload", "Request", "ServeEngine", "StemRequest",
    "StemmerWorkload", "TextAnalysisWorkload", "TextRequest", "Workload",
    "validate_handle",
]
