"""Serving core: Engine x StemmerWorkload over a versioned DictStore."""
from repro_torch.serve.dict_store import (DictStore, DictValidationError,
                                          DictVersion, validate_handle)
from repro_torch.serve.engine import (DrainReport, Engine, EngineUndrained,
                                      InflightTile, StemmerWorkload,
                                      StemRequest, Workload)

__all__ = [
    "DictStore", "DictValidationError", "DictVersion", "DrainReport",
    "Engine", "EngineUndrained", "InflightTile", "StemRequest",
    "StemmerWorkload", "Workload", "validate_handle",
]
