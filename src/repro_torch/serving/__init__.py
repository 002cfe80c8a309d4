from repro_torch.serving.kv_cache import KVCacheConfig, TieredKVCache
from repro_torch.serving.engine import (
    AdmissionError,
    EngineConfig,
    Request,
    ServingEngine,
)

__all__ = [
    "AdmissionError",
    "EngineConfig",
    "KVCacheConfig",
    "Request",
    "ServingEngine",
    "TieredKVCache",
]
