from .compile_cache import enable_compilation_cache
from .device import parse_gpu_query, query_gpus, require_gpu
from .profiling import StageTimer, profile_trace

__all__ = ["StageTimer", "profile_trace", "enable_compilation_cache",
           "parse_gpu_query", "query_gpus", "require_gpu"]
