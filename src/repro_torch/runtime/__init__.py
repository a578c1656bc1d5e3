"""The device runtime: binary cache and the multi-SM executor."""
from .registry import (CODE_BUCKETS, GMEM_MIN_WORDS, Module, ModuleRegistry,
                       bucket, bucket_code_len, bucket_gmem_len, pad_code)
from .executor import (BLOCK_SCHED_OVERHEAD, DeviceGrid, GridResult,
                       LaunchSpec, MultiSMReport, execute, run_grid)
