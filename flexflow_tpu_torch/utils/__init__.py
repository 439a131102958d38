from .logger import RecursiveLogger
from .profiling import Profiler, profile_region, sync
