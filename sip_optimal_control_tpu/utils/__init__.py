from .derivative_check import check_derivatives
from .profiling import trace_solve
from .checkpoint import load_warm_start, save_warm_start
from .compile_cache import enable_compile_cache
