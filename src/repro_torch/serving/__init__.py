"""Serving of the port: the continuous-batching engine over dense slots
or the paged store.

``paged_cache`` and ``faults`` are dependency-light (torch and numpy)
and re-exported eagerly; the engine's and the invariant audit's symbols
resolve lazily (PEP 562), as in the reference, so that lower layers
(models, kernels) can import ``repro_torch.serving.paged_cache`` at
module level without pulling ``engine`` -> ``models`` back in a cycle.
"""
from repro_torch.serving.faults import (FAULT_POINTS, RECOVERABLE_POINTS,
                                        FaultInjector, FaultSpec, SwapFailed,
                                        checksum)
from repro_torch.serving.paged_cache import (GARBAGE_PAGE, BlockTables,
                                             PagePool, PagePoolExhausted,
                                             PrefixIndex, append_chunk,
                                             append_token, copy_page,
                                             gather_pages, pages_needed,
                                             swap_in, swap_out)

__all__ = ["ERROR_KINDS", "EngineStalledError", "Request", "RequestError",
           "ServingEngine", "sample_token", "GARBAGE_PAGE", "BlockTables",
           "PagePool", "PagePoolExhausted", "PrefixIndex", "append_chunk",
           "append_token", "copy_page", "gather_pages", "pages_needed",
           "swap_in", "swap_out", "SwapFailed", "checksum", "FAULT_POINTS",
           "RECOVERABLE_POINTS", "FaultInjector", "FaultSpec",
           "InvariantViolation", "audit", "scheduler_dump"]

_ENGINE_EXPORTS = ("ERROR_KINDS", "EngineStalledError", "Request",
                   "RequestError", "ServingEngine", "sample_token")
_INVARIANT_EXPORTS = ("InvariantViolation", "audit", "scheduler_dump")


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from repro_torch.serving import engine
        return getattr(engine, name)
    if name in _INVARIANT_EXPORTS:
        from repro_torch.serving import invariants
        return getattr(invariants, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
