"""Serving of the port: the continuous-batching engine over dense slots
or the paged store.

``paged_cache`` is dependency-light (torch and numpy) and re-exported
eagerly; the engine's symbols resolve lazily (PEP 562), as in the
reference, so that lower layers (models, kernels) can import
``repro_torch.serving.paged_cache`` at module level without pulling
``engine`` -> ``models`` back in a cycle.
"""
from repro_torch.serving.paged_cache import (GARBAGE_PAGE, BlockTables,
                                             PagePool, PagePoolExhausted,
                                             append_chunk, append_token,
                                             gather_pages, pages_needed)

__all__ = ["ERROR_KINDS", "EngineStalledError", "Request", "RequestError",
           "ServingEngine", "sample_token", "GARBAGE_PAGE", "BlockTables",
           "PagePool", "PagePoolExhausted", "append_chunk", "append_token",
           "gather_pages", "pages_needed"]

_ENGINE_EXPORTS = ("ERROR_KINDS", "EngineStalledError", "Request",
                   "RequestError", "ServingEngine", "sample_token")


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from repro_torch.serving import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
