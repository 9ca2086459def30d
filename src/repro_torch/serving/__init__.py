"""Serving of the port: the dense-slot continuous-batching engine."""
from repro_torch.serving.engine import (ERROR_KINDS, EngineStalledError,
                                        Request, RequestError,
                                        ServingEngine, sample_token)

__all__ = ["ERROR_KINDS", "EngineStalledError", "Request", "RequestError",
           "ServingEngine", "sample_token"]
