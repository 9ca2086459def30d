"""KQ-SVD core of the port: the closed-form solvers (numpy, float64) and
the compressed-cache ops (torch).

Public API:
    Factors, KeyProjection, ValueProjection, solve_key, solve_value
    GramAccumulator, ModelProjections, calibrate_model
    energy_rank, select_rank
    compress_kv, compress_queries, cache_footprint
"""
from repro_torch.core.calibration import (GramAccumulator, ModelProjections,
                                          calibrate_model)
from repro_torch.core.compressed import (cache_footprint, compress_kv,
                                         compress_queries)
from repro_torch.core.projections import (Factors, KeyProjection,
                                          ValueProjection,
                                          key_projection_from_caches,
                                          solve_key, solve_value,
                                          value_projection_from_caches)
from repro_torch.core.rank_selection import energy_rank, select_rank

__all__ = [
    "Factors", "KeyProjection", "ValueProjection", "solve_key",
    "solve_value", "key_projection_from_caches",
    "value_projection_from_caches", "GramAccumulator", "ModelProjections",
    "calibrate_model", "energy_rank", "select_rank", "compress_kv",
    "compress_queries", "cache_footprint",
]
