"""KQ-SVD core of the port: the closed-form solvers (numpy, float64) and
the compressed-cache ops (torch).

Public API:
    Factors, KeyProjection, ValueProjection, solve_key, solve_value
    GramAccumulator, ModelProjections, calibrate_model
    energy_rank, select_rank
    compress_kv, compress_queries, cache_footprint, projection_param_bytes
    make_calibrate_step, accumulator_from_grams (Grams summed on the device)
"""
from repro_torch.core.calibration import (GramAccumulator, ModelProjections,
                                          accumulator_from_grams,
                                          calibrate_model,
                                          make_calibrate_step)
from repro_torch.core.compressed import (cache_footprint, compress_kv,
                                         compress_queries,
                                         projection_param_bytes)
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
    "compress_queries", "cache_footprint", "projection_param_bytes",
    "make_calibrate_step", "accumulator_from_grams",
]
