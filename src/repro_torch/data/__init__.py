from repro_torch.data.synthetic import (DataConfig, batches,
                                        calibration_batches, sample_batch)

__all__ = ["DataConfig", "batches", "calibration_batches", "sample_batch"]
