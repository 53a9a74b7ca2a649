"""Representative-region simulation and per-scale calibration: exact DES
on one region of the iteration space (on the host), closed-form
replication of the rest (on the device), and contention scales fitted
*at* the rank count they will be used at."""
from .contention import (ScaleFit, contention_drift, fit_contention_at_scale,
                         scaled_probe_configs, square_grid)
from .region import (RegionHPLSim, RegionSpec, RegionStepSim, as_region)

__all__ = [
    "RegionSpec", "as_region", "RegionHPLSim", "RegionStepSim",
    "ScaleFit", "fit_contention_at_scale", "contention_drift",
    "scaled_probe_configs", "square_grid",
]
