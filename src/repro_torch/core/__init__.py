"""The simulator core: the discrete-event engine with its library models
(SimBLAS, SimMPI) and the TPU/XLA adaptation (SimXLA), the vectorized
HPL recurrence (``fastsim``) with gradient calibration, the §V what-if
grid, and the dry-run-record predictions (``predict_cell``,
``predict_cell_des``, ``whatif``, ``load_record``), which read a compiled
cell's record and run on the host."""
from .engine import Engine, Event, Process
from .simblas import SimBLAS
from .simmpi import SimMPI
from .calibrate import (calibrate, measure_dgemm, fit_linear,
                        fit_fastsim_params)
from .fastsim import (FastSimParams, bucket_key, simulate_hpl_fast,
                      simulate_time_traced, sweep_hpl, trace_count)
from .simxla import SimXLA, ICIParams, ICI, collective_time
from .predict import (predict_cell, predict_cell_des, whatif, whatif_grid,
                      load_record)

__all__ = ["Engine", "Event", "Process", "SimBLAS", "SimMPI", "calibrate",
           "measure_dgemm", "fit_linear", "fit_fastsim_params",
           "FastSimParams", "bucket_key", "simulate_hpl_fast", "sweep_hpl",
           "simulate_time_traced", "trace_count", "SimXLA", "ICIParams",
           "ICI", "collective_time", "predict_cell", "predict_cell_des",
           "whatif", "whatif_grid", "load_record"]
