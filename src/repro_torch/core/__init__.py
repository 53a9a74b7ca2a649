"""The simulator core: the vectorized HPL recurrence (``fastsim``) and the
hardware and application models it is built from.  The discrete-event
engine, SimBLAS/SimMPI and calibration wait for later slices of the
port."""
from .fastsim import (FastSimParams, bucket_key, simulate_hpl_fast,
                      simulate_time_traced, sweep_hpl, trace_count)

__all__ = ["FastSimParams", "bucket_key", "simulate_hpl_fast", "sweep_hpl",
           "simulate_time_traced", "trace_count"]
