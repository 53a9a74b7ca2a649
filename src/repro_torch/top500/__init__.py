"""TOP500 ingestion: list rows -> Platform specs -> fleet prediction.

The pipeline the paper's Table II does by hand, run over a whole list:

    from repro_torch.top500 import load_sample, predict_fleet
    report = predict_fleet(load_sample())     # the sweep on the GPU
    for e in report.ranked()[:10]:
        print(e.platform.name, e.calibrated_tflops, e.published_tflops)

Stages (one module each):
  rows.py       versioned ``Top500Row`` schema + tolerant CSV/TSV parser
  infer.py      processor/interconnect strings -> ``Platform`` specs,
                with overridable heuristic tables and provenance records
  fleet.py      memory-rule auto-tuning + ONE forced-bucket batched
                sweep for the whole fleet (scale-proxied, one bucket
                program)
  calibrate.py  per-fabric-family residual factor, train/held-out split

Registry interop: ``bulk_register(infer_platforms(rows),
namespace="top500")`` exposes an ingested list to everything that
speaks platform names (serving, benchmarks) without touching built-ins.
"""
from .rows import (ROW_SCHEMA_VERSION, SAMPLE_EDITIONS, ParseReport,
                   Top500Row, list_sample_editions, load_sample,
                   parse_top500, sample_list_path)
from .infer import (ACCEL_PEAKS, CPU_FAMILIES, CPUFamilyRule,
                    FABRIC_FAMILIES, FabricFamilyRule, fabric_group,
                    infer_platform, infer_platforms, memory_sized_n)
from .fleet import (FleetEntry, FleetReport, FleetTuning, fleet_bucket,
                    predict_fleet, tune_scenario)
from .calibrate import (CalibrationResult, DESCalibration,
                        assign_splits, calibrate_against_des,
                        calibrate_fleet)

__all__ = [
    "ROW_SCHEMA_VERSION", "SAMPLE_EDITIONS", "ParseReport", "Top500Row",
    "list_sample_editions", "load_sample", "parse_top500",
    "sample_list_path",
    "ACCEL_PEAKS", "CPU_FAMILIES", "CPUFamilyRule", "FABRIC_FAMILIES",
    "FabricFamilyRule", "fabric_group", "infer_platform",
    "infer_platforms", "memory_sized_n",
    "FleetEntry", "FleetReport", "FleetTuning", "fleet_bucket",
    "predict_fleet", "tune_scenario",
    "CalibrationResult", "DESCalibration", "assign_splits",
    "calibrate_against_des", "calibrate_fleet",
]
