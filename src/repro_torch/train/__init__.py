"""Training utilities.  So far only AdamW (``train.optimizer``), which
gradient calibration (``core.calibrate.fit_fastsim_params``) steps with;
the training step, loop and Adafactor wait for slice 8c of the port
(ROADMAP §1)."""
from .optimizer import adamw_init, adamw_update, clip_by_global_norm, \
    global_norm

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm"]
