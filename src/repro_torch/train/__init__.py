"""Training utilities: the optimizers' inits (AdamW and Adafactor) and
AdamW's update (``train.optimizer``; gradient calibration,
``core.calibrate.fit_fastsim_params``, steps with it), and the train
state the checkpoints carry (``train.state``: ``TrainState``,
``make_train_state``).  The training step, the loop and the remaining
updates are still to be ported (ROADMAP §1)."""
from .optimizer import (adafactor_init, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, opt_init)
from .state import TrainState, make_train_state

__all__ = ["adafactor_init", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "opt_init", "TrainState",
           "make_train_state"]
