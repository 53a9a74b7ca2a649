"""Training: the optimizers (``train.optimizer``: AdamW and Adafactor,
their inits and updates and ``opt_state_specs``; gradient calibration,
``core.calibrate.fit_fastsim_params``, steps with AdamW), the train state
the checkpoints carry (``train.state``: ``TrainState``,
``make_train_state``), the training step (``train.step``:
``make_train_step``, ``train_step``, and ``state_specs``, the state's
logical sharding specs) and the training loop (``train.loop``:
``train``; its launcher is ``repro_torch.launch.train``)."""
from .optimizer import (adafactor_init, adafactor_update, adamw_init,
                        adamw_update, clip_by_global_norm, global_norm,
                        opt_init, opt_state_specs, opt_update)
from .state import TrainState, make_train_state
from .step import make_train_step, state_specs, train_step
from .loop import train

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "global_norm",
           "opt_init", "opt_update", "opt_state_specs", "TrainState",
           "make_train_state", "state_specs", "train_step",
           "make_train_step", "train"]
