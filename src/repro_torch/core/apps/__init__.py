"""Application models on the discrete-event simulator: HPL (``hpl``:
``HPLConfig``, ``HPLSim``) and one transformer training step
(``transformer``: ``TransformerStepSim``)."""
from .hpl import HPLConfig, HPLResult, HPLSim, numroc

__all__ = ["HPLConfig", "HPLResult", "HPLSim", "numroc"]
