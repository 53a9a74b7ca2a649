"""Serving: LM token serving (``ServeEngine``) and the prediction
services (``PredictionService``, ``HPLPredictionService``) with their
result cache and warm pool — the port of ``repro.serve``."""
from .cache import ResultCache, as_result_cache, request_key
from .engine import ServeEngine, Request
from .predict import (HPLPredictionService, PredictRequest,
                      PredictionService, WorkloadRequest, predict_top500,
                      warm)

__all__ = ["ServeEngine", "Request", "HPLPredictionService",
           "PredictRequest", "PredictionService", "WorkloadRequest",
           "ResultCache", "as_result_cache", "request_key",
           "predict_top500", "warm"]
