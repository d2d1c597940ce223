"""Placement forecasting: counterpart of ``nos_tpu/forecast`` (each
pending gang's earliest start, backfill safety, the read-only defrag
advisor and the forecasts' calibration), polled."""
from nos_tpu_torch.forecast.accuracy import CalibrationTracker, nearest_rank
from nos_tpu_torch.forecast.advisor import DefragAdvisor
from nos_tpu_torch.forecast.engine import (
    EXPECTED_COMPLETION_ANNOTATION,
    STAGE_BLOCKED,
    STAGE_FEASIBLE_NOW,
    STAGE_RECARVE,
    BackfillVerdict,
    ForecastEngine,
    ForecastResult,
    GangForecast,
)
from nos_tpu_torch.forecast.forecaster import PlacementForecaster

__all__ = ["BackfillVerdict", "CalibrationTracker", "DefragAdvisor",
           "EXPECTED_COMPLETION_ANNOTATION", "ForecastEngine", "ForecastResult", "GangForecast",
           "PlacementForecaster", "STAGE_BLOCKED", "STAGE_FEASIBLE_NOW", "STAGE_RECARVE",
           "nearest_rank"]
