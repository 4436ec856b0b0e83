"""Engine telemetry (``dynamo_tpu/observability``): so far only the flight
recorder (:mod:`flight`). The JAX package's metrics registry and its
federation, the worker debug endpoints (``/debug/flight/{worker}``, traces,
incidents, explain, cost, profile), the compile tracker, anomaly sentinel,
incident capture, loss attribution and the device-cost plane are not ported
yet (ROADMAP A10)."""

from dynamo_tpu_torch.observability.flight import CRASH, STEP, FlightRecorder

__all__ = ["CRASH", "STEP", "FlightRecorder"]
