"""Planner (``dynamo_tpu/planner``): so far only the :class:`WorkerProfile`
that the SLO plane reads; the autoscaler, its predictors and connectors are
not ported yet."""

from dynamo_tpu_torch.planner.core import WorkerProfile

__all__ = ["WorkerProfile"]
