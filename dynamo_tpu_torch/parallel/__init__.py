"""Parallel execution helpers of the port (counterpart of ``dynamo_tpu/parallel``):
so far the routed-MoE dispatch of one device (``moe.py``)."""
