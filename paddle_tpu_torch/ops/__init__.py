"""Kernel tier of the port (counterpart of ``paddle_tpu/ops/pallas``)."""
