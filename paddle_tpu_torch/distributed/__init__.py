"""Distributed training (counterpart of ``paddle_tpu/distributed``). Only
activation recompute is ported so far."""
