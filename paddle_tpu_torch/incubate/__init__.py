"""Incubating serving functionals (counterpart of ``paddle_tpu/incubate``).
Ported: ``nn.functional.block_gqa_attention``."""
