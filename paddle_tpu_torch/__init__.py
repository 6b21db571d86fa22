"""PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. Every Pallas kernel on a
ported path becomes a hand-written Hopper kernel under ``ops/hopper/``,
built from its source with ``nvcc`` at first use. Nothing here imports JAX
or ``paddle_tpu``.

Ported so far: Llama serving (prefill, then greedy decode over a dense KV
cache) through ``models.LlamaForCausalLM.generate``.
"""
from .device import default_device, on_hopper, to_torch_dtype

__all__ = ["default_device", "on_hopper", "to_torch_dtype"]
