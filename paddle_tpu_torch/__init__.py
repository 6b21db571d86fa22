"""PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. Every Pallas kernel on a
ported path becomes a hand-written Hopper kernel under ``ops/hopper/``,
built from its source with ``nvcc`` at first use. Nothing here imports JAX
or ``paddle_tpu``.

Ported so far: Llama serving through ``models.LlamaForCausalLM.generate``
(prefill, then greedy decode over a dense KV cache) and through
``inference.ContinuousBatcher`` (slots, bucketed prefill, host token pick,
deadlines and shedding, its decode step replayed as a CUDA graph) and
``inference.PagedContinuousBatcher`` (a page pool with reserve or
on-demand paging and preemption, the radix prefix cache's device tier,
chunked prefill; its decode step a CUDA graph too); Llama
and GPT-2
training (``jit.TrainStep``, ``amp.decorate`` O2, ``optimizer.AdamW``),
GPT-2's with the flash kernels' in-kernel attention dropout; and
``nn.functional_extras.sparse_attention``.
"""
from .device import default_device, on_hopper, to_torch_dtype

__all__ = ["default_device", "on_hopper", "to_torch_dtype"]
