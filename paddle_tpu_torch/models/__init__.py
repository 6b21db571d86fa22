"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from .convert import llama_state_from_paddle_tpu
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama2_7b_config, llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama2_7b_config", "llama_tiny_config",
           "llama_state_from_paddle_tpu"]
