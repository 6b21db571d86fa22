"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from .convert import gpt2_state_from_paddle_tpu, llama_state_from_paddle_tpu
from .gpt import (GPT2Attention, GPT2Block, GPT2Config, GPT2ForCausalLM,
                  GPT2MLP, GPT2Model, gpt2_124m_config)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama2_7b_config, llama_tiny_config)

__all__ = ["GPT2Attention", "GPT2Block", "GPT2Config", "GPT2ForCausalLM",
           "GPT2MLP", "GPT2Model", "gpt2_124m_config",
           "gpt2_state_from_paddle_tpu", "LlamaConfig", "LlamaForCausalLM",
           "LlamaModel", "llama2_7b_config", "llama_tiny_config",
           "llama_state_from_paddle_tpu"]
