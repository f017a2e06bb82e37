"""Models of the port."""
from .convert import (
    from_jax_state_dict, gpt_pipe_jax_name, layer_rules,
    port_state_dict_from_jax,
    shard_model, shard_state_dict, shard_state_dict_from_jax,
    unshard_state_dict,
)
from .gpt import (
    GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTForCausalLMPipe, GPTModel,
    GPTPretrainingCriterion, gpt2_345m, gpt3_13b, gpt_tiny,
)
from .llama import (
    LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM, LlamaModel, llama2_13b,
    llama2_70b, llama2_7b, llama_tiny,
)

__all__ = ["from_jax_state_dict", "port_state_dict_from_jax", "shard_model",
           "shard_state_dict", "unshard_state_dict",
           "shard_state_dict_from_jax", "gpt_pipe_jax_name", "layer_rules",
           "GPT_CONFIGS",
           "GPTConfig", "GPTForCausalLM", "GPTForCausalLMPipe", "GPTModel",
           "GPTPretrainingCriterion", "gpt2_345m", "gpt3_13b",
           "gpt_tiny",
           "LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama2_13b", "llama2_70b", "llama2_7b", "llama_tiny"]
