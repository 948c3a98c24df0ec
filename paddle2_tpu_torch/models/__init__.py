from .convert import gpt_state_from_reference, load_weight_only_reference
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTMLP, GPTModel, gpt3_1p3b, gpt_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt3_1p3b", "gpt_small", "gpt_tiny",
           "gpt_state_from_reference", "load_weight_only_reference"]
