from .convert import (ernie_state_from_reference, gpt_state_from_reference,
                      load_quanted_reference, load_weight_only_reference,
                      nn_state_from_reference, resnet_state_from_reference)
from .ernie import (ErnieConfig, ErnieForSequenceClassification, ErnieLayer,
                    ErnieModel, ErnieSelfAttention, ernie3_base, ernie_tiny)
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTMLP, GPTModel, gpt3_1p3b, gpt_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt3_1p3b", "gpt_small", "gpt_tiny",
           "ErnieConfig", "ErnieSelfAttention", "ErnieLayer", "ErnieModel",
           "ErnieForSequenceClassification", "ernie3_base", "ernie_tiny",
           "gpt_state_from_reference", "ernie_state_from_reference",
           "resnet_state_from_reference", "load_weight_only_reference",
           "load_quanted_reference", "nn_state_from_reference"]
