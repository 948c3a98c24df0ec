"""The port's kernels. Importing this package builds nothing: see
:mod:`._build` for when and how the CUDA sources are compiled."""

from .attention import (flash_enabled, remat_policy,
                        scaled_dot_product_attention, set_flash_enabled)
from .flash_attn import (flash_attention_bshd, flash_bwd,
                         flash_bwd_reference, flash_fwd,
                         flash_fwd_reference)
from .flash_varlen import (flash_attention_varlen_packed,
                           flash_varlen_bwd_dkv,
                           flash_varlen_bwd_dkv_reference,
                           flash_varlen_bwd_dq, flash_varlen_bwd_dq_reference,
                           flash_varlen_bwd_fused,
                           flash_varlen_bwd_fused_reference,
                           flash_varlen_fwd, flash_varlen_fwd_reference)
from .fused_adamw import (adamw_flat, adamw_flat_reference, adamw_step,
                          adamw_step_multi, adamw_step_reference)
from .fused_ce import fused_linear_cross_entropy
from .fused_layer_norm import (layer_norm_bwd, layer_norm_bwd_reference,
                               layer_norm_fwd, layer_norm_fwd_reference)
from .fused_momentum import (momentum_step, momentum_step_multi,
                             momentum_step_reference)
from .fused_rms_norm import (rms_norm_bwd, rms_norm_bwd_reference,
                             rms_norm_fwd, rms_norm_fwd_reference)
from .fused_rope import rope, rope_reference
from .quant_matmul import (channel_absmax, fp8_matmul,
                           int4_weight_only_matmul, int8_matmul,
                           int8_matmul_reference, int8_weight_only_matmul,
                           int8_weight_only_matmul_reference, pack_int4,
                           quantize_channelwise, unpack_int4,
                           weight_quant_error_bound)

__all__ = ["scaled_dot_product_attention", "remat_policy",
           "flash_enabled", "set_flash_enabled",
           "flash_attention_bshd", "flash_fwd", "flash_fwd_reference",
           "flash_bwd", "flash_bwd_reference",
           "flash_attention_varlen_packed", "flash_varlen_fwd",
           "flash_varlen_fwd_reference", "flash_varlen_bwd_dkv",
           "flash_varlen_bwd_dkv_reference", "flash_varlen_bwd_dq",
           "flash_varlen_bwd_dq_reference", "flash_varlen_bwd_fused",
           "flash_varlen_bwd_fused_reference", "adamw_step",
           "adamw_step_multi",
           "adamw_step_reference", "fused_linear_cross_entropy",
           "momentum_step", "momentum_step_multi", "momentum_step_reference",
           "layer_norm_fwd", "layer_norm_fwd_reference",
           "layer_norm_bwd", "layer_norm_bwd_reference",
           "channel_absmax", "quantize_channelwise",
           "weight_quant_error_bound", "int8_weight_only_matmul",
           "int8_weight_only_matmul_reference", "int4_weight_only_matmul",
           "pack_int4", "unpack_int4", "int8_matmul", "int8_matmul_reference",
           "fp8_matmul", "adamw_flat",
           "adamw_flat_reference", "rms_norm_fwd", "rms_norm_fwd_reference",
           "rms_norm_bwd", "rms_norm_bwd_reference", "rope",
           "rope_reference"]
