from .core import (  # noqa: F401
    CPUPlace, CUDAPlace, CustomPlace, Place, TPUPlace,
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128,
    convert_dtype, current_place, device_count, enable_grad, get_default_dtype,
    get_device, is_compiled_with_cuda, is_compiled_with_tpu, is_grad_enabled,
    no_grad, set_default_dtype, set_device, set_grad_enabled, synchronize,
)
from .random import seed, get_rng_state, set_rng_state  # noqa: F401
from .tensor import Parameter, Tensor, to_tensor  # noqa: F401
