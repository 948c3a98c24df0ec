"""Serving: continuous batching over a paged KV cache, on the port's
CUDA kernels. Counterpart of ``paddle2_tpu.serving``."""

from .block_cache import (BlockAllocator, BlockFreeError, BlockTable,
                          GARBAGE_BLOCK, OutOfBlocksError, PagedKVCache,
                          blocks_for_tokens)
from .engine import EngineConfig, ServingEngine
from .model_runner import PREFILL_PAD, PagedGPTRunner
from .paged_attention import (gathered_dense_kv, paged_attention_decode,
                              paged_attention_reference,
                              paged_attention_split_reference,
                              paged_decode, paged_decode_split_partials)
from .reliability import (EngineFailedError, PromptTooLongError,
                          RequestRejected, ServingError)
from .scheduler import (ContinuousBatchingScheduler, Request,
                        SchedulerConfig, Sequence, SeqState)

__all__ = [
    "BlockAllocator", "BlockFreeError", "BlockTable", "GARBAGE_BLOCK",
    "OutOfBlocksError", "PagedKVCache", "blocks_for_tokens",
    "EngineConfig", "ServingEngine", "PREFILL_PAD", "PagedGPTRunner",
    "gathered_dense_kv", "paged_attention_decode",
    "paged_attention_reference", "paged_attention_split_reference",
    "paged_decode", "paged_decode_split_partials",
    "EngineFailedError", "PromptTooLongError", "RequestRejected",
    "ServingError", "ContinuousBatchingScheduler", "Request",
    "SchedulerConfig", "Sequence", "SeqState",
]
