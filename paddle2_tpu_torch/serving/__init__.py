"""Serving: continuous batching over a paged KV cache, on the port's
CUDA kernels. Counterpart of ``paddle2_tpu.serving``.

Ported: the engine and its scheduler, the paged KV cache with refcounted
copy-on-write blocks and the prefix cache, speculative decoding
(``spec``), admission control with priority shedding, deadlines and an
SLO ledger (``reliability``), engine failure, recovery and adoption,
and weight hot swap (:class:`HotSwapController`). Names are exported in
the JAX package's order, the port's own after them.

Not ported yet, each with its ROADMAP serving-queue item: the host tier
and fleet KV (``HostKVTier``, ``FleetKVRegistry``, item 3), the serving
simulator and its failover router (``serving/simulate.py``), artifact
load (item 6) and the observability hooks (item 7).
"""

from .block_cache import (BlockAllocator, BlockTable, PagedKVCache,
                          PrefixCache, audit_kv_ledger, blocks_for_tokens,
                          GARBAGE_BLOCK)
from .block_cache import OutOfBlocksError, BlockFreeError
from .paged_attention import (paged_attention_decode,
                              paged_attention_reference,
                              paged_attention_split_reference,
                              gathered_dense_kv, paged_decode,
                              paged_decode_split_partials)
from .spec import SpeculativeConfig, ngram_draft, accept_drafts
from .reliability import (ServingError, RequestRejected, QueueFullError,
                          PromptTooLongError, DeadlineExceeded,
                          EngineFailedError, WeightSwapError,
                          ReliabilityConfig, SLOConfig,
                          HotSwapController)
from .scheduler import (Request, Sequence, SeqState,
                        ContinuousBatchingScheduler, SchedulerConfig)
from .engine import ServingEngine, EngineConfig
from .model_runner import PREFILL_PAD, PagedGPTRunner

__all__ = [
    "BlockAllocator", "BlockTable", "PagedKVCache", "PrefixCache",
    "audit_kv_ledger", "blocks_for_tokens", "GARBAGE_BLOCK",
    "OutOfBlocksError", "BlockFreeError",
    "paged_attention_decode", "paged_attention_reference",
    "paged_attention_split_reference", "gathered_dense_kv",
    "SpeculativeConfig", "ngram_draft", "accept_drafts",
    "ServingError", "RequestRejected", "QueueFullError",
    "PromptTooLongError", "DeadlineExceeded", "EngineFailedError",
    "WeightSwapError", "ReliabilityConfig", "SLOConfig",
    "HotSwapController",
    "Request", "Sequence", "SeqState", "ContinuousBatchingScheduler",
    "SchedulerConfig",
    "ServingEngine", "EngineConfig",
    "PREFILL_PAD", "PagedGPTRunner", "paged_decode",
    "paged_decode_split_partials",
]
