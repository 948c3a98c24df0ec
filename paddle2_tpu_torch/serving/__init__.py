"""Serving: continuous batching over a paged KV cache, on the port's
CUDA kernels. Counterpart of ``paddle2_tpu.serving``.

Ported: the engine and its scheduler, the paged KV cache with refcounted
copy-on-write blocks, the prefix cache and its host tier
(:class:`HostKVTier`), speculative decoding (``spec``), admission
control with priority shedding, deadlines and an SLO ledger
(``reliability``), engine failure, recovery and adoption, weight hot
swap (:class:`HotSwapController`), the serving simulator
(``simulate``: :func:`simulate_serving`,
:func:`simulate_predictor_baseline`, :func:`simulate_router`), the
failover router (:class:`EngineFailoverRouter`) and the fleet's peer KV
tier (:class:`FleetKVRegistry`), with the metrics, flight-recorder,
tracing and chaos hooks. Names are exported in the JAX package's order,
the port's own after them.

Not ported yet: loading a saved artifact (ROADMAP serving queue, item
6).
"""

from .block_cache import (BlockAllocator, BlockTable, PagedKVCache,
                          PrefixCache, HostKVTier, audit_kv_ledger,
                          blocks_for_tokens, GARBAGE_BLOCK)
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
from .simulate import (ServingSimReport, simulate_serving,
                       simulate_predictor_baseline, poisson_trace,
                       diurnal_poisson_trace,
                       EngineFailoverRouter, RouterSimReport,
                       simulate_router, FleetKVRegistry)

__all__ = [
    "BlockAllocator", "BlockTable", "PagedKVCache", "PrefixCache",
    "HostKVTier", "audit_kv_ledger", "blocks_for_tokens",
    "GARBAGE_BLOCK", "OutOfBlocksError", "BlockFreeError",
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
    "ServingSimReport", "simulate_serving", "simulate_predictor_baseline",
    "poisson_trace", "diurnal_poisson_trace",
    "EngineFailoverRouter", "RouterSimReport", "simulate_router",
    "FleetKVRegistry",
    # the port's own
    "PREFILL_PAD", "PagedGPTRunner", "paged_decode",
    "paged_decode_split_partials",
]
