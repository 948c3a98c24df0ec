"""Prefill and decode steps for GPT-family models over the paged KV
cache.

Counterpart of ``paddle2_tpu/serving/model_runner.py``. The decode step
cannot reuse ``GPTModel.decode_step``, whose KV cache is a growing
per-layer concat — exactly the contiguous layout paging replaces — so
the runner rewires one block step from the model's own sublayers
(ln_1 -> fused head-major qkv -> paged append -> paged attention ->
out_proj -> MLP). Prefill does go through ``decode_step`` with empty
caches: it computes every prompt position's K/V in one causal pass
(the flash kernel), and the engine scatters them into the sequence's
blocks.

The JAX package compiled one program per (batch, pages) bucket and per
padded prompt length. The port runs eagerly under
``torch.inference_mode()``, so there are no programs to cache; it still
counts the distinct decode buckets it has run
(:attr:`PagedGPTRunner.num_decode_programs`), so the scheduler's bucket
bound keeps its meaning: the count of distinct decode shapes stays
within ``len(batch_buckets) * len(page_buckets)``.

Rows of one decode batch may share a block table: a speculative verify
round brings ``k + 1`` rows of one sequence at positions
``p0 .. p0 + k``. Each layer scatters every row's K/V before its
attention reads them, and each row's context length (its position + 1)
hides the later rows from it, so row ``i`` attends exactly as a plain
step at ``p0 + i`` would.

The JAX runner passes its weights to compiled programs as arguments and
swaps them by passing others. The port's steps read the live model, so
:meth:`PagedGPTRunner.swap_weights` copies the new tensors into the
model's parameters and buffers in place, after checking every shape and
dtype (a swap is all or nothing). Two engines built on one model object
therefore see each other's swaps.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from .block_cache import PagedKVCache
from .paged_attention import paged_attention_decode
from .reliability import WeightSwapError

__all__ = ["PagedGPTRunner", "PREFILL_PAD"]

# prompts are padded to a multiple of 16 tokens; causal masking makes
# the padded tail invisible to every real row
PREFILL_PAD = 16


class PagedGPTRunner:
    """Runs the prefill and decode steps of one ``GPTForCausalLM``.
    Greedy (argmax) decoding, as in the JAX package."""

    def __init__(self, model, num_heads: int, head_dim: int,
                 split_pages: Optional[int] = None):
        self.model = model
        model.eval()
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        # split-K width for the paged-attention kernel (None = the
        # shared-memory fit dispatch of paged_attention_decode)
        self.split_pages = split_pages
        self._decode_buckets: Set[Tuple[int, int]] = set()

    @property
    def device(self) -> torch.device:
        return self.model.gpt.wte.weight.device

    @property
    def num_decode_programs(self) -> int:
        return len(self._decode_buckets)

    @staticmethod
    def state_of(model) -> List[torch.Tensor]:
        """A model's parameters, then its buffers, in module order: the
        weight list :meth:`swap_weights` takes and returns."""
        return list(model.parameters()) + list(model.buffers())

    def weights(self) -> List[torch.Tensor]:
        """The live weight tensors of the served model."""
        return self.state_of(self.model)

    @torch.no_grad()
    def swap_weights(self, tensors) -> List[torch.Tensor]:
        """Copy ``tensors`` (one a weight of :meth:`weights`, same shape
        and dtype, on any device) into the live weights in place.
        Everything is checked before anything is copied: a mismatch
        raises :class:`~.reliability.WeightSwapError` and changes
        nothing. Returns copies of the previous weights (the rollback
        payload)."""
        live = self.weights()
        tensors = list(tensors)
        if len(tensors) != len(live):
            raise WeightSwapError(f"swap payload has {len(tensors)} "
                                  f"tensors, the model {len(live)}")
        for t, new in zip(live, tensors):
            if not isinstance(new, torch.Tensor):
                raise WeightSwapError(f"swap payload holds a "
                                      f"{type(new).__name__}, not a tensor")
            if tuple(new.shape) != tuple(t.shape) or new.dtype != t.dtype:
                raise WeightSwapError(
                    f"swap tensor mismatch: got {tuple(new.shape)}/"
                    f"{new.dtype}, the model has {tuple(t.shape)}/"
                    f"{t.dtype}")
        prev = [t.detach().clone() for t in live]
        for t, new in zip(live, tensors):
            t.copy_(new)
        return prev

    @staticmethod
    def pad_len(n: int, max_pos: int) -> int:
        padded = -(-n // PREFILL_PAD) * PREFILL_PAD
        return min(padded, max_pos) if n <= max_pos else n

    def prefill_padded_len(self, n: int) -> int:
        return self.pad_len(n, self.model.cfg.max_position_embeddings)

    @torch.inference_mode()
    def prefill(self, token_ids: List[int]):
        """Run one sequence's prompt; returns ``(first_token, k_stack,
        v_stack)`` with stacks ``[L, padded_len, H, D]`` — the caller
        scatters rows ``[:len(token_ids)]`` into blocks."""
        model = self.model
        n = len(token_ids)
        padded = self.prefill_padded_len(n)
        ids = torch.zeros((1, padded), dtype=torch.long, device=self.device)
        ids[0, :n] = torch.as_tensor(token_ids, dtype=torch.long)
        hidden, caches = model.gpt.decode_step(
            ids, [() for _ in range(model.cfg.num_layers)], 0)
        logits = model._head(hidden[:, n - 1])
        tok = int(torch.argmax(logits.float(), dim=-1)[0])
        k_stack = torch.stack([c[0][0] for c in caches])
        v_stack = torch.stack([c[1][0] for c in caches])
        return tok, k_stack, v_stack

    @torch.inference_mode()
    def decode(self, cache: PagedKVCache, ids: np.ndarray,
               positions: np.ndarray, block_tables: np.ndarray) -> np.ndarray:
        """One decode step over a bucketed batch: ids ``[B, 1]``,
        positions ``[B]`` (the 0-based slot of the new token),
        block_tables ``[B, P]``. Appends each layer's K/V to ``cache`` in
        place and returns the next tokens ``[B]``."""
        model = self.model
        dev = self.device
        B, n_pages = block_tables.shape
        nh, hd = self.num_heads, self.head_dim
        bs = cache.block_size
        self._decode_buckets.add((B, n_pages))
        pos_np = np.asarray(positions, np.int64)
        tables = torch.as_tensor(np.asarray(block_tables, np.int32),
                                 device=dev)
        phys = tables[torch.arange(B, device=dev),
                      torch.as_tensor(pos_np // bs, device=dev)].long()
        slot = torch.as_tensor(pos_np % bs, device=dev)
        ctx = torch.as_tensor((pos_np + 1).astype(np.int32), device=dev)
        pos = torch.as_tensor(pos_np, device=dev)[:, None]
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        x = model.gpt.wte(ids_t) + model.gpt.wpe(pos)
        for li, block in enumerate(model.gpt.blocks()):
            qkv = block.attn.qkv(block.ln_1(x))
            # head-major fused split, as GPTAttention.forward
            q, k, v = qkv.reshape(B, 1, nh, 3, hd).unbind(3)
            PagedKVCache.scatter_decode(cache.k, li, phys, slot, k[:, 0])
            PagedKVCache.scatter_decode(cache.v, li, phys, slot, v[:, 0])
            attn = paged_attention_decode(
                q.contiguous(), cache.k[li], cache.v[li], tables, ctx,
                pages_per_split=self.split_pages)
            x = x + block.dropout(block.attn.out_proj(
                attn.reshape(B, 1, nh * hd)))
            x = x + block.dropout(block.mlp(block.ln_2(x)))
        logits = model._head(model.gpt.ln_f(x))
        return torch.argmax(logits[:, -1].float(), dim=-1).cpu().numpy()
