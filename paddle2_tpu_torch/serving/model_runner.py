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

**Costs.** :meth:`PagedGPTRunner.prefill_cost` and
:meth:`~PagedGPTRunner.decode_cost` give the JAX runner's per-program
cost dicts, keyed by padded prompt length and by (batch, pages) bucket.
The JAX runner reads them from XLA's analysis of each compiled program;
the port works them out from the configuration, for any key, without
running anything (:meth:`~PagedGPTRunner.prefill_cost_of`,
:meth:`~PagedGPTRunner.decode_cost_of`):

* ``"flops"``: what ``observability.cost_model.program_cost``
  (``FlopCounterMode``) counts for the call: the matmuls by their
  shapes, ``2·(4h² + 2·h·ffn)`` a row and a layer, the head,
  ``2·h·V`` a row it is applied to, and the flash forward
  (``kernels.flash_attn.attention_flops``) or the paged decode
  (``paged_attention.paged_attention_flops``) a layer by its op's
  formula;
* ``"bytes accessed"``: the port's stand-in for XLA's count, the bytes
  the call must move, with ``s`` the KV dtype's item size::

      every parameter and buffer read once
      + decode (B rows, P pages): L·B·P·bs·H·D·2·s  (K/V pages read)
                                + L·B·H·D·2·s       (K/V rows written)
                                + B·V·s             (logits)
      + prefill (T padded tokens): L·T·H·D·2·s      (K/V rows written)
                                 + V·s              (the last logits)

Without the bytes term a decode step, bound by HBM, would be priced by
its FLOPs alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..kernels.flash_attn import attention_flops
from .block_cache import PagedKVCache
from .paged_attention import paged_attention_decode, paged_attention_flops
from .reliability import WeightSwapError

__all__ = ["PagedGPTRunner", "PREFILL_PAD"]

# prompts are padded to a multiple of 16 tokens; causal masking makes
# the padded tail invisible to every real row
PREFILL_PAD = 16


class PagedGPTRunner:
    """Runs the prefill and decode steps of one ``GPTForCausalLM``.
    Greedy (argmax) decoding, as in the JAX package."""

    def __init__(self, model, num_heads: int, head_dim: int,
                 split_pages: Optional[int] = None, block_size: int = 16):
        self.model = model
        model.eval()
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        # split-K width for the paged-attention kernel (None = the
        # shared-memory fit dispatch of paged_attention_decode)
        self.split_pages = split_pages
        # the KV cache's block size, which a decode bucket's cost reads
        self.block_size = int(block_size)
        self._decode_buckets: Set[Tuple[int, int]] = set()
        # cost dicts already worked out, by key
        self._costs: Dict[tuple, dict] = {}

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

    # -- costs ---------------------------------------------------------
    def _param_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.weights())

    def _kv_token_bytes(self) -> int:
        """K and V of one token over every layer."""
        cfg = self.model.cfg
        item = self.model.gpt.wte.weight.element_size()
        return 2 * cfg.num_layers * self.num_heads * self.head_dim * item

    def prefill_bytes(self, padded_len: int) -> float:
        cfg = self.model.cfg
        item = self.model.gpt.wte.weight.element_size()
        return float(self._param_bytes()
                     + padded_len * self._kv_token_bytes()
                     + cfg.vocab_size * item)

    def decode_bytes(self, batch: int, n_pages: int,
                     block_size: int) -> float:
        cfg = self.model.cfg
        item = self.model.gpt.wte.weight.element_size()
        return float(self._param_bytes()
                     + batch * (n_pages * block_size + 1)
                     * self._kv_token_bytes()
                     + batch * cfg.vocab_size * item)

    def _block_flops(self, rows: int) -> int:
        """The matmuls of ``rows`` tokens through every block."""
        cfg = self.model.cfg
        h, ffn = cfg.hidden_size, cfg.ffn_size
        return rows * cfg.num_layers * 2 * (4 * h * h + 2 * h * ffn)

    def prefill_cost_of(self, padded_len: int) -> dict:
        """The cost dict of a prefill of ``padded_len`` tokens: every
        token through the blocks, the head on the last one, the flash
        forward over the ``T x T`` square a layer, and
        :meth:`prefill_bytes`."""
        key = ("prefill", int(padded_len))
        if key not in self._costs:
            cfg, T = self.model.cfg, int(padded_len)
            flops = (self._block_flops(T) + 2 * cfg.hidden_size
                     * cfg.vocab_size + cfg.num_layers * attention_flops(
                         1, self.num_heads, T, T, self.head_dim,
                         self.head_dim))
            self._costs[key] = {"flops": float(flops),
                                "bytes accessed": self.prefill_bytes(T)}
        return self._costs[key]

    def decode_cost_of(self, batch: int, n_pages: int,
                       block_size: int) -> dict:
        """The cost dict of a decode at bucket ``(batch, n_pages)``: each
        row through the blocks and the head, the paged decode's formula
        a layer, and :meth:`decode_bytes`."""
        key = ("decode", int(batch), int(n_pages), int(block_size))
        if key not in self._costs:
            cfg = self.model.cfg
            flops = (self._block_flops(batch) + batch * 2 * cfg.hidden_size
                     * cfg.vocab_size + cfg.num_layers * paged_attention_flops(
                         batch, self.num_heads, n_pages, block_size,
                         self.head_dim, self.split_pages))
            self._costs[key] = {
                "flops": float(flops),
                "bytes accessed": self.decode_bytes(batch, n_pages,
                                                    block_size)}
        return self._costs[key]

    def prefill_cost(self, padded_len: int) -> dict:
        return self.prefill_cost_of(padded_len)

    def decode_cost(self, bucket: Tuple[int, int]) -> dict:
        batch, n_pages = bucket
        return self.decode_cost_of(batch, n_pages, self.block_size)

    # -- steps -----------------------------------------------------------
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
