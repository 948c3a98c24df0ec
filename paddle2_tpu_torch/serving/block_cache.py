"""Paged KV cache: fixed-size blocks + per-sequence block tables.

Counterpart of ``paddle2_tpu/serving/block_cache.py`` (the vLLM
PagedAttention memory model). The KV cache of every sequence lives in
one pool of fixed-size blocks per layer, and each sequence owns an
ordered list of block ids, its block table. Appending a token copies
nothing: the new K/V lands in the next free slot of the sequence's last
block, and a fresh block is taken from the free list only when the last
one is full.

* :class:`BlockAllocator` / :class:`BlockTable` are host bookkeeping
  (free list, per-sequence id lists, high-water mark).
* :class:`PagedKVCache` owns the device pools, one
  ``[layers, num_blocks, block_size, heads, head_dim]`` tensor for K and
  one for V, and writes into them IN PLACE. In place stands for the JAX
  package's donation of the pools to its compiled programs: the same
  memory is updated, and no copy of a pool is ever made.

Block 0 is reserved as the garbage block: padded (inactive) rows of a
bucketed decode batch point their tables at it, so their writes land
somewhere harmless and never clobber a live sequence.

The prefix cache, the host tier and the copy-on-write block copy belong
to a later slice (ROADMAP serving queue).
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np
import torch

__all__ = ["BlockAllocator", "BlockTable", "PagedKVCache",
           "blocks_for_tokens", "GARBAGE_BLOCK", "OutOfBlocksError",
           "BlockFreeError"]

# physical block id every padded/inactive batch row writes into
GARBAGE_BLOCK = 0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` (ceil division)."""
    return -(-int(n_tokens) // int(block_size))


class OutOfBlocksError(RuntimeError):
    """Free list exhausted — the scheduler turns this into an eviction."""


class BlockFreeError(ValueError):
    """A ``free()`` that would corrupt the free list: double free, free
    of the reserved garbage block 0, an out-of-range id, or a duplicate
    within the freed list. The whole list is validated before anything
    changes."""


class BlockAllocator:
    """LIFO free-list allocator over ``num_blocks`` fixed-size blocks.

    Block 0 (:data:`GARBAGE_BLOCK`) is reserved and never handed out.
    ``high_water`` is the peak number of blocks allocated at once."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._used: Set[int] = set()
        self.high_water = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._used)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)} free "
                f"(of {self.num_blocks - 1} usable)")
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        self.high_water = max(self.high_water, len(self._used))
        return out

    def free(self, blocks: List[int]) -> None:
        seen = set()
        for b in blocks:
            if b == GARBAGE_BLOCK:
                raise BlockFreeError(
                    f"free of reserved garbage block {GARBAGE_BLOCK}")
            if not 0 < b < self.num_blocks:
                raise BlockFreeError(f"bad block id {b} (usable range "
                                     f"1..{self.num_blocks - 1})")
            if b not in self._used:
                raise BlockFreeError(f"double free of block {b}")
            if b in seen:
                raise BlockFreeError(
                    f"block {b} appears twice in one free() call")
            seen.add(b)
        for b in blocks:
            self._used.remove(b)
            self._free.append(b)


class BlockTable:
    """One sequence's ordered block ids and its count of written
    tokens; the table grows lazily through its allocator."""

    def __init__(self, allocator: BlockAllocator):
        self._alloc = allocator
        self.blocks: List[int] = []
        self.num_tokens = 0

    def ensure_capacity(self, n_tokens: int) -> None:
        """Grow the table to hold ``n_tokens``. Raises
        :class:`OutOfBlocksError` (the eviction trigger), leaving the
        table unchanged, when the free list cannot cover the growth."""
        need = blocks_for_tokens(n_tokens, self._alloc.block_size) \
            - len(self.blocks)
        if need > 0:
            self.blocks.extend(self._alloc.allocate(need))

    def append_slot(self) -> tuple:
        """(physical_block, offset) for the next token, growing the
        table when the last block is full. Bumps ``num_tokens``."""
        self.ensure_capacity(self.num_tokens + 1)
        bs = self._alloc.block_size
        slot = (self.blocks[self.num_tokens // bs], self.num_tokens % bs)
        self.num_tokens += 1
        return slot

    def release(self) -> None:
        """Return every block to the allocator (eviction or finish)."""
        if self.blocks:
            self._alloc.free(self.blocks)
        self.blocks = []
        self.num_tokens = 0

    def padded(self, n_pages: int) -> np.ndarray:
        """int32 table row padded to ``n_pages`` with the garbage block
        (dead pages are masked by the context length)."""
        row = np.full((n_pages,), GARBAGE_BLOCK, np.int32)
        row[:len(self.blocks)] = self.blocks
        return row


class PagedKVCache:
    """Device pools for a whole model: K and V, each
    ``[num_layers, num_blocks, block_size, num_heads, head_dim]``.

    Pools start zeroed; stale values in freed blocks are harmless, since
    the decode kernels never read a slot past a sequence's context."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_heads: int, head_dim: int, dtype="float32",
                 device: Optional[torch.device] = None):
        if dtype not in _DTYPES:
            raise ValueError(f"kv dtype {dtype!r} not in {list(_DTYPES)}")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = _DTYPES[dtype]
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)

    @property
    def block_bytes(self) -> int:
        """Bytes one block holds across K+V and all layers."""
        return (2 * self.num_layers * self.block_size * self.num_heads
                * self.head_dim * self.k.element_size())

    def bytes_for_blocks(self, n_blocks: int) -> int:
        return n_blocks * self.block_bytes

    @staticmethod
    def scatter_decode(pool, layer: int, phys, slot, new_kv) -> None:
        """In place: ``pool[layer, phys[b], slot[b]] = new_kv[b]``.
        pool ``[L, N, bs, H, D]``; phys/slot int64 ``[B]`` on the pool's
        device; new_kv ``[B, H, D]``."""
        pool[layer, phys, slot] = new_kv.to(pool.dtype)

    @staticmethod
    def scatter_prefill(pool, layer_kv, block_row, n_tokens: int,
                        block_size: int, start: int = 0) -> None:
        """In place: write positions ``[start, n_tokens)`` of a prefilled
        sequence's K or V into its blocks. pool ``[L, N, bs, H, D]``;
        layer_kv ``[L, T, H, D]`` with ``T >= n_tokens`` (the prefill
        may run padded); block_row: the sequence's physical block ids."""
        start, n = int(start), int(n_tokens)
        if start >= n:
            return
        idx = np.arange(start, n)
        phys = torch.as_tensor(np.asarray(block_row)[idx // block_size],
                               dtype=torch.long, device=pool.device)
        slot = torch.as_tensor(idx % block_size, dtype=torch.long,
                               device=pool.device)
        pool[:, phys, slot] = layer_kv[:, start:n].to(pool.dtype)

    @staticmethod
    def gather_dense(pool_layer, block_row, n_pages: int):
        """Dense ``[n_pages*bs, H, D]`` view of one sequence's K or V
        through its block table."""
        idx = torch.as_tensor(np.asarray(block_row[:n_pages]),
                              dtype=torch.long, device=pool_layer.device)
        g = pool_layer[idx]
        return g.reshape(-1, *g.shape[2:])
