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

**Copy-on-write sharing.** Every allocated block carries a refcount.
``allocate`` hands blocks out at 1, :meth:`BlockAllocator.share` adds an
owner, and ``free`` drops one reference, returning the block to the free
list only at 0: releasing a sequence never takes blocks from a sibling
that shares them. Shared blocks are always full (appends touch only a
private tail), so sharing is read-only:

* :class:`PrefixCache`: full prompt-prefix blocks keyed by the token
  prefix itself (a chain of prefix tuples). A lookup shares the longest
  cached prefix into a new sequence's table; the cache holds its own
  reference on each cached block, and the allocator's reclaimer hook
  takes back, least recently used first, blocks whose only reference is
  the cache's.
* :meth:`BlockTable.fork`: full blocks are shared, only the partial
  tail block is copied (:meth:`PagedKVCache.copy_block`).
* :meth:`BlockAllocator.rebuild_free_list` rebuilds refcounts as claim
  multiplicity over the surviving tables and the cache's holds.
* :func:`audit_kv_ledger` checks that every usable block is owned
  exactly once.

The host tier (``HostKVTier``), spill and peer fetch wait for ROADMAP
queue 1 item 5, serving item 3.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["BlockAllocator", "BlockTable", "PagedKVCache", "PrefixCache",
           "audit_kv_ledger", "blocks_for_tokens", "GARBAGE_BLOCK",
           "OutOfBlocksError", "BlockFreeError"]

_SPILL_ITEM = "ROADMAP serving queue, item 3 (KV spill / host tier)"

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
    """LIFO free-list allocator over ``num_blocks`` refcounted blocks.

    Block 0 (:data:`GARBAGE_BLOCK`) is reserved and never handed out.
    ``high_water`` is the peak number of blocks allocated at once, and
    ``total_allocated`` counts ``allocate`` hand-outs (not ``share``
    bumps)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._rc: Dict[int, int] = {}       # block -> owners (absent = free)
        self.high_water = 0
        self.total_allocated = 0
        # the cache that can give blocks back on demand: reclaimable()
        # -> int and reclaim(n) -> int
        self._reclaimer = None

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def refcount(self, block: int) -> int:
        """Owners of ``block`` (0 = on the free list)."""
        return self._rc.get(int(block), 0)

    def set_reclaimer(self, reclaimer) -> None:
        """Install the cache that can give blocks back (None clears)."""
        self._reclaimer = reclaimer

    def _reclaimable(self) -> int:
        return self._reclaimer.reclaimable() if self._reclaimer else 0

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free) + self._reclaimable()

    def allocate(self, n: int = 1) -> List[int]:
        if n > len(self._free) and self._reclaimer is not None:
            # cached blocks nobody references are headroom
            self._reclaimer.reclaim(n - len(self._free))
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)} free "
                f"(of {self.num_blocks - 1} usable)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        self.total_allocated += n
        self.high_water = max(self.high_water, self.used_count)
        return out

    def _validate(self, blocks, verb: str) -> None:
        for b in blocks:
            if b == GARBAGE_BLOCK:
                raise BlockFreeError(
                    f"{verb} of reserved garbage block {GARBAGE_BLOCK}")
            if not 0 < b < self.num_blocks:
                raise BlockFreeError(f"bad block id {b} (usable range "
                                     f"1..{self.num_blocks - 1})")

    def share(self, blocks: List[int]) -> List[int]:
        """Add one owner to each allocated block (prefix hits, forks).
        Every id is checked before any count moves."""
        blocks = [int(b) for b in blocks]
        self._validate(blocks, "share")
        for b in blocks:
            if self._rc.get(b, 0) < 1:
                raise BlockFreeError(f"share of unallocated block {b}")
        for b in blocks:
            self._rc[b] += 1
        return blocks

    def free(self, blocks: List[int]) -> None:
        """Drop one reference a block; blocks at 0 return to the free
        list. The whole list is checked first (a bad id, the garbage
        block, a free block, a repeat within the call), so a raise
        leaves the allocator as it was."""
        self._validate(blocks, "free")
        seen = set()
        for b in blocks:
            if self._rc.get(b, 0) < 1:
                raise BlockFreeError(f"double free of block {b}")
            if b in seen:
                raise BlockFreeError(
                    f"block {b} appears twice in one free() call")
            seen.add(b)
        for b in blocks:
            self._rc[b] -= 1
            if self._rc[b] == 0:
                del self._rc[b]
                self._free.append(b)

    def rebuild_free_list(self, live_block_lists) -> None:
        """Recompute the free list and the refcounts from the surviving
        claims (the tables that are still trusted, and the prefix
        cache's holds as one more list): a block claimed by several
        lists is shared at that multiplicity; every other block is
        free."""
        claims: Dict[int, int] = {}
        for blocks in live_block_lists:
            for b in blocks:
                b = int(b)
                if b == GARBAGE_BLOCK:
                    continue
                claims[b] = claims.get(b, 0) + 1
        bad = [b for b in claims if not 0 < b < self.num_blocks]
        if bad:
            raise BlockFreeError(
                f"rebuild_free_list given out-of-range ids {bad}")
        self._rc = dict(claims)
        self._free = [b for b in range(self.num_blocks - 1, 0, -1)
                      if b not in claims]
        self.high_water = max(self.high_water, len(claims))


class BlockTable:
    """One sequence's ordered block ids and its count of written
    tokens; the table grows lazily through its allocator."""

    def __init__(self, allocator: BlockAllocator):
        self._alloc = allocator
        self.blocks: List[int] = []
        self.num_tokens = 0

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self._alloc.block_size

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
        table when the last block is full. Bumps ``num_tokens``. An
        append into a shared, partly filled block is refused: shared
        blocks are always full, so such a target means the bookkeeping
        is broken and the write would land in a sibling's KV."""
        self.ensure_capacity(self.num_tokens + 1)
        bs = self._alloc.block_size
        target = self.blocks[self.num_tokens // bs]
        if self.num_tokens % bs and self._alloc.refcount(target) > 1:
            raise BlockFreeError(
                f"append into shared block {target} (refcount "
                f"{self._alloc.refcount(target)}): shared blocks are "
                f"read-only; fork() copies the partial tail")
        slot = (target, self.num_tokens % bs)
        self.num_tokens += 1
        return slot

    def attach_shared(self, blocks: List[int]) -> None:
        """Take already-shared blocks (a prefix hit bumped their counts)
        as this table's leading blocks; only on an empty table."""
        if self.blocks:
            raise BlockFreeError(
                "attach_shared on a non-empty table: shared prefix blocks "
                "must come first")
        self.blocks = [int(b) for b in blocks]

    def fork(self) -> Tuple["BlockTable", Optional[Tuple[int, int]]]:
        """Copy-on-write duplicate: full blocks are shared, the partial
        tail block is allocated afresh. Returns ``(new_table, copy)``,
        ``copy`` being ``(src_block, dst_block)`` for the caller's
        :meth:`PagedKVCache.copy_block` on both pools, or None when the
        token count fills whole blocks."""
        bs = self._alloc.block_size
        n_full = self.num_tokens // bs
        new = BlockTable(self._alloc)
        shared = self.blocks[:n_full]
        if shared:
            self._alloc.share(shared)
        new.blocks = list(shared)
        copy = None
        if self.num_tokens % bs:
            src = self.blocks[n_full]
            dst = self._alloc.allocate(1)[0]
            new.blocks.append(dst)
            copy = (src, dst)
        new.num_tokens = self.num_tokens
        return new, copy

    def truncate(self) -> List[int]:
        """Give back the blocks past what ``num_tokens`` needs (a verify
        round reserves ``k + 1`` slots up front; a rejected tail's
        blocks go straight back). Returns the freed ids."""
        keep = blocks_for_tokens(self.num_tokens, self._alloc.block_size)
        surplus = self.blocks[keep:]
        if surplus:
            self._alloc.free(surplus)
            self.blocks = self.blocks[:keep]
        return surplus

    def release(self) -> None:
        """Drop this table's reference on every block (eviction or
        finish): unshared blocks return to the allocator."""
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
    def copy_block(pool, src: int, dst: int) -> None:
        """In place: ``pool[:, dst] = pool[:, src]`` over every layer
        (the copy-on-write tail copy of :meth:`BlockTable.fork`)."""
        pool[:, int(dst)] = pool[:, int(src)]

    @staticmethod
    def gather_dense(pool_layer, block_row, n_pages: int):
        """Dense ``[n_pages*bs, H, D]`` view of one sequence's K or V
        through its block table."""
        idx = torch.as_tensor(np.asarray(block_row[:n_pages]),
                              dtype=torch.long, device=pool_layer.device)
        g = pool_layer[idx]
        return g.reshape(-1, *g.shape[2:])


def audit_kv_ledger(allocator: BlockAllocator, live_block_lists,
                    prefix_cache: Optional["PrefixCache"] = None,
                    host_tier=None) -> Dict[str, int]:
    """Ownership audit of the device tier: every usable block is owned
    exactly once, on the free list or referenced with a refcount equal
    to its claim multiplicity over the live tables and the prefix
    cache's holds, and ``free + claimed == usable``. Raises
    :class:`BlockFreeError` on a violation; returns the census.
    ``host_tier`` must be None (the host tier is not ported)."""
    if host_tier is not None:
        raise NotImplementedError(f"the host tier is not ported yet "
                                  f"({_SPILL_ITEM})")
    claims: Dict[int, int] = {}
    lists = [list(l) for l in live_block_lists]
    if prefix_cache is not None:
        lists.append(prefix_cache.held_blocks())
    for lst in lists:
        for b in lst:
            b = int(b)
            if b == GARBAGE_BLOCK:
                continue
            claims[b] = claims.get(b, 0) + 1
    free = list(allocator._free)
    usable = allocator.num_blocks - 1
    if len(set(free)) != len(free):
        raise BlockFreeError("free list holds a duplicate id")
    for b in free:
        if not 0 < b < allocator.num_blocks:
            raise BlockFreeError(f"free list holds bad id {b}")
        if b in claims:
            raise BlockFreeError(
                f"block {b} is both free and claimed: owned twice")
    for b, c in claims.items():
        if not 0 < b < allocator.num_blocks:
            raise BlockFreeError(f"claim on out-of-range block {b}")
        if allocator.refcount(b) != c:
            raise BlockFreeError(
                f"block {b}: refcount {allocator.refcount(b)} != claim "
                f"multiplicity {c}")
    for b in allocator._rc:
        if b not in claims:
            raise BlockFreeError(
                f"block {b} allocated (rc={allocator._rc[b]}) but "
                f"claimed by no table or cache")
    if len(free) + len(claims) != usable:
        raise BlockFreeError(
            f"ledger does not close: {len(free)} free + {len(claims)} "
            f"claimed != {usable} usable")
    return {"free": len(free), "claimed": len(claims)}


class PrefixCache:
    """Full prompt-prefix blocks keyed by content (the vLLM automatic
    prefix cache).

    Block ``i`` of a prompt is cached under the tuple of its first
    ``(i + 1) * block_size`` tokens, so a block's key holds everything
    before it. KV at a position depends only on the tokens up to it, so
    a request whose prompt starts with a cached prefix can read those
    blocks instead of writing its own. (In the JAX package the read is
    bit-exact; on the card a row's sums may depend on the padded length
    and the batch around it, so the smoke holds tokens at near ties.)

    The cache holds its own reference on every cached block, so cached
    KV outlives the sequence that wrote it. A block whose only reference
    is the cache's is reclaimable: the allocator's reclaimer hook takes
    back, least recently used first, as many as a starved ``allocate``
    needs. Blocks still shared with live sequences are never reclaimed.
    """

    def __init__(self, allocator: BlockAllocator,
                 max_blocks: Optional[int] = None, host_tier=None):
        if host_tier is not None:
            raise NotImplementedError(f"PrefixCache(host_tier=...) is not "
                                      f"ported yet ({_SPILL_ITEM})")
        self._alloc = allocator
        self.block_size = allocator.block_size
        # prefix-key tuple -> block id; _lru orders them oldest first
        self._entries: Dict[tuple, int] = {}
        self._lru: "OrderedDict[tuple, int]" = OrderedDict()
        self.max_blocks = max_blocks
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        allocator.set_reclaimer(self)

    def set_spill_io(self, gather, scatter) -> None:
        raise NotImplementedError(f"spill I/O is not ported yet "
                                  f"({_SPILL_ITEM})")

    def set_peer_source(self, fetch) -> None:
        raise NotImplementedError(f"peer fetch is not ported yet "
                                  f"({_SPILL_ITEM})")

    def __len__(self) -> int:
        return len(self._entries)

    def _keys(self, tokens) -> List[tuple]:
        bs = self.block_size
        return [tuple(tokens[:(i + 1) * bs])
                for i in range(len(tokens) // bs)]

    def lookup(self, tokens, share: bool = True) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens`` ->
        ``(blocks, n_cached_tokens)``. ``share=True`` (the commit path)
        adds the caller's reference to every returned block and counts
        a hit or a miss; ``share=False`` only looks."""
        blocks: List[int] = []
        for key in self._keys(tokens):
            b = self._entries.get(key)
            if b is None:
                break
            blocks.append(b)
            if share:
                self._lru.move_to_end(key)
        if share:
            if blocks:
                self._alloc.share(blocks)
                self.hits += 1
            else:
                self.misses += 1
        return blocks, len(blocks) * self.block_size

    def insert(self, tokens, blocks: List[int],
               n_prefix_tokens: Optional[int] = None) -> int:
        """Cache the full blocks covering ``tokens[:n_prefix_tokens]``
        (default all) of a table. Prefixes already cached are skipped.
        Each new block gains the cache's own reference. Returns the
        count of blocks newly cached."""
        n = len(tokens) if n_prefix_tokens is None \
            else min(int(n_prefix_tokens), len(tokens))
        added = 0
        for i, key in enumerate(self._keys(list(tokens)[:n])):
            if key in self._entries:
                continue
            b = int(blocks[i])
            self._alloc.share([b])
            self._entries[key] = b
            self._lru[key] = b
            added += 1
        if self.max_blocks is not None and \
                len(self._entries) > self.max_blocks:
            self.reclaim(len(self._entries) - self.max_blocks)
        return added

    def held_blocks(self) -> List[int]:
        """Every block the cache holds a reference on (one claim list
        for ``rebuild_free_list`` and :func:`audit_kv_ledger`)."""
        return list(self._entries.values())

    def reclaimable(self) -> int:
        """Cached blocks whose only reference is the cache's."""
        return sum(1 for b in self._entries.values()
                   if self._alloc.refcount(b) == 1)

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` reclaimable blocks, least recently used
        first, skipping blocks live sequences still share. Returns how
        many were freed."""
        if n <= 0:
            return 0
        freed = 0
        for key in list(self._lru.keys()):
            if freed >= n:
                break
            b = self._entries[key]
            if self._alloc.refcount(b) != 1:
                continue
            del self._entries[key]
            del self._lru[key]
            self._alloc.free([b])
            self.evictions += 1
            freed += 1
        return freed
