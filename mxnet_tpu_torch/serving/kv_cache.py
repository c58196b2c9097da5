"""Paged KV cache: block-table indexed, per-sequence alloc/free, with
per-block refcounts.

Counterpart of ``mxnet_tpu/serving/kv_cache.py`` with the same host
accounting: K/V live in a shared pool of fixed-size blocks, each
sequence owns an ordered list of physical block ids (its block table),
blocks are handed out on demand and return to a LIFO free list when the
sequence finishes.  Physical block 0 is the null block: table padding
and inactive batch rows point at it, its contents are garbage and every
attention masks it out by position.

Device side the pools are two torch tensors of shape
``(layers, num_blocks, block_size, kv_heads, head_dim)`` on the engine's
device; an fp8 cache adds two f32 scale planes ``(layers, num_blocks,
block_size)``, one amax scale per written token row, indexed like the
pools.  The engine writes them IN PLACE (index assignment), which
replaces the reference's donated-argument round trip
(``pool_args``/``update_pools``); the donation sentinel that guarded
that round trip has nothing left to guard and is not ported.

Refcounts: a freshly allocated block has refcount 1.  ``adopt``/``ref``
hand the same physical block to another holder; ``prepare_write``
plans a copy-on-write before a shared block is written;
``free``/``trim`` only decrement, and a block rejoins the free list at
0.  Violations raise :class:`DoubleFreeError`.

Engines that share one cache (the disaggregated fleet's prefill and
decode replicas) hand a request's blocks over through the refcounts:
the adopting side refs every block first, the releasing side drops its
slot second.  A handoff that breaks that order raises
:class:`HandoffError`.  The pools are never reallocated: every engine
over a shared cache bakes their addresses into its CUDA graphs.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, NotSupportedError
from ..context import resolve_device
from ..ops.quant_kv import kv_has_scales, kv_pool_dtype, resolve_kv_dtype

__all__ = ["PagedKVCache", "DoubleFreeError", "HandoffError"]


class DoubleFreeError(MXNetError):
    """A block refcount went below zero or a slot was freed twice: the
    host-side block accounting is corrupt."""


class HandoffError(MXNetError):
    """A block handoff between replicas broke the ownership protocol:
    the adopting side must take its reference before the releasing side
    drops its own (adopt-then-release), both sides must share one pool,
    and every handed-off block must have at least 2 holders when it is
    released.  Anything else would let a decode replica read blocks the
    free list already recycled."""


class PagedKVCache:
    """Block-pooled KV storage for one model.

    Parameters
    ----------
    num_layers, num_kv_heads, head_dim : model geometry.
    num_blocks : physical blocks in the pool INCLUDING the null block 0.
    block_size : tokens per block (power of two).
    max_batch : decode slots (sequences resident at once).
    dtype : pool dtype when ``kv_dtype`` is unset (the model's dtype).
    sharding : the reference's pool sharding; only None (one card).
    kv_dtype : ``"bf16"`` stores bfloat16; ``"fp8"`` stores
        float8_e4m3fn codes with the ``k_scale``/``v_scale`` planes;
        ``None``/``"fp32"`` keeps ``dtype``.
    device : where the pools live (``cuda`` by default; raises without
        a card unless ``device="cpu"``).
    """

    def __init__(self, num_layers, num_kv_heads, head_dim, num_blocks=64,
                 block_size=16, max_batch=4, dtype=None, sharding=None,
                 kv_dtype=None, device=None):
        if sharding is not None:
            raise NotSupportedError(
                "PagedKVCache(sharding=...) is not ported yet: sharded "
                "pools arrive with tensor-parallel serving (ROADMAP §1 "
                "item 10b)")
        if block_size < 1 or (block_size & (block_size - 1)):
            raise MXNetError("block_size must be a power of two, got "
                             f"{block_size}")
        if num_blocks < 2:
            raise MXNetError("num_blocks must be >= 2 (block 0 is the "
                             "reserved null block)")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_batch = max_batch
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.dtype = kv_pool_dtype(self.kv_dtype, dtype or torch.float32)
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.k_scale = self.v_scale = None
        if kv_has_scales(self.kv_dtype):
            sshape = (num_layers, num_blocks, block_size)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
        # LIFO free list: freshly freed blocks are reused first (warm)
        self._free = list(range(num_blocks - 1, 0, -1))
        self._tables = {}        # slot -> [physical block ids]
        self._lens = {}          # slot -> tokens stored
        self._refs = {}          # block id -> holders (never block 0)
        self.alloc_failures = 0  # pool-exhausted alloc attempts (stats)
        self.cow_copies = 0      # copy-on-write forks performed

    # -- refcount plumbing ----------------------------------------------

    def _pop_free(self):
        blk = self._free.pop()
        self._refs[blk] = 1
        return blk

    def ref(self, blk):
        """One more holder for an allocated block."""
        if self._refs.get(blk, 0) < 1:
            raise DoubleFreeError(f"ref() on unallocated block {blk}")
        self._refs[blk] += 1

    def unref(self, blk):
        """Drop one holder; the block rejoins the free list at 0."""
        r = self._refs.get(blk, 0)
        if r < 1:
            raise DoubleFreeError(
                f"refcount underflow on block {blk} (double free)")
        if r == 1:
            del self._refs[blk]
            self._free.append(blk)
        else:
            self._refs[blk] = r - 1

    def refcount(self, blk):
        return self._refs.get(blk, 0)

    # -- allocation ------------------------------------------------------

    @property
    def num_free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        return (self.num_blocks - 1) - len(self._free)

    def utilization(self):
        """Fraction of allocatable blocks currently owned by sequences."""
        total = self.num_blocks - 1
        return self.blocks_in_use / total if total else 0.0

    @property
    def block_nbytes(self):
        """Bytes ONE block pins across both pools and all layers,
        including the fp8 scale rows."""
        n = (2 * self.num_layers * self.block_size * self.num_kv_heads
             * self.head_dim * self.k_pool.element_size())
        if self.k_scale is not None:
            n += 2 * self.num_layers * self.block_size * \
                self.k_scale.element_size()
        return n

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` positions."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, slot, n_tokens):
        """Give ``slot`` enough blocks for ``n_tokens`` positions.
        Returns False (and allocates nothing) when the pool can't cover
        the request."""
        if slot in self._tables:
            raise MXNetError(f"slot {slot} already allocated; free() first")
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            self.alloc_failures += 1
            return False
        self._tables[slot] = [self._pop_free() for _ in range(need)]
        self._lens[slot] = 0
        return True

    def adopt(self, slot, blocks, n_tokens):
        """Create ``slot`` sharing ``blocks`` (covering ``n_tokens``
        positions): each block gains a holder."""
        if slot in self._tables:
            raise MXNetError(f"slot {slot} already allocated; free() first")
        if self.blocks_for(n_tokens) != len(blocks):
            raise MXNetError(
                f"adopt: {len(blocks)} blocks cannot cover {n_tokens} "
                f"tokens at block_size {self.block_size}")
        for blk in blocks:
            self.ref(blk)
        self._tables[slot] = list(blocks)
        self._lens[slot] = int(n_tokens)
        return True

    def ensure(self, slot, pos):
        """Grow ``slot``'s table to cover position ``pos`` (0-based).
        Returns False when the pool is exhausted."""
        table = self._tables[slot]
        need = self.blocks_for(pos + 1) - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            self.alloc_failures += 1
            return False
        table.extend(self._pop_free() for _ in range(need))
        return True

    def prepare_write(self, slot, start, end):
        """Copy-on-write plan for writing positions ``[start, end)`` of
        ``slot``: every covering block with refcount > 1 is swapped for
        a fresh block in the table and the ``(old, new)`` pairs are
        returned for the engine to copy.  None when the pool can't supply
        the fresh blocks; [] when nothing is shared."""
        if end <= start:
            return []
        table = self._tables[slot]
        copies = []
        first = int(start) // self.block_size
        last = (int(end) - 1) // self.block_size
        for idx in range(first, last + 1):
            old = table[idx]
            if self._refs.get(old, 0) > 1:
                if not self._free:
                    # undo the partial plan: nothing is copied until the
                    # whole range has fresh blocks
                    self.alloc_failures += 1
                    for o, n, i in copies:
                        del self._refs[n]
                        self._free.append(n)
                        table[i] = o
                        self._refs[o] = self._refs.get(o, 0) + 1
                        self.cow_copies -= 1
                    return None
                new = self._pop_free()
                table[idx] = new
                self.unref(old)
                copies.append((old, new, idx))
                self.cow_copies += 1
        return [(o, n) for o, n, _ in copies]

    def trim(self, slot, n_tokens):
        """Shrink ``slot``'s table to exactly cover ``n_tokens``
        positions (prefill allocates for the padded bucket)."""
        table = self._tables[slot]
        keep = self.blocks_for(n_tokens)
        while len(table) > keep:
            self.unref(table.pop())

    def free(self, slot):
        """Drop ``slot``'s hold on all of its blocks; an unknown slot is a
        double free."""
        if slot not in self._tables:
            raise DoubleFreeError(f"free() on unknown slot {slot!r} "
                                  "(double free or never allocated)")
        for blk in self._tables.pop(slot):
            self.unref(blk)
        self._lens.pop(slot, None)

    def set_len(self, slot, n):
        self._lens[slot] = int(n)

    def seq_len(self, slot):
        return self._lens.get(slot, 0)

    def table(self, slot):
        return list(self._tables.get(slot, ()))

    def check_leaks(self, holders=0):
        """Invariant sweep: every block is free, or referenced exactly by
        the live tables plus ``holders`` external references."""
        table_refs = {}
        for table in self._tables.values():
            for blk in table:
                table_refs[blk] = table_refs.get(blk, 0) + 1
        extra = sum(self._refs.values()) - sum(table_refs.values())
        if extra != holders:
            raise MXNetError(
                f"KV block leak: {extra} dangling reference(s) beyond "
                f"the {holders} declared external holder(s)")
        for blk, n in table_refs.items():
            if self._refs.get(blk, 0) < n:
                raise MXNetError(
                    f"block {blk} held by {n} table(s) but refcount is "
                    f"{self._refs.get(blk, 0)}")
        if len(self._free) + len(self._refs) != self.num_blocks - 1:
            raise MXNetError(
                f"block accounting off: {len(self._free)} free + "
                f"{len(self._refs)} referenced != {self.num_blocks - 1} "
                "allocatable")
        return True

    # -- device-facing views --------------------------------------------

    def table_array(self, slots, width):
        """(len(slots), width) int32 block-table matrix: row i is
        ``slots[i]``'s table padded with the null block; a ``None`` slot
        (inactive batch row) is all-null."""
        out = _np.zeros((len(slots), width), _np.int32)
        for i, slot in enumerate(slots):
            if slot is None:
                continue
            t = self._tables.get(slot, ())
            if len(t) > width:
                raise MXNetError(
                    f"slot {slot} holds {len(t)} blocks but the decode "
                    f"bucket only gathers {width}; bucket too small")
            out[i, :len(t)] = t
        return out

    def stats(self):
        shared = sum(1 for r in self._refs.values() if r > 1)
        return {"num_blocks": self.num_blocks,
                "kv_dtype": self.kv_dtype or "fp32",
                "block_size": self.block_size,
                "blocks_in_use": self.blocks_in_use,
                "utilization": round(self.utilization(), 4),
                "alloc_failures": self.alloc_failures,
                "sequences": len(self._tables),
                "shared_blocks": shared,
                "cow_copies": self.cow_copies}
