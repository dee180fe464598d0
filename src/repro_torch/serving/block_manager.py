"""Two-tier device-aware paged KV block allocator with prefix sharing
(port of `repro.serving.block_manager`: host-side logic, unchanged but for
one repaired fault in `promote_hits`, see there).

The serving engine's KV memory is a pool of fixed-size *blocks* spread
over two tiers:

* **device** — the accelerator pool.  Block ids ``0 .. num_blocks-1``
  are physical pool rows; the device-side attention gathers K/V through
  per-request tables of these ids.
* **host** — host memory.  Block ids ``>= num_blocks`` name host-side
  copies of block content (the engine owns the actual arrays, keyed by
  host block id).  A swapped-out request *owns host blocks* exactly like
  a running request owns device blocks, and a demoted-but-indexed prefix
  block is still a prefix hit — revived by copy-in instead of recompute.

Every block id lives in exactly one tier (`tier()` is a pure function of
the id), and cross-tier moves are allocator ops:

* `demote(rid, n_tokens)` — swap-out: the request's valid device blocks
  move to the host tier (the request's table becomes host ids); returns
  the ordered ``(device_id, host_id)`` copy pairs the engine executes.
* `promote(rid, shared_ids=...)` — swap-in: the request's host blocks
  move back to fresh device rows (minus the leading table positions a
  prefix-index hit already covers on device); returns the
  ``(host_id, device_id)`` copy pairs.
* `promote_hits(rid, ids)` — admission dedup over a *mixed-tier* prefix
  run: device hits are acquired (refcount +1, evictor revival), host
  hits are promoted (copy-in) and the prefix index re-points to the new
  device row.

All accounting is done in **target-device bytes**: a block is
`block_bytes` on the accelerator, and a token costs `bytes_per_token`
there, so the number of tokens a block holds is
`block_bytes // bytes_per_token` — which is what makes the paper's
effect mechanical: FP8 KV halves `bytes_per_token`, so at equal block
byte size every block holds exactly 2x the tokens and the same byte
budget serves twice the context.

Prefix sharing (refcount + content hash + copy-on-write)
    RL rollout is dominated by GRPO-style group sampling: N responses
    from the *same* prompt, which without sharing stores N identical
    copies of every prompt block.  Three mechanisms remove that
    redundancy:

    * **Refcounts.**  Every live block carries a reference count (in
      either tier).  `allocate` creates blocks at refcount 1;
      `acquire`/`fork` add holders (+1 each); `free` drops one holder
      per owned entry and only blocks that reach refcount 0 are
      released.  A preempted request therefore never evicts a block
      another request still reads — refcount-aware demote is what makes
      swap-out safe under sharing.

    * **Prefix index.**  A content-keyed map from *full-block* token
      prefixes to the block holding their KV — in EITHER tier.  The key
      for block i of a prompt is the byte string of tokens
      [0, (i+1)*block_size), so two prompts share block i only when
      they agree on *everything* before it.  Exact token bytes are used
      as keys — no hash collisions by construction.  Entries die with
      their block; partially-filled blocks are never indexed.

    * **Copy-on-write.**  `fork(src, dst)` lets a new request share
      *all* of a donor's blocks.  The first divergent append into a
      shared block goes through `cow(rid, index)`.

Evictor: demote-before-drop
    Freed blocks with a live index entry move to the device-tier
    evictor cache — the entry survives until the space is actually
    needed (vLLM semantics).  When the space IS needed, the entry no
    longer has to die: if the host tier has cache room
    (`host_blocks` reservation), the block's content is demoted to a
    fresh host block (synchronously, via the engine-registered
    `demote_copy` callback — the content is stable, it was written in
    an earlier step) and the index re-points across tiers.  With
    ``host_blocks=0`` this degenerates to the old drop-on-evict
    behavior exactly.

    Host-tier capacity semantics: `host_blocks` *reserves* room for
    demoted cache blocks.  Live swap-out demotions always succeed (the
    host tier backs preemption correctness, and host RAM is elastic) —
    they squeeze the cache reservation instead, dropping the oldest
    cached host blocks first.

This module is pure host-side bookkeeping (no torch): the engine owns the
device pool and the host block arrays, and registers two callbacks —
`demote_copy(device_id, host_id)` for the synchronous evictor demotion
and `host_drop(host_id)` so dropped host blocks free their storage.
Compare vLLM's `DeviceAwareBlockAllocator` over its prefix-caching
allocator (`core/block/cpu_gpu_block_allocator.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.faults import HostCopyError

DEVICE_TIER = "device"
HOST_TIER = "host"


class NoFreeBlocksError(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list
    (or would exceed the caller's soft block limit)."""


@dataclasses.dataclass
class BlockManager:
    """Two-tier free-list allocator over a fixed device pool plus a
    host-memory tier.

    num_blocks            : physical blocks in the device pool
    block_size            : tokens per block *for this cache dtype*
    bytes_per_token       : per-token KV footprint on the target device
    enable_prefix_sharing : maintain the content-hash prefix index
                            (refcounts/CoW stay active either way)
    host_blocks           : host-tier reservation for demoted *cache*
                            blocks (refcount-0, index live).  0 disables
                            cache demotion — the evictor drops entries
                            exactly like the single-tier allocator did.
                            Live swap-out demotions are never capacity-
                            blocked; they squeeze this reservation.
    """

    num_blocks: int
    block_size: int
    bytes_per_token: int = 0
    enable_prefix_sharing: bool = True
    host_blocks: int = 0

    def __post_init__(self):
        assert self.num_blocks >= 0 and self.block_size > 0
        assert self.host_blocks >= 0
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: List[int] = list(range(self.num_blocks))[::-1]
        # rid -> ordered block table.  A running request's table is all
        # device ids; a swapped-out request's table is all host ids.
        self._owned: Dict[int, List[int]] = {}
        self._refcount: Dict[int, int] = {}
        # full-block prefix tokens (bytes) -> block id (EITHER tier),
        # plus the reverse map so releasing a block retires its entry
        self._prefix_index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        # device-tier evictor cache: refcount-0 blocks whose prefix
        # entry survives until the space is actually needed.  Insertion
        # order = eviction order; values unused.
        self._cached: Dict[int, None] = {}
        # host-tier cache: refcount-0 host blocks holding demoted
        # prefix content (the demote-before-drop output)
        self._host_cached: Dict[int, None] = {}
        # host ids are minted monotonically and never recycled — an id
        # is a unique name for one block's content for all time, so a
        # plan-time promote and a later same-plan demote can never
        # alias each other's execute-time copies
        self._next_host_id = self.num_blocks
        self._host_live = 0           # refcounted host blocks
        # rid -> tokens retained on the host tier while swapped out
        # (the allocator-owned successor of Request.swap_tokens)
        self._swapped: Dict[int, int] = {}
        # engine-registered movers (None = bookkeeping-only, unit tests)
        self.demote_copy: Optional[Callable[[int, int], None]] = None
        self.host_drop: Optional[Callable[[int], None]] = None
        # cumulative cross-tier traffic counters (block granularity)
        self.demoted_blocks = 0       # swap-out device->host copies
        self.promoted_blocks = 0      # host->device copies (all paths)
        self.cache_demotions = 0      # evictor demote-before-drop moves
        self.host_cache_drops = 0     # host-cached entries dropped
        # demote copies that failed (HostCopyError from the engine's
        # injector seam) and fell back to dropping the prefix entry
        self.host_copy_faults = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def from_byte_budget(cls, budget_bytes: int, block_bytes: int,
                         bytes_per_token: int, *,
                         enable_prefix_sharing: bool = True,
                         host_blocks: int = 0) -> "BlockManager":
        """Size the pool from a device byte budget and a block byte size.

        `block_bytes` is precision-independent (a physical allocation
        unit); `bytes_per_token` halves under FP8 KV, so `block_size` —
        tokens per block — doubles at equal `block_bytes`.
        """
        assert block_bytes >= bytes_per_token > 0
        return cls(num_blocks=budget_bytes // block_bytes,
                   block_size=block_bytes // bytes_per_token,
                   bytes_per_token=bytes_per_token,
                   enable_prefix_sharing=enable_prefix_sharing,
                   host_blocks=host_blocks)

    def set_host_callbacks(self, *, demote_copy=None, host_drop=None):
        """Register the engine's cross-tier hooks: `demote_copy(dev, host)`
        copies a device pool row into host storage (synchronous — only
        the evictor uses it, and only on content written in an earlier
        step); `host_drop(host)` frees a dropped host block's storage."""
        self.demote_copy = demote_copy
        self.host_drop = host_drop

    # -- sizing --------------------------------------------------------------
    @property
    def block_bytes(self) -> int:
        return self.block_size * self.bytes_per_token

    @property
    def capacity_tokens(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def num_free_blocks(self) -> int:
        """Device blocks an allocation could take: truly free + evictable
        cached."""
        return len(self._free) + len(self._cached)

    @property
    def num_cached_blocks(self) -> int:
        """Refcount-0 DEVICE blocks still holding a live prefix entry."""
        return len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        """Allocated DEVICE blocks (the budget-facing gauge)."""
        return self.num_blocks - self.num_free_blocks

    @property
    def bytes_in_use(self) -> int:
        return self.blocks_in_use * self.block_bytes

    @property
    def num_shared_blocks(self) -> int:
        """Physical blocks currently held by more than one request."""
        return sum(1 for c in self._refcount.values() if c > 1)

    # -- tiers ---------------------------------------------------------------
    def tier(self, block_id: int) -> str:
        """The tier a block id lives in — a pure function of the id:
        device rows are ``< num_blocks``, host blocks are everything
        minted above."""
        return DEVICE_TIER if block_id < self.num_blocks else HOST_TIER

    @property
    def num_host_live(self) -> int:
        """Refcounted host blocks (swapped-out requests' tables)."""
        return self._host_live

    @property
    def num_host_cached(self) -> int:
        """Refcount-0 host blocks holding demoted prefix content."""
        return len(self._host_cached)

    @property
    def host_blocks_in_use(self) -> int:
        return self._host_live + len(self._host_cached)

    @property
    def host_bytes_in_use(self) -> int:
        return self.host_blocks_in_use * self.block_bytes

    def is_swapped(self, rid: int) -> bool:
        """True while `rid`'s KV lives on the host tier (between a
        `demote` and the matching `promote`)."""
        return rid in self._swapped

    def swapped_tokens(self, rid: int) -> int:
        """Valid KV rows `rid` retains on the host tier (0 if not
        swapped) — the restore length `promote` hands back."""
        return self._swapped.get(rid, 0)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold `n_tokens` (ceil division)."""
        return -(-max(n_tokens, 0) // self.block_size)

    def refcount(self, block_id: int) -> int:
        return self._refcount.get(block_id, 0)

    def is_shared(self, block_id: int) -> bool:
        return self.refcount(block_id) > 1

    # -- host-tier plumbing --------------------------------------------------
    def _new_host_id(self) -> int:
        h = self._next_host_id
        self._next_host_id += 1
        return h

    def _host_cache_room(self) -> int:
        """Cache slots left in the host reservation: live swap blocks
        squeeze it (they always win — preemption correctness beats
        cache retention)."""
        return max(self.host_blocks - self._host_live, 0) \
            - len(self._host_cached)

    def _drop_host_cached(self, h: int):
        del self._host_cached[h]
        key = self._block_key.pop(h, None)
        if key is not None and self._prefix_index.get(key) == h:
            del self._prefix_index[key]
        self.host_cache_drops += 1
        if self.host_drop is not None:
            self.host_drop(h)

    def _rebalance_host_cache(self):
        """Shrink the host cache to its (live-squeezed) reservation,
        oldest demoted entries first."""
        while self._host_cached and self._host_cache_room() < 0:
            self._drop_host_cached(next(iter(self._host_cached)))

    def _release_host_block(self, h: int):
        """A refcounted host block lost its last holder.  Request-owned
        host blocks are never index targets (the index prefers the
        device copy at demote time and only crosses tiers through the
        evictor), so release is always final."""
        del self._refcount[h]
        self._host_live -= 1
        if self.host_drop is not None:
            self.host_drop(h)

    # -- allocation ----------------------------------------------------------
    def _evict_cached(self) -> int:
        """Reclaim the oldest freed-but-indexed device block.  Its prefix
        entry demotes to the host tier when the cache reservation has
        room (content copied synchronously via `demote_copy`; the index
        re-points to the new host block — still a hit, revived by
        copy-in), and dies otherwise (the old drop-on-evict
        behavior, exact at host_blocks=0)."""
        b = next(iter(self._cached))
        del self._cached[b]
        key = self._block_key.pop(b, None)
        if key is not None and self._prefix_index.get(key) == b:
            if self._host_cache_room() > 0:
                h = self._new_host_id()
                try:
                    if self.demote_copy is not None:
                        self.demote_copy(b, h)
                except HostCopyError:
                    # the host copy failed: fall back to dropping the
                    # entry (the pre-host-tier behavior).  The content
                    # is a refcount-0 cache, so nothing is lost but a
                    # future prefix hit; the minted host id is simply
                    # abandoned (ids are never recycled).
                    del self._prefix_index[key]
                    self.host_copy_faults += 1
                    return b
                self._block_key[h] = key
                self._prefix_index[key] = h
                self._host_cached[h] = None
                self.cache_demotions += 1
            else:
                del self._prefix_index[key]
        return b

    def _pop_free_block(self) -> int:
        """Take one device block: the true free list first, then the
        evictor."""
        if self._free:
            return self._free.pop()
        return self._evict_cached()

    def can_allocate(self, n_blocks: int, *, limit_blocks: Optional[int] = None
                     ) -> bool:
        """True if `n_blocks` more device blocks fit — under the physical
        free list (cached evictable blocks included) and (optionally) a
        soft block limit below the pool size."""
        if n_blocks > self.num_free_blocks:
            return False
        if limit_blocks is not None and \
                self.blocks_in_use + n_blocks > limit_blocks:
            return False
        return True

    def allocate(self, rid: int, n_blocks: int, *,
                 limit_blocks: Optional[int] = None) -> List[int]:
        """Append `n_blocks` fresh device blocks (refcount 1) to request
        `rid`'s table.  Enforces the same soft cap as `can_allocate`, so
        the two can never disagree under on-demand admission.  Takes
        from the true free list first; only under pressure does it evict
        cached (freed-but-indexed) blocks — demoting their prefix
        entries to the host tier when the reservation allows."""
        if n_blocks > self.num_free_blocks:
            raise NoFreeBlocksError(
                f"need {n_blocks} blocks, {self.num_free_blocks} free")
        if limit_blocks is not None and \
                self.blocks_in_use + n_blocks > limit_blocks:
            raise NoFreeBlocksError(
                f"need {n_blocks} blocks, but {self.blocks_in_use} in use "
                f"against a limit of {limit_blocks}")
        ids = [self._pop_free_block() for _ in range(n_blocks)]
        for b in ids:
            self._refcount[b] = 1
        self._owned.setdefault(rid, []).extend(ids)
        return ids

    def ensure_capacity(self, rid: int, n_tokens: int, *,
                        limit_blocks: Optional[int] = None) -> List[int]:
        """Grow `rid`'s table until it holds `n_tokens`; returns new ids."""
        need = self.blocks_for_tokens(n_tokens) - len(self._owned.get(rid, []))
        if need <= 0:
            return []
        return self.allocate(rid, need, limit_blocks=limit_blocks)

    def blocks_of(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, []))

    def _release_device_block(self, b: int) -> bool:
        """A device block lost its last holder: indexed blocks move to
        the evictor cache (entry survives until the space is needed),
        the rest are returned by the caller to the free list.  Returns
        True when the caller must free-list it."""
        del self._refcount[b]
        if b in self._block_key:
            self._cached[b] = None        # evictor keeps the entry
            return False
        return True

    def free(self, rid: int) -> List[int]:
        """Drop one reference per block in `rid`'s table (either tier).
        Device blocks that reach refcount 0 are released: ones with a
        live prefix entry move to the evictor cache, the rest return to
        the free list.  Host blocks that reach refcount 0 are dropped
        (their storage freed via `host_drop`).  Blocks another request
        still holds stay resident either way.  Returns the released
        ids.  Freeing an unknown/already-freed rid is a no-op, so a
        double `free` can never double-release a shared block."""
        released: List[int] = []
        plain: List[int] = []
        for b in self._owned.pop(rid, []):
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                released.append(b)
                if self.tier(b) == HOST_TIER:
                    self._release_host_block(b)
                elif self._release_device_block(b):
                    plain.append(b)
        self._free.extend(reversed(plain))
        self._swapped.pop(rid, None)
        self._rebalance_host_cache()
        return released

    # -- cross-tier moves ----------------------------------------------------
    def demote(self, rid: int, n_tokens: int) -> List[Tuple[int, int]]:
        """Swap-out: move `rid`'s leading blocks covering `n_tokens` to
        the host tier.  Returns the ordered ``(device_id, host_id)``
        copy pairs — one per valid block, shared or not: a sharer may
        die before `rid` resumes, so the host copy is the request's only
        durable KV.  The request's table becomes the host ids; the
        device side drops one reference per block (blocks another
        request holds stay resident; refcount-0 indexed blocks stay
        device-cached for free revival, the rest return to the free
        list).  Blocks beyond the valid count (speculation growth) are
        released without a copy.  Always succeeds: live demotions
        overcommit the host reservation and squeeze the cache instead
        (`host_blocks` bounds retention, not correctness)."""
        assert rid not in self._swapped, f"rid {rid} is already swapped"
        table = self._owned.pop(rid, [])
        assert all(self.tier(b) == DEVICE_TIER for b in table), (
            "demote expects a device-resident table")
        n_valid = min(self.blocks_for_tokens(n_tokens), len(table))
        moves: List[Tuple[int, int]] = []
        host_ids: List[int] = []
        plain: List[int] = []
        for i, b in enumerate(table):
            if i < n_valid:
                h = self._new_host_id()
                self._refcount[h] = 1
                self._host_live += 1
                host_ids.append(h)
                moves.append((b, h))
            self._refcount[b] -= 1
            if self._refcount[b] == 0 and self._release_device_block(b):
                plain.append(b)
        self._free.extend(reversed(plain))
        self._owned[rid] = host_ids
        self._swapped[rid] = n_tokens
        self.demoted_blocks += len(moves)
        self._rebalance_host_cache()
        return moves

    def promote(self, rid: int, *, shared_ids: List[int],
                limit_blocks: Optional[int] = None
                ) -> Tuple[List[Tuple[int, int]], int]:
        """Swap-in: move `rid`'s host-tier table back to device rows.

        `shared_ids` are device blocks a prefix-index lookup found for
        the leading table positions (the re-dedup): they are acquired
        (refcount +1 / evictor revival) and head the new table, and the
        host copies they supersede are dropped without a copy — a
        swapped-out prefix whose group is still resident restores for
        free.  Host blocks past the shared head are promoted: each gets
        a fresh device row and an ordered ``(host_id, device_id)`` copy
        pair for the engine to execute.  Returns ``(moves,
        n_promoted)``; the caller allocates any reservation beyond the
        restored content separately."""
        assert rid in self._swapped, f"rid {rid} is not swapped"
        hids = self._owned.pop(rid, [])
        assert all(self.tier(b) == HOST_TIER for b in hids), (
            "promote expects a host-resident table")
        del self._swapped[rid]
        s = len(shared_ids)
        tail = hids[s:]
        if len(tail) > self.num_free_blocks:
            raise NoFreeBlocksError(
                f"promote needs {len(tail)} blocks, "
                f"{self.num_free_blocks} free")
        if limit_blocks is not None and \
                self.blocks_in_use + len(tail) > limit_blocks:
            raise NoFreeBlocksError(
                f"promote needs {len(tail)} blocks, but "
                f"{self.blocks_in_use} in use against a limit of "
                f"{limit_blocks}")
        if shared_ids:
            self.acquire(rid, shared_ids)
        moves: List[Tuple[int, int]] = []
        for h in hids[:s]:
            # superseded by a device-resident hit: the host copy dies
            self._refcount[h] -= 1
            if self._refcount[h] == 0:
                self._release_host_block(h)
        for h in tail:
            d = self._pop_free_block()
            self._refcount[d] = 1
            self._owned.setdefault(rid, []).append(d)
            moves.append((h, d))
            # content transfers at execute time: the engine frees the
            # host storage when it performs the copy, so no host_drop
            del self._refcount[h]
            self._host_live -= 1
        self.promoted_blocks += len(moves)
        return moves, len(moves)

    def promote_hits(self, rid: int, block_ids: List[int], *,
                     limit_blocks: Optional[int] = None
                     ) -> Tuple[List[int], List[Tuple[int, int]], int]:
        """Admission dedup over a mixed-tier prefix run (the cross-tier
        `acquire`).  Device hits are acquired exactly like `acquire`;
        host hits — demoted cache blocks — are promoted: each consumes
        a fresh device row, yields an ordered ``(host_id, device_id)``
        copy pair, and the prefix index re-points to the device row.
        Returns ``(table_ids, moves, n_promoted)`` where `table_ids`
        replaces `block_ids` as the request's leading table (host ids
        replaced by their device rows)."""
        n_promote = sum(1 for b in block_ids
                        if self.tier(b) == HOST_TIER)
        # cached device hits are pinned below, so they are not free rows
        # for the promotions
        n_pinned = sum(1 for b in block_ids if b in self._cached)
        if n_promote + n_pinned > self.num_free_blocks:
            raise NoFreeBlocksError(
                f"prefix revival needs {n_promote} blocks, "
                f"{self.num_free_blocks - n_pinned} free")
        if limit_blocks is not None and n_promote and \
                self.blocks_in_use + n_promote > limit_blocks:
            raise NoFreeBlocksError(
                f"prefix revival needs {n_promote} blocks, but "
                f"{self.blocks_in_use} in use against a limit of "
                f"{limit_blocks}")
        # Pin the device hits BEFORE popping rows for the host hits: the
        # evictor may otherwise reclaim a cached device hit of this same
        # run and hand its row to one of the promotions, so that one row
        # would stand at two table positions (content of the wrong
        # prefix).  The reference's loop acquires in table order and has
        # that fault; the port diverges from it here.
        device_hits = [b for b in block_ids if self.tier(b) == DEVICE_TIER]
        for b in device_hits:
            if self._refcount.get(b, 0) <= 0 and b not in self._cached:
                raise ValueError(f"block {b} is not live; cannot share it")
        for b in device_hits:
            if b in self._cached:
                del self._cached[b]
                self._refcount[b] = 1
            else:
                self._refcount[b] += 1
        table: List[int] = []
        moves: List[Tuple[int, int]] = []
        for b in block_ids:
            if self.tier(b) == DEVICE_TIER:
                self._owned.setdefault(rid, []).append(b)
                table.append(b)
                continue
            assert b in self._host_cached, (
                f"host block {b} is not cached; cannot share it")
            del self._host_cached[b]
            d = self._pop_free_block()
            self._refcount[d] = 1
            key = self._block_key.pop(b)
            self._block_key[d] = key
            self._prefix_index[key] = d
            self._owned.setdefault(rid, []).append(d)
            table.append(d)
            moves.append((b, d))
        self.promoted_blocks += len(moves)
        return table, moves, len(moves)

    # -- sharing -------------------------------------------------------------
    def acquire(self, rid: int, block_ids: List[int]) -> List[int]:
        """Append existing DEVICE blocks to `rid`'s table, adding one
        reference each (the sharing primitive behind prefix hits and
        fork).  Blocks may be live (refcount >= 1) or sitting in the
        evictor cache (refcount 0, content intact) — the latter are
        *revived*: pulled out of the cache at refcount 1.  Host-tier
        hits go through `promote_hits` (they need a copy-in)."""
        for b in block_ids:
            if self.tier(b) == HOST_TIER:
                raise ValueError(
                    f"block {b} is host-tier; revive it via promote_hits")
            if self._refcount.get(b, 0) <= 0 and b not in self._cached:
                raise ValueError(f"block {b} is not live; cannot share it")
        for b in block_ids:
            if b in self._cached:
                del self._cached[b]
                self._refcount[b] = 1
            else:
                self._refcount[b] += 1
        self._owned.setdefault(rid, []).extend(block_ids)
        return list(block_ids)

    def fork(self, src_rid: int, dst_rid: int) -> List[int]:
        """Give `dst_rid` a table sharing *all* of `src_rid`'s blocks
        (including a partially-filled tail — the first divergent append
        must go through `cow`)."""
        return self.acquire(dst_rid, self.blocks_of(src_rid))

    def cow(self, rid: int, index: int, *,
            limit_blocks: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """Copy-on-write entry `index` of `rid`'s table.

        If the block there is shared, replace it with a fresh private block
        (refcount 1) and drop one reference on the donor; returns
        (old_id, new_id) so the caller can copy the physical row on device
        *before* the divergent write lands.  Returns None when the block is
        already exclusive (no copy needed).  The copy takes one block and
        honors the same `limit_blocks` soft cap as `allocate`."""
        ids = self._owned[rid]
        old = ids[index]
        if self._refcount.get(old, 0) <= 1:
            return None
        if not self.num_free_blocks:
            raise NoFreeBlocksError("copy-on-write needs a free block")
        if limit_blocks is not None and self.blocks_in_use + 1 > limit_blocks:
            raise NoFreeBlocksError(
                f"copy-on-write needs a block, but {self.blocks_in_use} in "
                f"use against a limit of {limit_blocks}")
        new = self._pop_free_block()
        self._refcount[new] = 1
        self._refcount[old] -= 1
        ids[index] = new
        return old, new

    # -- prefix index --------------------------------------------------------
    def _prefix_keys(self, tokens) -> List[bytes]:
        """One exact content key per *full* block of `tokens`: the byte
        string of the whole prefix through that block."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        n_full = len(toks) // self.block_size
        return [toks[: (i + 1) * self.block_size].tobytes()
                for i in range(n_full)]

    def lookup_prefix(self, tokens) -> List[int]:
        """Longest run of indexed blocks covering a full-block prefix of
        `tokens` (the dedup step of admission).  Hits may be live device
        blocks, evictor-cached device blocks, *or host-cached demoted
        blocks* — the latter are hits too (revived by copy-in, not
        recompute); check `tier()` and route host hits through
        `promote_hits` instead of `acquire`."""
        if not self.enable_prefix_sharing:
            return []
        hits: List[int] = []
        for key in self._prefix_keys(tokens):
            b = self._prefix_index.get(key)
            if b is None:
                break
            if self.tier(b) == HOST_TIER:
                if b not in self._host_cached:
                    break
            elif self._refcount.get(b, 0) <= 0 and b not in self._cached:
                break
            hits.append(b)
        return hits

    def register_prefix(self, rid: int, tokens) -> int:
        """Index `rid`'s leading blocks under the full-block prefixes of
        `tokens` (call after the prompt's KV is actually in the pool).
        Existing entries win — admission is sequential, so the first
        registrant of a prefix stays authoritative.  Returns the number of
        new index entries."""
        if not self.enable_prefix_sharing:
            return 0
        ids = self._owned.get(rid, [])
        added = 0
        for i, key in enumerate(self._prefix_keys(tokens)):
            if i >= len(ids):
                break
            b = ids[i]
            if key in self._prefix_index or b in self._block_key:
                continue
            self._prefix_index[key] = b
            self._block_key[b] = key
            added += 1
        return added
