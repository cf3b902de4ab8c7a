"""Refcounted paged KV block pool with a copy-on-write prefix trie.

A copy of ``repro/serve/kvpool.py`` (no JAX in it): the port imports nothing
of the JAX package, so it keeps its own.

The serving engine's KV cache becomes a pool of fixed-size *blocks*
(`kv_block` tokens each); every decode slot owns an indirection table
mapping its logical blocks to physical pool blocks.  Admissions that share
a prompt prefix map their leading table entries onto blocks another request
already prefilled — keyed by the *token content* of each full block through
a prefix trie — and prefill only the unshared suffix.

Sharing is copy-on-write by construction rather than by trapping writes:

  * only FULL prompt blocks are ever published to the trie (a request's
    final partial block and its decode region stay private), and the match
    is capped so at least one suffix token always remains (the admission
    needs the last prompt position's logits);
  * decode writes land at positions ``>= prompt_len``, i.e. strictly past
    every published block, so a shared block is never written after it
    becomes shareable — no write ever needs to fork a block;
  * a slot's final block is never published (the engine clamps
    past-``max_len`` decode writes into it, legacy-style degrade).

Ownership is reference counting: a physical block is held by each slot
table that maps it plus one reference for its trie node.  Blocks return to
the free list when the count reaches zero; LRU leaf eviction drops
trie-only blocks when allocation starves.  ``check()`` asserts the
conservation invariant (every block exactly free xor referenced, and the
reference total equals table references + trie nodes) — the accounting the
kv-prefix benchmark gates on (zero blocks leaked).

All host-side and synchronous: the engine consults this pool at admission
/ retirement / migration; device code only ever sees the resulting int32
block tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class BlockPool:
    """Free list + per-block reference counts over ``num_blocks`` physical
    KV blocks of ``block_size`` tokens each."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 1 and block_size >= 1, (num_blocks, block_size)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refs: List[int] = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, b: int) -> int:
        return self._refs[b]

    def alloc(self) -> Optional[int]:
        """Take a free block with refcount 1 (None when exhausted)."""
        if not self._free:
            return None
        b = self._free.pop()
        assert self._refs[b] == 0, f"block {b} on free list with refs"
        self._refs[b] = 1
        return b

    def incref(self, b: int) -> None:
        assert self._refs[b] > 0, f"incref of unallocated block {b}"
        self._refs[b] += 1

    def decref(self, b: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        assert self._refs[b] > 0, f"double free of block {b}"
        self._refs[b] -= 1
        if self._refs[b] == 0:
            self._free.append(b)
            return True
        return False

    def check(self) -> None:
        """Conservation: every block is exactly free xor referenced."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entry"
        for b in range(self.num_blocks):
            assert (self._refs[b] == 0) == (b in free), \
                f"block {b}: refs={self._refs[b]} free={b in free}"


class _Node:
    __slots__ = ("key", "parent", "block", "children", "tick")

    def __init__(self, key: bytes, parent: Optional["_Node"], block: int):
        self.key = key
        self.parent = parent
        self.block = block
        self.children: Dict[bytes, "_Node"] = {}
        self.tick = 0


class PrefixTrie:
    """Content-addressed chains of full token blocks -> physical blocks.

    Each node keys one full block of prompt tokens (by its raw int32 bytes,
    scoped under its parent — equal contents under different prefixes are
    different nodes) and holds ONE pool reference on the physical block
    carrying that block's KV.  ``match`` walks the chain for a prompt and
    increfs every matched block on behalf of the caller's slot table;
    ``insert`` publishes a freshly prefilled chain, keeping any existing
    node where one already covers a block (the caller's private copy stays
    private — the contents are bitwise-identical, see serve/engine.py).
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._children: Dict[bytes, _Node] = {}
        self._nodes: List[_Node] = []
        self._tick = 0

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    def _blocks_of(self, tokens: np.ndarray) -> List[bytes]:
        bs = self.pool.block_size
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        n = len(toks) // bs
        return [toks[i * bs:(i + 1) * bs].tobytes() for i in range(n)]

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest full-block prefix match; increfs each matched block for
        the caller (who now co-owns them via its slot table)."""
        out: List[int] = []
        children = self._children
        for key in self._blocks_of(tokens):
            node = children.get(key)
            if node is None:
                break
            self._touch(node)
            self.pool.incref(node.block)
            out.append(node.block)
            children = node.children
        return out

    def match_len(self, tokens: np.ndarray) -> int:
        """Peek variant of ``match``: matched block count, no references
        taken, no LRU touch (routing probes must not pin blocks)."""
        n = 0
        children = self._children
        for key in self._blocks_of(tokens):
            node = children.get(key)
            if node is None:
                break
            n += 1
            children = node.children
        return n

    def insert(self, tokens: np.ndarray, blocks: List[int]) -> int:
        """Publish a prefilled chain: ``blocks[i]`` holds the KV of the
        i-th full token block.  Existing nodes win (their block carries
        bitwise-identical KV); each newly created node increfs its block.
        Returns the number of nodes created."""
        created = 0
        children = self._children
        parent: Optional[_Node] = None
        for key, blk in zip(self._blocks_of(tokens), blocks):
            node = children.get(key)
            if node is None:
                node = _Node(key, parent, blk)
                self.pool.incref(blk)
                children[key] = node
                self._nodes.append(node)
                created += 1
            self._touch(node)
            parent = node
            children = node.children
        return created

    def _remove(self, node: _Node) -> bool:
        """Drop one (leaf) node; returns True when its block was freed."""
        assert not node.children
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        del siblings[node.key]
        self._nodes.remove(node)
        return self.pool.decref(node.block)

    def evict(self, need: int = 1) -> int:
        """LRU-evict leaf nodes whose block has no other holder (refcount
        1 = trie only) until ``need`` blocks were freed or no candidate is
        left.  Removing a leaf can expose its parent as the next
        candidate."""
        freed = 0
        while freed < need:
            cands = [n for n in self._nodes
                     if not n.children and self.pool.refcount(n.block) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.tick)
            if self._remove(victim):
                freed += 1
        return freed

    def drop_all(self) -> None:
        """Release every node (blocks still table-held stay allocated)."""
        while self._nodes:
            leaf = next(n for n in self._nodes if not n.children)
            self._remove(leaf)
        self._children = {}


class KVPool:
    """Slot-table facade over ``BlockPool`` + ``PrefixTrie`` — the surface
    the serving engine drives.

    One serving slot at a time owns each table; ``admit`` releases the
    previous occupant's table, matches the prompt's shared prefix (capped
    to full blocks, to at most ``blocks_per_slot - 1`` blocks, and so that
    at least one suffix token remains), and allocates private blocks for
    the rest of the table.  ``publish`` (called after the suffix prefill
    dispatch completes, so same-wave admissions never alias in-flight
    writes) inserts the slot's full prompt blocks into the trie.
    """

    def __init__(self, *, num_blocks: int, block_size: int, slots: int,
                 blocks_per_slot: int):
        assert num_blocks >= slots * blocks_per_slot, \
            "pool must at least cover every slot's table"
        self.pool = BlockPool(num_blocks, block_size)
        self.trie = PrefixTrie(self.pool)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.blocks_per_slot = blocks_per_slot
        self._tables: List[Optional[List[int]]] = [None] * slots
        self._matched: List[int] = [0] * slots
        self._tokens: List[Optional[np.ndarray]] = [None] * slots

    # -- admission / retirement ----------------------------------------------

    def _alloc(self) -> Optional[int]:
        b = self.pool.alloc()
        while b is None:
            if not self.trie.evict(1):
                return None
            b = self.pool.alloc()
        return b

    def max_shared_blocks(self, prompt_tokens: int) -> int:
        """Cap on shareable blocks for a prompt: full blocks only, ≥1
        suffix token left for the admission logits, final table block
        always private (it absorbs clamped overflow decode writes)."""
        return max(0, min((prompt_tokens - 1) // self.block_size,
                          self.blocks_per_slot - 1))

    def admit(self, slot: int, tokens: np.ndarray, *, share: bool = True):
        """Bind ``slot`` to a fresh table for ``tokens`` (the truncated
        prompt).  Returns ``(table, matched)`` — the (blocks_per_slot,)
        int32 physical-block table and the number of leading blocks mapped
        onto already-prefilled shared blocks."""
        self.release(slot)
        tokens = np.asarray(tokens, np.int32)
        cap = self.max_shared_blocks(len(tokens))
        matched = (self.trie.match(tokens[:cap * self.block_size])
                   if share and cap else [])
        table = list(matched)
        for _ in range(self.blocks_per_slot - len(matched)):
            b = self._alloc()
            if b is None:
                for blk in table:
                    self.pool.decref(blk)
                raise RuntimeError(
                    f"KV pool exhausted ({self.num_blocks} blocks, "
                    f"{self.trie.n_nodes} trie nodes)")
            table.append(b)
        self._tables[slot] = table
        self._matched[slot] = len(matched)
        self._tokens[slot] = tokens
        return np.asarray(table, np.int32), len(matched)

    def publish(self, slot: int) -> int:
        """Insert the slot's full prompt blocks into the trie (call after
        the prefill dispatch lands).  Returns nodes created."""
        tokens = self._tokens[slot]
        table = self._tables[slot]
        assert tokens is not None and table is not None, f"slot {slot} empty"
        nfull = self.max_shared_blocks(len(tokens) + 1)
        # nfull counts FULL prompt blocks (cap formula with one virtual
        # extra token admits an exactly-full final prompt block), still
        # excluding the table's last block
        nfull = min(nfull, len(tokens) // self.block_size)
        return self.trie.insert(tokens[:nfull * self.block_size],
                                table[:nfull])

    def release(self, slot: int) -> None:
        """Drop the slot's table references (retire / export / reassign)."""
        table = self._tables[slot]
        if table is None:
            return
        for b in table:
            self.pool.decref(b)
        self._tables[slot] = None
        self._matched[slot] = 0
        self._tokens[slot] = None

    # -- introspection --------------------------------------------------------

    def table(self, slot: int) -> Optional[List[int]]:
        return self._tables[slot]

    def shared_blocks(self, slot: int) -> int:
        return self._matched[slot]

    def match_len(self, tokens: np.ndarray) -> int:
        """Shareable-block count a prompt would match right now (peek — the
        router's prefix-affinity score; takes no references)."""
        tokens = np.asarray(tokens, np.int32)
        cap = self.max_shared_blocks(len(tokens))
        return self.trie.match_len(tokens[:cap * self.block_size])

    def stats(self) -> Dict[str, int]:
        table_refs = sum(len(t) for t in self._tables if t is not None)
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free_blocks": self.pool.free_blocks,
            "allocated_blocks": self.pool.allocated_blocks,
            "trie_nodes": self.trie.n_nodes,
            "table_refs": table_refs,
            "shared_table_blocks": sum(self._matched),
        }

    def check(self) -> None:
        """Full accounting audit: free-list/refcount conservation AND the
        reference total equals table references + trie nodes (no block
        leaked, none double-held)."""
        self.pool.check()
        want = [0] * self.num_blocks
        for t in self._tables:
            for b in (t or []):
                want[b] += 1
        for n in self.trie._nodes:
            want[n.block] += 1
        for b in range(self.num_blocks):
            assert self.pool.refcount(b) == want[b], \
                f"block {b}: refs={self.pool.refcount(b)} holders={want[b]}"

    def close(self) -> None:
        """Release every slot and the trie; asserts nothing leaked."""
        for slot in range(self.slots):
            self.release(slot)
        self.trie.drop_all()
        self.check()
        assert self.pool.allocated_blocks == 0, \
            f"{self.pool.allocated_blocks} blocks leaked"
