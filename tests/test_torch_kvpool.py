"""The port's copy of the KV block pool and prefix trie
(``repro_torch/serve/kvpool.py``) against ``repro.serve.kvpool``.

Every test drives both pools with the same operation sequence, mirroring
``tests/test_kvpool.py``: each call must return the same thing on both
sides, and after every operation the slot tables, ``stats()`` and the
``match_len`` of the prompts seen so far must be identical, besides the
port's own invariants (``check``, a leak-free ``close``).
"""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.serve import kvpool as JKV
from repro_torch.serve import kvpool as TKV


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    return a == b


class Pair:
    """One `KVPool` of each package, driven in lockstep."""

    def __init__(self, **kw):
        self.j = JKV.KVPool(**kw)
        self.t = TKV.KVPool(**kw)
        self.slots = kw["slots"]
        self.prompts = []

    def __getattr__(self, name):
        def call(*args, **kw):
            if name == "admit":
                self.prompts.append(np.asarray(args[1], np.int32))
            got = getattr(self.t, name)(*args, **kw)
            want = getattr(self.j, name)(*args, **kw)
            assert _eq(got, want), (name, args, got, want)
            self.same()
            return got
        return call

    def same(self):
        assert self.t.stats() == self.j.stats()
        for s in range(self.slots):
            assert _eq(self.t.table(s), self.j.table(s)), s
            if self.t.table(s) is not None:
                assert self.t.shared_blocks(s) == self.j.shared_blocks(s)
        for p in self.prompts:
            assert self.t.match_len(p) == self.j.match_len(p)
        self.t.check()


def _pools(num, size):
    return JKV.BlockPool(num, size), TKV.BlockPool(num, size)


class TestBlockPool:
    def test_alloc_free_cycle(self):
        for p in _pools(4, 8):
            blocks = [p.alloc() for _ in range(4)]
            assert sorted(blocks) == [0, 1, 2, 3] and p.alloc() is None
            assert p.free_blocks == 0 and p.allocated_blocks == 4
            assert [p.decref(b) for b in blocks] == [True] * 4
            assert p.free_blocks == 4
            p.check()

    @pytest.mark.parametrize("case", ["double_free", "stray_incref"])
    def test_misuse_rejected(self, case):
        for p in _pools(2, 4):
            if case == "double_free":
                b = p.alloc()
                p.decref(b)
                with pytest.raises(AssertionError):
                    p.decref(b)
            else:
                with pytest.raises(AssertionError):
                    p.incref(0)

    def test_refcounted_sharing(self):
        for p in _pools(2, 4):
            b = p.alloc()
            p.incref(b)
            assert not p.decref(b) and p.decref(b)
            p.check()


class TestTrieSharing:
    def test_publish_then_match_returns_same_blocks(self):
        kv = Pair(num_blocks=16, block_size=4, slots=2, blocks_per_slot=4)
        prompt = np.arange(13, dtype=np.int32)
        t0, m0 = kv.admit(0, prompt)
        kv.publish(0)
        t1, m1 = kv.admit(1, prompt)
        assert (m0, m1) == (0, 3) and list(t1[:3]) == list(t0[:3])
        kv.close()

    @pytest.mark.parametrize("plen,nb,cap", [(8, 4, 1), (8, 2, 1)])
    def test_share_caps(self, plen, nb, cap):
        """At least one suffix token stays private (nb 4), and the table's
        final block is never shared (nb 2)."""
        kv = Pair(num_blocks=16, block_size=4, slots=2, blocks_per_slot=nb)
        prompt = np.arange(plen, dtype=np.int32)
        kv.admit(0, prompt)
        kv.publish(0)
        _, m = kv.admit(1, prompt)
        assert m <= cap
        kv.close()

    def test_divergent_suffix_shares_common_prefix_only(self):
        kv = Pair(num_blocks=32, block_size=4, slots=2, blocks_per_slot=4)
        kv.admit(0, np.concatenate([np.arange(8), np.full(5, 7)]))
        kv.publish(0)
        _, m = kv.admit(1, np.concatenate([np.arange(8), np.full(5, 9)]))
        assert m == 2
        kv.close()

    def test_eviction_frees_trie_only_blocks(self):
        kv = Pair(num_blocks=8, block_size=4, slots=2, blocks_per_slot=4)
        kv.admit(0, np.arange(16, dtype=np.int32))
        kv.publish(0)
        kv.release(0)
        kv.admit(0, np.full(16, 3, np.int32), share=False)
        kv.admit(1, np.full(16, 5, np.int32), share=False)
        kv.close()


class TestRefcountConservation:
    @settings(max_examples=6, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3),
                              st.integers(0, 2), st.integers(1, 17)),
                    min_size=1, max_size=30))
    def test_any_interleaving_matches(self, ops):
        slots, bs, nb = 4, 4, 4
        kv = Pair(num_blocks=2 * slots * nb, block_size=bs, slots=slots,
                  blocks_per_slot=nb)
        published = [False] * slots
        for op, slot, header, plen in ops:
            if op == 0:
                prompt = np.concatenate([np.full(8, 100 + header),
                                         np.arange(plen)])[:nb * bs]
                kv.admit(slot, prompt)
                published[slot] = False
            elif op == 1 and kv.t.table(slot) is not None:
                if not published[slot]:
                    kv.publish(slot)
                    published[slot] = True
            elif op == 2:
                kv.release(slot)
                published[slot] = False
            else:                                     # migrate: re-admit
                dst = (slot + 1) % slots
                toks = kv.t._tokens[slot]
                kv.release(slot)
                published[slot] = False
                if toks is not None:
                    kv.admit(dst, toks)
                    published[dst] = False
        kv.close()

    @settings(max_examples=4, deadline=None)
    @given(st.lists(st.integers(0, 4), min_size=1, max_size=10))
    def test_shared_blocks_survive_publisher_exit(self, headers):
        kv = Pair(num_blocks=24, block_size=4, slots=3, blocks_per_slot=4)
        for h in headers:
            prompt = np.concatenate([np.full(8, 50 + h), np.arange(6)])
            kv.admit(0, prompt)
            kv.publish(0)
            t1, m1 = kv.admit(1, prompt)
            kv.release(0)
            for b in t1[:m1]:
                assert kv.t.pool.refcount(b) == kv.j.pool.refcount(b) >= 2
            kv.release(1)
        kv.t.trie.drop_all()
        kv.j.trie.drop_all()
        kv.same()
        assert kv.t.pool.allocated_blocks == 0

    def test_close_after_heavy_churn_is_leak_free(self):
        rng = np.random.RandomState(0)
        kv = Pair(num_blocks=32, block_size=4, slots=4, blocks_per_slot=4)
        for _ in range(120):
            slot = int(rng.randint(4))
            if rng.rand() < 0.25:
                kv.release(slot)
                continue
            prompt = np.concatenate([
                np.full(8, 200 + int(rng.randint(3))),
                rng.randint(0, 99, size=int(rng.randint(1, 9)))])
            kv.admit(slot, prompt)
            if rng.rand() < 0.8:
                kv.publish(slot)
        kv.close()
        assert kv.t.pool.free_blocks == 32


def test_trie_lru_evicts_least_recent():
    out = []
    for M in (JKV, TKV):
        pool = M.BlockPool(8, 2)
        trie = M.PrefixTrie(pool)
        a, b = pool.alloc(), pool.alloc()
        trie.insert(np.asarray([1, 2], np.int32), [a])
        trie.insert(np.asarray([3, 4], np.int32), [b])
        pool.decref(a)
        pool.decref(b)
        trie.match(np.asarray([1, 2], np.int32))
        pool.decref(a)
        out.append((trie.evict(1), trie.n_nodes,
                    trie.match_len(np.asarray([1, 2], np.int32)),
                    trie.match_len(np.asarray([3, 4], np.int32))))
    assert out[0] == out[1] == (1, 1, 1, 0)
