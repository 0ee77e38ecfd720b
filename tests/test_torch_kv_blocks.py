"""The port's block allocator, prefix cache and swap arena hold the
invariants ``tests/test_kv_blocks.py`` pins for the JAX package's:
conservation (free + live == usable, and free + live + swapped across
preemption), no aliasing between live holders, a mapped block is never
reclaimed, and chain keys diverge with their prefix."""

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models.kv_blocks import (
    SCRATCH_BLOCK,
    BlockAllocator,
    BlockError,
    SwapArena,
    blocks_for,
)
from tf_operator_tpu_torch.models.prefix_cache import PrefixCache, chain_keys

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_conserve_and_never_alias(seed):
    r = np.random.default_rng(seed)
    alloc = BlockAllocator(num_blocks=int(r.integers(3, 40)), block_size=4)
    holders = []  # each holder's block list; shared blocks are retained
    for _ in range(300):
        op = r.integers(0, 3)
        if op == 0:
            ids = alloc.alloc(int(r.integers(0, 6)))
            if ids is not None:
                holders.append(ids)
        elif op == 1 and holders:
            ids = holders.pop(int(r.integers(0, len(holders))))
            alloc.release(ids)
        elif op == 2 and holders:
            src = holders[int(r.integers(0, len(holders)))]
            if src:
                share = src[: int(r.integers(1, len(src) + 1))]
                alloc.retain(share)
                holders.append(list(share))
        alloc.check()
        held = [b for h in holders for b in h]
        assert SCRATCH_BLOCK not in held
        assert alloc.in_use == len(set(held))
        for bid in set(held):
            assert alloc.refcount(bid) == held.count(bid)
        assert alloc.free_count + alloc.in_use == alloc.usable


@pytest.mark.parametrize("case", ["double_free", "bad_retain", "shortfall", "validation"])
def test_contract_violations_raise(case):
    alloc = BlockAllocator(num_blocks=5, block_size=4)
    if case == "double_free":
        ids = alloc.alloc(2)
        alloc.release(ids)
        with pytest.raises(BlockError):
            alloc.release(ids[:1])
    elif case == "bad_retain":
        with pytest.raises(BlockError):
            alloc.retain([3])
    elif case == "shortfall":
        assert alloc.alloc(5) is None and alloc.free_count == 4  # all or nothing
    else:
        with pytest.raises(ValueError):
            BlockAllocator(num_blocks=1, block_size=4)
        with pytest.raises(ValueError):
            BlockAllocator(num_blocks=4, block_size=0)
    alloc.check()


@pytest.mark.parametrize("tokens,bs,want", [(0, 4, 0), (1, 4, 1), (4, 4, 1), (5, 4, 2), (13, 12, 2)])
def test_blocks_for_is_ceil_division(tokens, bs, want):
    assert blocks_for(tokens, bs) == want


@pytest.mark.parametrize("capacity", [None, 1])
def test_mapped_blocks_are_never_reclaimed(capacity):
    alloc = BlockAllocator(num_blocks=6, block_size=4)
    cache = PrefixCache(
        capacity=capacity,
        can_evict=lambda bid: alloc.refcount(bid) == 1,
        on_evict=lambda bid: alloc.release([bid]),
    )
    seat = alloc.alloc(2)
    for i, bid in enumerate(seat):
        alloc.retain([bid])  # the cache's own reference
        cache.put(bytes([i]), bid)
    # both entries are mapped by the seat: no pressure evicts them
    assert cache.evict_lru(need=2) == 0
    assert all(alloc.refcount(b) == 2 for b in seat)
    alloc.release(seat)  # the seat retires; only the cache holds them
    assert len(cache) == 2  # over capacity rather than reclaim a mapped block
    assert cache.evict_lru(need=2) == 2 and len(cache) == 0
    alloc.check()
    assert alloc.free_count == alloc.usable


@pytest.mark.parametrize("bs", [4, 12])
def test_chain_keys_address_the_whole_prefix(bs):
    r = np.random.default_rng(bs)
    a = r.integers(0, 256, 3 * bs + 2)
    b = a.copy()
    b[0] ^= 1  # same later blocks, different first block
    ka, kb = chain_keys(a, bs), chain_keys(b, bs)
    assert len(ka) == 3  # the partial tail gets no key
    assert all(x != y for x, y in zip(ka, kb))  # divergence carries forward
    assert chain_keys(a[: 2 * bs], bs) == ka[:2]  # a shared prefix shares keys


def test_prefix_cache_counts_per_request_and_lru():
    cache = PrefixCache(capacity=2)
    cache.put(b"a", 1)
    cache.put(b"b", 2)
    assert cache.peek(b"a") == 1  # refreshes a; b is now LRU
    cache.put(b"c", 3)
    assert b"b" not in cache and b"a" in cache and cache.evictions == 1
    cache.record(True)
    cache.record(False)
    assert (cache.hits, cache.misses) == (1, 1)


def test_swap_arena_accounting_and_cap_match_the_jax_arena():
    """``tests/test_kv_blocks.py::TestSwapArena`` on the port's copy, with
    the JAX arena run through the same calls beside it."""

    from tf_operator_tpu.models.kv_blocks import SwapArena as JaxSwapArena

    snaps = []
    for cls in (SwapArena, JaxSwapArena):
        s = cls(capacity_blocks=4)
        assert s.admit(4) and not s.admit(5)
        s.put(1, {"live": [], "blocks": [0, 1, 2]}, n_blocks=3, nbytes=300)
        assert s.swapped_blocks == 3 and len(s) == 1
        assert s.admit(1) and not s.admit(2)
        assert s.peek(1)["n_blocks"] == 3 and s.peek(2) is None
        with pytest.raises(Exception, match="already has a swap record"):
            s.put(1, {}, n_blocks=0, nbytes=0)
        rec = s.pop(1, nbytes=300)
        assert rec["blocks"] == [0, 1, 2]
        assert s.swapped_blocks == 0 and len(s) == 0
        with pytest.raises(Exception, match="has no swap record"):
            s.pop(1)
        snaps.append(s.snapshot())
        assert cls().admit(10**9)  # unbounded
    assert snaps[0] == snaps[1] == {
        "records": 0, "swapped_blocks": 0, "capacity_blocks": 4,
        "bytes_out_total": 300, "bytes_in_total": 300}
    with pytest.raises(BlockError):
        SwapArena().pop(0)


@pytest.mark.parametrize("seed", range(3))
def test_random_admit_preempt_resume_retire_conserves(seed):
    """The pool's reference discipline under random admit / grow /
    publish / preempt / resume / retire: the device side conserves,
    each record's swapped + swap-exempt live blocks are its committed
    set, and seats, cache and records explain every live block."""

    r = np.random.default_rng(seed)
    alloc = BlockAllocator(25, 16)  # 24 usable
    swap = SwapArena()
    seats = {}  # rid -> [bid, ...] in logical order
    cache = []  # bids the prefix cache holds (one ref each)
    rid_next = 0

    def check_world():
        alloc.check()
        held = {b for refs in seats.values() for b in refs} | set(cache)
        for rid in list(swap._records):
            rec = swap.peek(rid)
            held |= {b for _, b in rec["live"]}
            assert rec["n_blocks"] + len(rec["live"]) == rec["committed"]
        assert alloc.in_use == len(held)
        assert alloc.free_count == alloc.usable - len(held)
        assert swap.swapped_blocks == sum(
            swap.peek(rid)["n_blocks"] for rid in list(swap._records))

    def resume(rid):
        rec = swap.peek(rid)
        ids = alloc.alloc(rec["n_blocks"])
        if ids is None:
            return False
        refs = [None] * rec["committed"]
        for i, b in rec["live"]:
            refs[i] = b
        for j, i in enumerate(rec["blocks"]):
            refs[i] = ids[j]
        swap.pop(rid, nbytes=rec["n_blocks"] * 10)
        seats[rid] = refs
        return True

    for _ in range(600):
        op = r.integers(5)
        if op == 0:  # admit: commit a few blocks, maybe publish one
            ids = alloc.alloc(int(r.integers(1, 5)))
            if ids is not None:
                seats[rid_next] = list(ids)
                if r.random() < 0.4:
                    alloc.retain([ids[0]])
                    cache.append(ids[0])
                rid_next += 1
        elif op == 1 and seats:  # lazy growth
            ids = alloc.alloc(1)
            if ids is not None:
                seats[list(seats)[r.integers(len(seats))]].extend(ids)
        elif op == 2 and seats:  # preempt: private blocks swap, exempt stay live
            rid = list(seats)[r.integers(len(seats))]
            refs = seats.pop(rid)
            exempt = [(i, b) for i, b in enumerate(refs) if alloc.refcount(b) > 1]
            private = [(i, b) for i, b in enumerate(refs) if alloc.refcount(b) == 1]
            alloc.release([b for _, b in private])
            swap.put(rid, {"live": exempt, "blocks": [i for i, _ in private],
                           "committed": len(refs)},
                     n_blocks=len(private), nbytes=len(private) * 10)
        elif op == 3 and len(swap):
            resume(list(swap._records)[r.integers(len(swap))])
        elif op == 4 and seats:  # retire
            alloc.release(seats.pop(list(seats)[r.integers(len(seats))]))
        check_world()
    for _ in range(1000):  # drain: resume everything, freeing room as needed
        if not len(swap):
            break
        for rid in list(swap._records):
            if not resume(rid):
                if seats:
                    alloc.release(seats.pop(list(seats)[0]))
                elif cache:
                    alloc.release([cache.pop()])
        check_world()
    assert not len(swap) and swap.swapped_blocks == 0
    assert swap.bytes_in_total == swap.bytes_out_total
