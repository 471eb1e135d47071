"""The plain references against numpy at tiny sizes, their controls
against the references, and `compare`'s counts."""
import numpy as np
import pytest
import torch

from portbench.reference import (filtered_group_by_sum, hash_join,
                                 sort_keys, sort_kv)

RNG = np.random.default_rng(5)


def _u32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)
                            .copy()).view(torch.uint32)


def _np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def test_sort_keys_is_numpys_sort():
    keys = RNG.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    keys[:50] = keys[50:100]                  # ties
    keys[100] = 0xFFFFFFFF
    got = sort_keys.expect({"keys": _u32(keys)})
    assert np.array_equal(_np(got), np.sort(keys))


def test_sort_kv_is_numpys_stable_sort():
    keys = RNG.integers(0, 64, 5000).astype(np.uint32) * 0x04000000
    vals = np.arange(5000, dtype=np.uint32)
    sk, sv = sort_kv.expect({"keys": _u32(keys), "vals": _u32(vals)})
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(_np(sk), keys[order])
    assert np.array_equal(_np(sv), vals[order])


def _join_np(bk, bv, pk, pv):
    at = {int(k): i for i, k in enumerate(bk)}
    rows = [(k, v, bv[at[int(k)]]) for k, v in zip(pk, pv) if int(k) in at]
    return len(rows), [np.array([r[j] for r in rows], dtype=np.uint32)
                       for j in range(3)]


def test_hash_join_is_a_dict_lookup():
    bk = RNG.permutation(4000).astype(np.uint32)[:1000] * 7 + 3
    bv = RNG.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    pk = RNG.integers(0, 28000, 9000).astype(np.uint32)
    pv = np.arange(9000, dtype=np.uint32)
    a = {"o_orderkey": _u32(bk), "o_orderdate": _u32(bv),
         "l_orderkey": _u32(pk), "l_extendedprice": _u32(pv)}
    count, *cols = hash_join.expect(a)
    want_count, want = _join_np(bk, bv, pk, pv)
    assert count == want_count
    for c, w in zip(cols, want):
        assert np.array_equal(_np(c), w)


def test_filtered_group_by_sum_is_a_dict_of_sums():
    n = 20000
    ship = RNG.integers(0, 3000, n).astype(np.uint32)
    group = RNG.choice([0x4146, 0x4E46, 0x4E4F, 0x5246], n).astype(np.uint32)
    qty = RNG.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ones = np.ones(n, dtype=np.uint32)
    a = {"l_shipdate": _u32(ship), "l_group": _u32(group),
         "values": {"l_quantity": _u32(qty), "ones": _u32(ones)},
         "hi": 2437}
    count, uk, sums = filtered_group_by_sum.expect(a)
    keep = ship < 2437
    assert count == len(np.unique(group[keep]))
    assert _np(uk).tolist() == sorted(np.unique(group[keep]).tolist())
    for col, got in zip((qty, ones), sums, strict=True):
        want = {}
        for g, q in zip(group[keep], col[keep]):
            want[int(g)] = (want.get(int(g), 0) + int(q)) % 2**32
        assert _np(got).tolist() == [want[g] for g in sorted(want)]
    # the program's answer: one (count, keys, sums) a column
    got = tuple((torch.tensor(count), uk, x) for x in sums)
    assert filtered_group_by_sum.compare(got, (count, uk, sums)) == {
        "count_diff": 0, "group_mismatches": 0}
    assert filtered_group_by_sum.compare(got[:1], (count, uk, sums)) == {
        "count_diff": count, "group_mismatches": count}


def test_controls_break_the_guarantee():
    # keys closer than a float32 step (256 above 2^31) in reverse order
    keys = _u32(np.array([0x80000005, 0x80000001, 7, 0x80000003],
                         dtype=np.uint32))
    vals = _u32(np.arange(4, dtype=np.uint32))
    a = {"keys": keys, "vals": vals}
    assert sort_keys.compare(sort_keys.control(a),
                             sort_keys.expect(a))["key_mismatches"] == 3
    m = sort_kv.compare(sort_kv.control(a), sort_kv.expect(a))
    assert m["key_mismatches"] == 3 and m["payload_mismatches"] == 3
    # order keys above 2^24, one apart: float32 cannot tell them apart
    bk = np.array([2**25 + 1, 2**25 + 2, 2**25 + 3], dtype=np.uint32)
    j = {"o_orderkey": _u32(bk), "o_orderdate": _u32([10, 20, 30]),
         "l_orderkey": _u32(bk[::-1]), "l_extendedprice": _u32([1, 2, 3])}
    m = hash_join.compare(hash_join.control(j), hash_join.expect(j))
    assert m["count_diff"] == 0 and m["row_mismatches"] >= 1
    # sums past 2^24 in float32
    n = 1 << 16
    q = {"l_shipdate": _u32(np.zeros(n)), "l_group": _u32(np.zeros(n)),
         "values": {"l_quantity": _u32(np.full(n, 2**10 + 1)),
                    "ones": _u32(np.ones(n))}, "hi": 1}
    m = filtered_group_by_sum.compare(filtered_group_by_sum.control(q),
                                      filtered_group_by_sum.expect(q))
    assert m == {"count_diff": 0, "group_mismatches": 1}


@pytest.mark.parametrize("cut", [0, 1, 10])
def test_compare_counts_missing_rows(cut):
    keys = _u32(np.arange(100, dtype=np.uint32)[::-1])
    want = sort_keys.expect({"keys": keys})
    got = want[:100 - cut]
    assert sort_keys.compare(got, want)["key_mismatches"] == cut
