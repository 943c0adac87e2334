"""megahit_tpu_torch.core.kmerops against megahit_tpu.core.kmerops.

The same seeded numpy inputs go through the JAX function (on the CPU
backend) and the port's torch (int64 words) and numpy paths; every
result must be exactly equal (integer work)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megahit_tpu.core import kmerops as jk
from megahit_tpu_torch.core import kmerops as tk

import torch_test_env  # noqa: F401

KS = [15, 22, 31, 42, 56]


def _keys(rng, n, k):
    w = jk.words_per_kmer(k)
    raw = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    return np.asarray(jk.mask_tail(raw, k))


def _t(a):
    return tk.to_torch(a, "cpu")


def _n(t):
    return tk.to_numpy(t)


def test_pack_flat_codes():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 16 * 37).astype(np.uint8)
    want = np.asarray(jk.pack_flat_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(tk.pack_flat_codes(codes), want)
    np.testing.assert_array_equal(
        _n(tk.pack_flat_codes(torch.from_numpy(codes))), want)


@pytest.mark.parametrize("k", KS)
def test_extract_kmers(k):
    rng = np.random.default_rng(k)
    packed = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    want_all = np.asarray(jk.extract_all_kmers(jnp.asarray(packed), k))
    got_all = _n(tk.extract_all_kmers(_t(packed), k))
    np.testing.assert_array_equal(got_all, want_all)
    pos = rng.integers(0, (300 - 5) * 16, 500).astype(np.int32)
    want = np.asarray(jk.extract_kmers(jnp.asarray(packed),
                                       jnp.asarray(pos), k))
    got = _n(tk.extract_kmers(_t(packed), torch.from_numpy(pos), k))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", KS)
def test_key_surgery(k):
    rng = np.random.default_rng(100 + k)
    keys = _keys(rng, 400, k)
    jkeys = jnp.asarray(keys)
    cases = {
        "mask_tail": (lambda m, x: m.mask_tail(x, k - 3)),
        "revcomp": (lambda m, x: m.revcomp_kmers(x, k)),
        "drop_first": (lambda m, x: m.drop_first_base(x, k)),
        "shift_left": (lambda m, x: m.shift_left_bits(x, 6)),
        "shift_right": (lambda m, x: m.shift_right_bits(x, 10)),
        "prepend": (lambda m, x: m.prepend_base(x, 2, k)),
        "set_base": (lambda m, x: m.set_base(x, k - 1, 1)),
        "canonical": (lambda m, x: m.canonical_kmers(x, k)[0]),
    }
    for name, f in cases.items():
        want = np.asarray(f(jk, jkeys))
        np.testing.assert_array_equal(_n(f(tk, _t(keys))), want, name)
        np.testing.assert_array_equal(f(tk, keys), want, name)
    for i in (0, k // 2, k - 1):
        want = np.asarray(jk.get_base(jkeys, i))
        np.testing.assert_array_equal(_n(tk.get_base(_t(keys), i)), want)
        np.testing.assert_array_equal(tk.get_base(keys, i), want)
    other = _keys(rng, 400, k)
    other[::3] = keys[::3]
    for name in ("lex_less", "lex_eq"):
        want = np.asarray(getattr(jk, name)(jkeys, jnp.asarray(other)))
        got = getattr(tk, name)(_t(keys), _t(other)).numpy()
        np.testing.assert_array_equal(got, want, name)
        np.testing.assert_array_equal(
            getattr(tk, name)(keys, other), want, name)
    _, want_rc = jk.canonical_kmers(jkeys, k)
    _, got_rc = tk.canonical_kmers(_t(keys), k)
    np.testing.assert_array_equal(got_rc.numpy(), np.asarray(want_rc))


@pytest.mark.parametrize("k", KS)
def test_ref_order_and_host_helpers(k):
    rng = np.random.default_rng(200 + k)
    keys = _keys(rng, 300, k)
    np.testing.assert_array_equal(
        tk.ref_order_keys(keys, k),
        np.asarray(jk.ref_order_keys(keys, k)))
    if k <= 32:
        np.testing.assert_array_equal(tk.ref_order_u64(keys, k),
                                      jk.ref_order_u64(keys, k))
        np.testing.assert_array_equal(tk.keys_to_u64(keys, k),
                                      jk.keys_to_u64(keys, k))
    for a, b in zip(tk.pack_u64_columns(keys), jk.pack_u64_columns(keys)):
        np.testing.assert_array_equal(a, b)


def test_all_t_sentinel_k16():
    """k % 16 == 0: a real all-T key equals the all-ones sentinel; its
    canonical form is all-A, and sorts keep it with the sentinels."""
    k = 32
    allt = np.full((3, 2), 0xFFFFFFFF, np.uint32)
    want = np.asarray(jk.canonical_kmers(jnp.asarray(allt), k)[0])
    np.testing.assert_array_equal(tk.canonical_kmers(allt, k)[0], want)
    np.testing.assert_array_equal(
        _n(tk.canonical_kmers(_t(allt), k)[0]), want)
    assert not want.any()  # all-A


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_sort_order_with_sentinels(w):
    """Lexicographic (unsigned) order with all-ones sentinel rows, high
    words above 2^31 and duplicates, for W = 1..4."""
    rng = np.random.default_rng(300 + w)
    keys = rng.integers(0, 2 ** 32, (500, w), dtype=np.uint32)
    keys[::7] = keys[1::7][: len(keys[::7])]
    keys[-40:] = 0xFFFFFFFF
    keys[:20, 0] = rng.integers(2 ** 31, 2 ** 32, 20, dtype=np.uint32)
    pay = np.arange(len(keys), dtype=np.int32)
    (want,) = jk.sort_keys_with_payload(jnp.asarray(keys))
    want = np.asarray(want)
    skeys, spay = tk.sort_keys_with_payload(_t(keys), torch.from_numpy(pay))
    np.testing.assert_array_equal(_n(skeys), want)
    np.testing.assert_array_equal(keys[spay.numpy()], want)
    hkeys, _ = tk.sort_keys_with_payload(keys, pay)
    np.testing.assert_array_equal(hkeys, want)
    assert (want[-40:] == 0xFFFFFFFF).all()
    # pack/unpack round trip and signed order of the packed columns
    cols = tk.pack_sort_keys([_t(keys)[:, i] for i in range(w)])
    back = torch.stack(tk.unpack_sort_keys(cols, w), dim=1)
    np.testing.assert_array_equal(_n(back), keys)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_count_sorted_runs_and_searchsorted(w):
    rng = np.random.default_rng(400 + w)
    n = 3000
    keys = rng.integers(0, 50, (n, w)).astype(np.uint32)
    valid = np.ones(n, bool)
    keys[-25:] = 0xFFFFFFFF
    valid[-25:] = False
    (skeys,) = jk.sort_keys_with_payload(jnp.asarray(keys))
    skeys = np.asarray(skeys)
    h0, c0 = jk.count_sorted_runs(jnp.asarray(skeys), jnp.asarray(valid))
    h1, c1 = tk.count_sorted_runs(_t(skeys), torch.from_numpy(valid))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(h0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))
    cols = tuple(jnp.asarray(skeys[:, i]) for i in range(w))
    h0, c0 = jk.count_sorted_runs_soa(cols, jnp.asarray(valid))
    h1, c1 = tk.count_sorted_runs_soa(
        tuple(_t(skeys)[:, i] for i in range(w)), torch.from_numpy(valid))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(h0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))
    table = np.unique(skeys[:-25], axis=0)
    queries = rng.integers(0, 50, (700, w)).astype(np.uint32)
    i0, f0 = jk.searchsorted_keys(jnp.asarray(table), jnp.asarray(queries))
    i1, f1 = tk.searchsorted_keys(_t(table), _t(queries))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(f1.numpy(), np.asarray(f0))


def test_member_sorted_and_blocked_search():
    rng = np.random.default_rng(9)
    table = np.unique(rng.integers(0, 2 ** 40, 5000).astype(np.uint64))
    q = rng.integers(0, 2 ** 40, 3000).astype(np.uint64)
    q[::4] = table[: len(q[::4])]
    for a, b in zip(tk.member_sorted_mt(table, q), jk.member_sorted_mt(
            table, q)):
        np.testing.assert_array_equal(a, b)
    top = (table >> np.uint64(8)).astype(np.uint32)
    qtop = (q >> np.uint64(8)).astype(np.uint32)
    np.testing.assert_array_equal(
        tk.searchsorted_blocked_np(table, q, top, qtop),
        jk.searchsorted_blocked_np(table, q, top, qtop))
