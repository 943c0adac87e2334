"""k-mer primitives: multi-word keys as (N, W) arrays of 32-bit words.

A k-mer key is ``W = ceil(k/16)`` words, 2-bit big-endian packed,
left-aligned (trailing bits of the last word are zero). Lexicographic
order over bases == lexicographic order over the word tuple.

Two representations, one contract per helper (numpy in -> numpy out,
torch in -> torch out):

- numpy: (N, W) ``uint32``, the host layout every artifact uses;
- torch: (N, W) ``int64`` holding the u32 word values in [0, 2^32).
  ``torch.uint32`` has no ordering, shifts or ``searchsorted``, so
  words ride in int64, where every such op exists and signed order
  equals the unsigned word order. Sort keys pack two words into one
  int64 with the top bit flipped (``pack_sort_keys``), so the signed
  order of the packed value equals the unsigned order of the pair and
  the all-ones sentinel sorts last.

Counterpart of megahit_tpu/core/kmerops.py.
"""

from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 16
U32 = np.uint32
M32 = 0xFFFFFFFF
SIGN32 = 0x80000000


def words_per_kmer(k: int) -> int:
    return (k + BASES_PER_WORD - 1) // BASES_PER_WORD


# ---------------------------------------------------------------------------
# representation changes
# ---------------------------------------------------------------------------


def to_torch(keys: np.ndarray, device) -> torch.Tensor:
    """u32 numpy words -> int64 torch words on `device`."""
    a = np.ascontiguousarray(keys, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device).to(
        torch.int64) & M32


def to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int64 (or int32-bits) torch words -> u32 numpy words."""
    return (keys & M32).to(torch.int64).cpu().numpy().astype(np.uint32)


def i32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32 bits (the
    kernels' operand type)."""
    w = words & M32
    return torch.where(w >= SIGN32, w - (1 << 32), w).to(torch.int32)


def u32_value(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 u32 values (inverse of i32_bits)."""
    return bits.to(torch.int64) & M32


# ---------------------------------------------------------------------------
# packing a flat code array
# ---------------------------------------------------------------------------


def pack_flat_codes(codes):
    """uint8 codes (B,) -> packed words (ceil(B/16),), big-endian.

    B must be a multiple of 16 (pad first). numpy -> uint32 numpy;
    torch -> int64 torch words."""
    b = codes.shape[0]
    if b % BASES_PER_WORD:
        raise ValueError("pad flat codes to a multiple of 16")
    if isinstance(codes, np.ndarray):
        c = codes.astype(np.uint32).reshape(b // 16, 16)
        shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(
            np.uint32)
        return np.bitwise_or.reduce(c << shifts, axis=1)
    c = codes.to(torch.int64).reshape(b // 16, 16)
    shifts = 30 - 2 * torch.arange(16, device=codes.device)
    return (c << shifts).sum(dim=1)


# ---------------------------------------------------------------------------
# k-mer extraction by funnel shift (torch)
# ---------------------------------------------------------------------------


def extract_kmers(packed: torch.Tensor, positions: torch.Tensor,
                  k: int) -> torch.Tensor:
    """(N, W) k-mers starting at base offsets `positions` of the packed
    (P,) int64 word pool: each output word is a funnel shift of two
    gathered input words."""
    w = words_per_kmer(k)
    p = packed.shape[0]
    positions = positions.to(torch.int64)
    word0 = positions // BASES_PER_WORD
    bitoff = (positions % BASES_PER_WORD) * 2
    idx = word0[:, None] + torch.arange(w + 1, device=packed.device)[None]
    words = packed[torch.clamp(idx, max=p - 1)]
    out = _funnel(words[:, :w], words[:, 1:], bitoff[:, None])
    return mask_tail(out, k)


def _funnel(hi: torch.Tensor, lo: torch.Tensor, sh) -> torch.Tensor:
    """Top 32 bits of (hi:lo) << sh, for 0 <= sh < 32 (int64 words)."""
    return ((hi << sh) | (lo >> (32 - sh))) & M32


def extract_all_kmers(packed: torch.Tensor, k: int) -> torch.Tensor:
    """k-mer keys at EVERY base offset of a packed (P,) pool: returns
    ((P - W) * 16, W), row p = the k-mer starting at base p. Rows whose
    window crosses a sequence boundary are garbage; callers mask them."""
    w = words_per_kmer(k)
    q = packed.shape[0] - w
    if q <= 0:
        raise ValueError("packed pool shorter than one k-mer")
    a = torch.stack([packed[j:j + q] for j in range(w + 1)], dim=1)
    lo, hi = a[:, :w], a[:, 1:]
    variants = [lo] + [_funnel(lo, hi, 2 * r) for r in range(1, 16)]
    keys = torch.stack(variants, dim=1).reshape(q * 16, w)
    return mask_tail(keys, k)


def mask_tail(keys, k: int):
    """Zero the unused low bits of the last word."""
    w = keys.shape[-1]
    used = k - (w - 1) * BASES_PER_WORD
    if used == BASES_PER_WORD:
        return keys
    mask = (M32 << (32 - 2 * used)) & M32
    out = keys.copy() if isinstance(keys, np.ndarray) else keys.clone()
    out[..., -1] &= U32(mask) if isinstance(keys, np.ndarray) else mask
    return out


# ---------------------------------------------------------------------------
# reverse complement / canonical
# ---------------------------------------------------------------------------

_REV2_LUT = np.array(
    [((b & 3) << 6) | (((b >> 2) & 3) << 4) | (((b >> 4) & 3) << 2)
     | (b >> 6) for b in range(256)], dtype=np.uint8)


def _reverse_bases_in_word(x):
    """Reverse the 16 2-bit groups within each 32-bit word."""
    if isinstance(x, np.ndarray):
        b = _REV2_LUT[np.ascontiguousarray(x).view(np.uint8)]
        return np.ascontiguousarray(
            b.reshape(-1, 4)[:, ::-1]).view(np.uint32).reshape(x.shape)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) | (x >> 16)) & M32


def _not(keys):
    return ~keys if isinstance(keys, np.ndarray) else (~keys) & M32


def shift_left_bits(keys, nbits: int):
    """Left-shift a (N, W) multi-word key by nbits (< 32), cross-word."""
    if nbits == 0:
        return keys
    if isinstance(keys, np.ndarray):
        nb = U32(nbits)
        out = keys << nb
        np.bitwise_or(out[..., :-1], keys[..., 1:] >> (U32(32) - nb),
                      out=out[..., :-1])
        return out
    lo_src = torch.cat([keys[..., 1:], torch.zeros_like(keys[..., :1])],
                       dim=-1)
    return _funnel(keys, lo_src, nbits)


def shift_right_bits(keys, nbits: int):
    """Right-shift a (N, W) multi-word key by nbits (< 32), cross-word."""
    if nbits == 0:
        return keys
    if isinstance(keys, np.ndarray):
        nb = U32(nbits)
        hi_src = np.concatenate(
            [np.zeros_like(keys[..., :1]), keys[..., :-1]], axis=-1)
        return (keys >> nb) | (hi_src << (U32(32) - nb))
    hi_src = torch.cat([torch.zeros_like(keys[..., :1]), keys[..., :-1]],
                       dim=-1)
    return ((keys >> nbits) | (hi_src << (32 - nbits))) & M32


def _flip_words(x):
    return x[..., ::-1] if isinstance(x, np.ndarray) else x.flip(-1)


def revcomp_kmers(keys, k: int):
    """(N, W) -> reverse complement, same layout: complement is a
    bitwise NOT, reversal a per-word 2-bit-group reversal + word-order
    reversal + left shift that restores left alignment. Large host
    inputs go through the native per-row transform."""
    if (isinstance(keys, np.ndarray) and keys.ndim == 2
            and len(keys) >= (1 << 14)):
        from ..native import OP_REVCOMP, transform_rows

        return transform_rows(keys, k, OP_REVCOMP)
    w = keys.shape[-1]
    rev = _flip_words(_reverse_bases_in_word(_not(keys)))
    pad_bases = w * BASES_PER_WORD - k
    out = shift_left_bits(rev, 2 * pad_bases) if pad_bases else rev
    return mask_tail(out, k)


def ref_order_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, W) edge keys -> keys whose lexicographic order equals the
    reference's SdBG edge-id order: reverse(chars[0..k-2]) ++
    chars[k-1], left-aligned (host numpy)."""
    if keys.ndim == 2 and len(keys) >= (1 << 14):
        from ..native import OP_REF_ORDER, transform_rows

        return transform_rows(keys, k, OP_REF_ORDER)
    node = mask_tail(keys, k - 1)
    rev_node = mask_tail(~revcomp_kmers(node, k - 1), k - 1)
    last = get_base(keys, k - 1).astype(U32)
    widx = (k - 1) // BASES_PER_WORD
    sh = U32(30 - 2 * ((k - 1) % BASES_PER_WORD))
    col = (rev_node[..., widx] | (last << sh))[..., None]
    out = np.concatenate(
        [rev_node[..., :widx], col, rev_node[..., widx + 1:]], axis=-1)
    return mask_tail(out, k)


def lex_less(a, b):
    """(N, W) < (N, W) lexicographic, word-major. Returns (N,) bool."""
    if isinstance(a, np.ndarray):
        lt = np.zeros(a.shape[:-1], dtype=bool)
        eq = np.ones(a.shape[:-1], dtype=bool)
    else:
        lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
        eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1]):
        lt = lt | (eq & (a[..., i] < b[..., i]))
        eq = eq & (a[..., i] == b[..., i])
    return lt


def lex_eq(a, b):
    if isinstance(a, np.ndarray):
        return np.all(a == b, axis=-1)
    return torch.all(a == b, dim=-1)


def canonical_kmers(keys, k: int):
    """(canonical keys, is_rc), canonical = min(key, rc(key)); the rc
    is used only when strictly smaller (reference kmer_counter.cpp:137)."""
    rc = revcomp_kmers(keys, k)
    use_rc = lex_less(rc, keys)
    if isinstance(keys, np.ndarray):
        return np.where(use_rc[..., None], rc, keys), use_rc
    return torch.where(use_rc[..., None], rc, keys), use_rc


# ---------------------------------------------------------------------------
# single-base surgery on keys
# ---------------------------------------------------------------------------


def get_base(keys, i: int):
    """Base at static position i of each key, in [0, 3]."""
    word = i // BASES_PER_WORD
    sh = 30 - 2 * (i % BASES_PER_WORD)
    if isinstance(keys, np.ndarray):
        return (keys[..., word] >> U32(sh)) & U32(3)
    return (keys[..., word] >> sh) & 3


def set_base(keys, i: int, c):
    """Set base at static position i to c (scalar or (N,) array)."""
    word = i // BASES_PER_WORD
    sh = 30 - 2 * (i % BASES_PER_WORD)
    if isinstance(keys, np.ndarray):
        cleared = keys[..., word] & ~(U32(3) << U32(sh))
        cval = (np.asarray(c).astype(U32) & U32(3)) << U32(sh)
        col = (cleared | cval)[..., None]
        return np.concatenate(
            [keys[..., :word], col, keys[..., word + 1:]], axis=-1)
    cleared = keys[..., word] & (M32 ^ (3 << sh))
    cval = (torch.as_tensor(c, device=keys.device).to(torch.int64) & 3) \
        << sh
    col = (cleared | cval)[..., None]
    return torch.cat([keys[..., :word], col, keys[..., word + 1:]],
                     dim=-1)


def drop_first_base(keys, k: int):
    """keys[1:k] followed by a zero base: left shift by one base."""
    if (isinstance(keys, np.ndarray) and keys.ndim == 2
            and len(keys) >= (1 << 14)):
        from ..native import OP_DROP_FIRST, transform_rows

        return transform_rows(keys, k, OP_DROP_FIRST)
    return mask_tail(shift_left_bits(keys, 2), k)


def prepend_base(keys, c, k: int):
    """c + keys[0:k-1]: right shift by one base, set base 0 to c."""
    return mask_tail(set_base(shift_right_bits(keys, 2), 0, c), k)


# ---------------------------------------------------------------------------
# sorting and searching multi-word keys
# ---------------------------------------------------------------------------


def pack_sort_keys(words) -> list[torch.Tensor]:
    """W int64 word columns -> ceil(W/2) int64 columns whose signed
    lexicographic order equals the unsigned word order: two words per
    column, top bit flipped (a lone last word rides in the high half),
    so the all-ones sentinel packs to the int64 maximum."""
    w = len(words)
    cols = []
    for i in range(0, w, 2):
        hi = words[i] ^ SIGN32
        lo = words[i + 1] if i + 1 < w else torch.zeros_like(hi)
        cols.append((hi << 32) | lo)
    return cols


def unpack_sort_keys(cols, w: int) -> list[torch.Tensor]:
    """Inverse of pack_sort_keys -> W int64 word columns."""
    words = []
    for c in cols:
        words.append(((c >> 32) & M32) ^ SIGN32)
        words.append(c & M32)
    return words[:w]


def argsort_packed(cols) -> torch.Tensor:
    """Stable lexicographic argsort of pack_sort_keys columns (a chain
    of stable sorts, least significant column first)."""
    perm = torch.sort(cols[-1], stable=True).indices
    for c in reversed(cols[:-1]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def argsort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of (N, W) int64 words."""
    return argsort_packed(
        pack_sort_keys([keys[:, i] for i in range(keys.shape[1])]))


def sort_keys_with_payload(keys, *payloads):
    """Lexicographically sort (N, W) keys; payloads are permuted along.
    numpy keys sort on host (native row argsort, unstable between equal
    rows); torch keys sort on their device (stable)."""
    if isinstance(keys, np.ndarray):
        order = argsort_rows_np(keys)
        return (keys[order],) + tuple(np.asarray(p)[order]
                                      for p in payloads)
    order = argsort_keys(keys)
    return (keys[order],) + tuple(p[order] for p in payloads)


def cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    """Reversed cumulative minimum of a 1-D tensor."""
    return torch.cummin(x.flip(0), dim=0).values.flip(0)


def count_sorted_runs(skeys: torch.Tensor, valid: torch.Tensor):
    """Run-length count over lexicographically sorted (N, W) keys.

    valid marks real rows; invalid rows MUST carry all-ones sentinel
    keys, which sort to the tail. Returns (head, counts): head marks the
    first row of each run holding at least one valid row; counts holds,
    on head rows, the number of valid rows in the run."""
    return count_sorted_runs_soa(
        tuple(skeys[:, i] for i in range(skeys.shape[1])), valid)


def count_sorted_runs_soa(cols, valid: torch.Tensor):
    """count_sorted_runs over SoA columns (tuple of (N,) words)."""
    from .kernels import count_sorted_runs_plain

    return count_sorted_runs_plain(cols, int((~valid).sum()))


def searchsorted_keys(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """Batched multi-word binary search: (idx, found), idx = index of
    the exact match or the insertion point. A fixed trip-count loop of
    multi-word compares over the whole query batch."""
    e = sorted_keys.shape[0]
    q = queries.shape[0]
    dev = queries.device
    lo = torch.zeros(q, dtype=torch.int64, device=dev)
    hi = torch.full((q,), e, dtype=torch.int64, device=dev)
    steps = max(1, int(np.ceil(np.log2(max(e, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = lex_less(sorted_keys[torch.clamp(mid, max=e - 1)], queries)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    safe = torch.clamp(lo, max=max(e - 1, 0))
    found = (lo < e) & lex_eq(sorted_keys[safe], queries) if e else \
        torch.zeros(q, dtype=torch.bool, device=dev)
    return lo, found


# ---------------------------------------------------------------------------
# host (numpy) helpers
# ---------------------------------------------------------------------------


def keys_to_u64_words(keys: np.ndarray) -> np.ndarray:
    """(N, 2) u32 -> u64 preserving lexicographic word order."""
    return (keys[:, 0].astype(np.uint64) << np.uint64(32)) \
        | keys[:, 1].astype(np.uint64)


def pack_u64_columns(kn: np.ndarray) -> list[np.ndarray]:
    """(N, W) u32 -> ceil(W/2) u64 columns with identical lexicographic
    order."""
    w = kn.shape[-1]
    cols = []
    for i in range(0, w - 1, 2):
        cols.append((kn[:, i].astype(np.uint64) << np.uint64(32))
                    | kn[:, i + 1].astype(np.uint64))
    if w % 2:
        cols.append(kn[:, w - 1].astype(np.uint64) << np.uint64(32))
    return cols


def _reverse_bases_u64(x: np.ndarray) -> np.ndarray:
    """Reverse the 32 2-bit groups within each uint64."""
    b = _REV2_LUT[np.ascontiguousarray(x).view(np.uint8)]
    return np.ascontiguousarray(
        b.reshape(-1, 8)[:, ::-1]).view(np.uint64).ravel()


def argsort_rows_np(kn: np.ndarray) -> np.ndarray:
    """Lexicographic argsort of (N, W) u32 rows on host (unstable
    between equal rows)."""
    w = kn.shape[-1]
    if len(kn) >= (1 << 16):
        from ..native import argsort_rows

        return argsort_rows(kn)
    if w == 1:
        return np.argsort(kn[:, 0])
    cols = pack_u64_columns(kn)
    if len(cols) == 1:
        return np.argsort(cols[0])
    return np.lexsort(tuple(reversed(cols)))


def keys_to_u64(keys: np.ndarray, k: int) -> np.ndarray:
    """(N, W) keys with k <= 32 -> uint64 preserving lexicographic order
    ((word0 << 32) | word1; word1 = 0 when W == 1)."""
    assert k <= 32, "u64 fast path requires k <= 32"
    keys = np.asarray(keys)
    hi = keys[:, 0].astype(np.uint64) << np.uint64(32)
    lo = keys[:, 1].astype(np.uint64) if keys.shape[1] > 1 else 0
    return hi | lo


def member_sorted_mt(table: np.ndarray, q: np.ndarray, pool=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-threaded membership of q in a sorted 1-D table -> (idx,
    found). np.searchsorted releases the GIL, so query slices run in
    parallel on the given ThreadPoolExecutor."""
    n = len(q)
    idx = np.empty(n, dtype=np.int64)
    found = np.zeros(n, dtype=bool)
    if len(table) == 0 or n == 0:
        return idx[:n], found

    def one(sl):
        i = np.searchsorted(table, q[sl])
        return sl, i, table[np.minimum(i, len(table) - 1)] == q[sl]

    from ..utils.threads import num_threads

    parts = max(1, min(8, num_threads(), n // (1 << 18)))
    if parts == 1 or pool is None:
        sl = slice(0, n)
        _, idx[sl], found[sl] = one(sl)
        return idx, found
    step = -(-n // parts)
    for sl, i, f in pool.map(
        one, [slice(a, min(n, a + step)) for a in range(0, n, step)]
    ):
        idx[sl] = i
        found[sl] = f
    return idx, found
