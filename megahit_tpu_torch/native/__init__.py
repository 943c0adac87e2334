"""Native (C++) host-side cores, loaded via ctypes.

Built on demand with g++ into the package's git-ignored ``_build/``
directory. The cores are required: a core that g++ cannot build, or
whose library does not load, raises ``NativeBuildError`` with the
compiler's or the loader's message. Only the FASTA/Q parsers return
None, for input the native parser rejects as malformed (io/fastx.py
parses it in Python).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..utils.log import get_logger

_DIR = os.path.dirname(__file__)
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libfastxpack.so")
_SRC = os.path.join(_DIR, "fastxpack.cpp")

_lib = None


class NativeBuildError(RuntimeError):
    """A native core did not build (the message holds g++'s output) or
    its library did not load (the message holds the loader's error)."""


def _build_so(src: str, so: str, extra: tuple[str, ...] = (),
              what: str = "") -> None:
    """Compile `src` -> `so` atomically (temp file + os.replace so a
    concurrent process never CDLLs a half-written .so). Raises
    NativeBuildError with the compiler's message on failure."""
    tmp = f"{so}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(so), exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", *extra, src, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(
            f"native build of {what or src}: {' '.join(cmd)} did not run: "
            f"{e}") from e
    if res.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeBuildError(
            f"native build of {what or src} failed (g++ exit "
            f"{res.returncode}):\n{res.stderr.strip()}")
    os.replace(tmp, so)


def _needs_build(src: str, so: str) -> bool:
    return not os.path.exists(so) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(so)
    )


def _load(src: str, so: str, what: str, bind,
          extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build `so` from `src` when it is missing or older, load it and
    bind its symbols with `bind(lib)`. Raises NativeBuildError when g++
    fails or the library does not load."""
    if _needs_build(src, so):
        _build_so(src, so, extra=extra, what=what)
    try:
        lib = ctypes.CDLL(so)
        bind(lib)
    except (OSError, AttributeError) as e:
        raise NativeBuildError(
            f"native {what}: {so} was built but does not load: {e}") from e
    return lib


def native_status() -> dict[str, bool]:
    """Availability of each native core (for checkcpu-style reports); a
    core that does not build or load reports False and its error is
    logged."""
    status = {}
    for name, load in (("fastxpack", get_lib),
                       ("graphwalk", get_graphwalk),
                       ("seedscan", get_seedscan)):
        try:
            load()
            status[name] = True
        except NativeBuildError as e:
            get_logger().error("%s", e)
            status[name] = False
    return status


def get_lib() -> ctypes.CDLL:
    """The loaded fastxpack library (NativeBuildError if it does not
    build or load)."""
    global _lib
    if _lib is None:
        _lib = _load(_SRC, _SO, "fastxpack", _bind_fastxpack)
    return _lib


def _bind_fastxpack(lib) -> None:
    lib.fastx_parse.restype = ctypes.c_int64
    lib.fastx_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int,
    ]
    lib.pack_codes.restype = None
    lib.pack_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.fastx_parse_partial.restype = ctypes.c_int64
    lib.fastx_parse_partial.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]


def parse_fastx_buffer_flat(
    data: bytes, trim_n: bool = True
) -> tuple[np.ndarray, np.ndarray] | None:
    """Parse a decompressed FASTA/FASTQ buffer natively.

    Returns (flat_codes uint8, starts int64 (S+1,)) - the pool form
    every downstream consumer wants - or None if the input is malformed
    for the native parser (the caller parses it in Python).
    """
    lib = get_lib()
    if not data:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    n = len(data)
    codes = np.empty(n, dtype=np.uint8)
    max_seqs = data.count(b"\n") + 2
    lens = np.empty(max_seqs, dtype=np.int64)
    n_seqs = lib.fastx_parse(
        data, n,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_seqs, 1 if trim_n else 0,
    )
    if n_seqs < 0:
        return None  # malformed for the fast path; Python handles it
    lens = lens[:n_seqs]
    starts = np.zeros(n_seqs + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    return codes[: starts[-1]].copy(), starts


def parse_fastx_partial(
    data: bytes, eof: bool, trim_n: bool = True
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Parse the COMPLETE records of a chunk; returns (flat_codes,
    lens, consumed_bytes) - the incomplete tail is the caller's carry.
    None if the chunk is malformed for the native parser."""
    lib = get_lib()
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), 0
    codes = np.empty(n, dtype=np.uint8)
    max_seqs = n // 4 + 2
    lens = np.empty(max_seqs, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    n_seqs = lib.fastx_parse_partial(
        data, n, 1 if eof else 0,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_seqs, 1 if trim_n else 0,
        ctypes.byref(consumed),
    )
    if n_seqs < 0:
        return None
    lens = lens[:n_seqs]
    return codes[: int(lens.sum())].copy(), lens.copy(), consumed.value


# ---------------------------------------------------------------------------
# graphwalk: O(E) host chain ranking (see graphwalk.cpp)
# ---------------------------------------------------------------------------

_GW_SO = os.path.join(BUILD_DIR, "libgraphwalk.so")
_GW_SRC = os.path.join(_DIR, "graphwalk.cpp")
_gw_lib = None


def get_graphwalk() -> ctypes.CDLL:
    """The loaded graphwalk library (NativeBuildError if it does not
    build or load)."""
    global _gw_lib
    if _gw_lib is None:
        _gw_lib = _load(_GW_SRC, _GW_SO, "graphwalk", _bind_graphwalk)
    return _gw_lib


def _bind_graphwalk(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.chain_rank.restype = None
    lib.chain_rank.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, i32p, i32p, i32p, u8p,
    ]
    lib.collect_chain_edges.restype = ctypes.c_int64
    lib.collect_chain_edges.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64, i32p,
    ]


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# seedscan: rolling-window pool scan + parallel u64 sort (see seedscan.cpp)
# ---------------------------------------------------------------------------

_SS_SO = os.path.join(BUILD_DIR, "libseedscan.so")
_SS_SRC = os.path.join(_DIR, "seedscan.cpp")
_ss_lib = None


class _ScanResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("rid", ctypes.POINTER(ctypes.c_int32)),
        ("ia", ctypes.POINTER(ctypes.c_int32)),
        ("ib", ctypes.POINTER(ctypes.c_int32)),
        ("flag", ctypes.POINTER(ctypes.c_uint8)),
    ]


def get_seedscan() -> ctypes.CDLL:
    """The loaded seedscan library (NativeBuildError if it does not
    build or load)."""
    global _ss_lib
    if _ss_lib is None:
        _ss_lib = _load(_SS_SRC, _SS_SO, "seedscan", _bind_seedscan,
                        extra=("-std=c++17", "-pthread"))
    return _ss_lib


def _bind_seedscan(lib) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.seed_scan.restype = ctypes.POINTER(_ScanResult)
    lib.seed_scan.argtypes = [
        u32p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, u32p, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.seed_scan_free.restype = None
    lib.seed_scan_free.argtypes = [ctypes.POINTER(_ScanResult)]
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.transform_rows.restype = None
    lib.transform_rows.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u32p, ctypes.c_int,
    ]
    lib.row_search.restype = None
    lib.row_search.argtypes = [
        u32p, ctypes.c_int64, u32p, ctypes.c_int64, ctypes.c_int,
        i64p, u8p, ctypes.c_int,
    ]
    lib.argsort_rows.restype = None
    lib.argsort_rows.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int, i64p, ctypes.c_int,
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.simple_links.restype = None
    lib.simple_links.argtypes = [
        i32p, i32p, i32p, u8p, i32p, ctypes.c_int64,
        ctypes.c_int64, i32p, i32p, ctypes.c_int,
    ]


SCAN_CANON = 0
SCAN_FWD = 1
SCAN_BOTH = 2


def seed_scan(packed_words: np.ndarray, starts: np.ndarray, k: int,
              table: np.ndarray, mode: int, min_read_len: int = 0):
    """Scan every k-window of the packed pool against the sorted (T, W)
    table. Returns (pos int64, rid int32, idx_a int32, idx_b
    int32|None, flag u8) for hit positions only, ascending.

    mode SCAN_CANON: probe min(fwd, rc); idx_a = row, flag = is_rc.
    mode SCAN_FWD:   probe fwd only; idx_a = row.
    mode SCAN_BOTH:  probe fwd and rc; idx_a / idx_b = rows or -1.
    """
    lib = get_seedscan()
    table = np.ascontiguousarray(table, dtype=np.uint32)
    if table.ndim == 1:
        table = table[:, None]
    w = table.shape[1]
    assert (k + 15) // 16 == w, (k, w)
    packed_words = np.ascontiguousarray(packed_words, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n_reads = len(starts) - 1
    assert len(packed_words) * 16 >= int(starts[-1])
    res = lib.seed_scan(
        packed_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_reads), k, w, mode,
        ctypes.c_int64(min_read_len),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(table)),
        _scan_threads(),
    )
    try:
        n = res.contents.n
        pos = np.ctypeslib.as_array(res.contents.pos, (n,)).copy() \
            if n else np.zeros(0, np.int64)
        rid = np.ctypeslib.as_array(res.contents.rid, (n,)).copy() \
            if n else np.zeros(0, np.int32)
        ia = np.ctypeslib.as_array(res.contents.ia, (n,)).copy() \
            if n else np.zeros(0, np.int32)
        ib = None
        if mode == SCAN_BOTH:
            ib = np.ctypeslib.as_array(res.contents.ib, (n,)).copy() \
                if n else np.zeros(0, np.int32)
        flag = np.ctypeslib.as_array(res.contents.flag, (n,)).copy() \
            if n else np.zeros(0, np.uint8)
    finally:
        lib.seed_scan_free(res)
    return pos, rid, ia, ib, flag


def _scan_threads() -> int:
    from ..utils.threads import num_threads

    return max(1, min(16, num_threads()))


OP_REVCOMP = 0
OP_REF_ORDER = 1
OP_DROP_FIRST = 2


def transform_rows(keys: np.ndarray, k: int, op: int) -> np.ndarray:
    """Per-row key transform on (N, W) left-aligned 2-bit rows:
    OP_REVCOMP = kmerops.revcomp_kmers, OP_REF_ORDER =
    kmerops.ref_order_keys, OP_DROP_FIRST = kmerops.drop_first_base."""
    lib = get_seedscan()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, w = keys.shape
    if w > 16:  # the C side's row buffers are uint32_t[16] (k <= 256)
        raise ValueError(f"transform_rows: {w} words a row, at most 16")
    out = np.empty_like(keys)
    lib.transform_rows(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n), k, w, op,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _scan_threads(),
    )
    return out


def argsort_rows(keys: np.ndarray) -> np.ndarray:
    """Lexicographic argsort of (N, W) u32 rows, UNSTABLE between
    equal rows; parallel for W <= 4."""
    lib = get_seedscan()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, w = keys.shape
    perm = np.empty(n, np.int64)
    lib.argsort_rows(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n), w,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _scan_threads(),
    )
    return perm


def row_search(table: np.ndarray, queries: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Batched lower_bound of (Q, W) query rows in the sorted (N, W)
    table -> (idx int64, found bool)."""
    lib = get_seedscan()
    table = np.ascontiguousarray(table, dtype=np.uint32)
    queries = np.ascontiguousarray(queries, dtype=np.uint32)
    assert table.ndim == 2 and queries.ndim == 2
    assert table.shape[1] == queries.shape[1]
    nq = len(queries)
    idx = np.empty(nq, np.int64)
    found = np.empty(nq, np.uint8)
    lib.row_search(
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(table)),
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(nq), table.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _scan_threads(),
    )
    return idx, found.astype(bool)


def simple_links(run_start: np.ndarray, nxt_link: np.ndarray,
                 rc: np.ndarray, valid: np.ndarray, rvc: np.ndarray,
                 real: int) -> tuple[np.ndarray, np.ndarray]:
    """Threaded simple-path links (sdbg.simple_path_links_host)."""
    lib = get_seedscan()
    e = len(run_start)
    i32 = ctypes.POINTER(ctypes.c_int32)

    def p(a):
        return a.ctypes.data_as(i32)

    run_start = np.ascontiguousarray(run_start, dtype=np.int32)
    nxt_link = np.ascontiguousarray(nxt_link, dtype=np.int32)
    rc = np.ascontiguousarray(rc, dtype=np.int32)
    rvc = np.ascontiguousarray(rvc, dtype=np.int32)
    validu = np.ascontiguousarray(valid, dtype=np.uint8)
    nxt = np.empty(e, np.int32)
    prv = np.empty(e, np.int32)
    lib.simple_links(
        p(run_start), p(nxt_link), p(rc),
        validu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        p(rvc), ctypes.c_int64(e), ctypes.c_int64(real),
        p(nxt), p(prv), _scan_threads(),
    )
    return nxt, prv


def chain_rank(nxt: np.ndarray, prv: np.ndarray, valid: np.ndarray):
    """(chain_start, chain_end, pos, is_cycle) per edge."""
    lib = get_graphwalk()
    e = len(nxt)
    nxt = np.ascontiguousarray(nxt, dtype=np.int32)
    prv = np.ascontiguousarray(prv, dtype=np.int32)
    validu = np.ascontiguousarray(valid, dtype=np.uint8)
    cs = np.empty(e, np.int32)
    ce = np.empty(e, np.int32)
    pos = np.empty(e, np.int32)
    cyc = np.empty(e, np.uint8)
    lib.chain_rank(
        _i32p(nxt), _i32p(prv),
        validu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(e), _i32p(cs), _i32p(ce), _i32p(pos),
        cyc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return cs, ce, pos, cyc.astype(bool)


def collect_chain_edges(nxt: np.ndarray, starts: np.ndarray,
                        lens: np.ndarray) -> np.ndarray:
    """Edge indices of the chains starting at `starts` with lengths
    `lens` (walks nxt)."""
    lib = get_graphwalk()
    nxt = np.ascontiguousarray(nxt, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    total = int(lens.sum())
    out = np.empty(total, np.int32)
    w = lib.collect_chain_edges(
        _i32p(nxt), _i32p(starts), _i32p(lens),
        ctypes.c_int64(len(starts)), _i32p(out),
    )
    assert w == total, (w, total)
    return out
