"""FASTA/FASTQ reading with gzip/bzip2 support and N-trimming.

Replaces the reference's kseq-based FastxReader + decompression FIFOs
(reference src/sequence/io/fastx_reader.cpp, src/megahit:700-745). The
N-trimming rule matches FastxReader::TrimN (fastx_reader.cpp:56-71):
keep only the FIRST maximal run of non-N characters.
"""

from __future__ import annotations

import bz2
import gzip
import io
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..core import packing


@dataclass
class FastxRecord:
    name: str
    seq: bytes  # raw ASCII


class _SubprocStream(io.RawIOBase):
    """stdout of a decompressor subprocess as a readable stream.

    The reference feeds gz/bz2 through `gzip -cd`/`bzip2 -cd`
    subprocesses into FIFOs (src/megahit:700-745) so decompression
    runs on its own core, overlapped with downstream parse+pack; this
    is the same pipeline parallelism without the filesystem FIFO. A
    feeder failure aborts the read (reference :733-737)."""

    def __init__(self, argv: list[str]):
        import subprocess

        self.argv = argv
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            bufsize=0,
        )

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = self.proc.stdout.readinto(b)
        if n == 0:  # EOF: verify the feeder exited cleanly
            rc = self.proc.wait()
            if rc != 0:
                err = self.proc.stderr.read().decode(errors="replace")
                raise IOError(
                    f"{' '.join(self.argv)} failed (rc={rc}): {err}")
        return n

    def close(self) -> None:
        if not self.closed:
            if self.proc.poll() is None:
                self.proc.terminate()
                self.proc.wait()
            self.proc.stdout.close()
            self.proc.stderr.close()
        super().close()


def _popen_decompressor(tool: str, path: str):
    import shutil

    if shutil.which(tool) is None:
        return None
    try:
        return io.BufferedReader(
            _SubprocStream([tool, "-dc", path]), 1 << 20)
    except OSError:
        return None


def _open(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(3)
    if magic[:2] == b"\x1f\x8b":
        # prefer a parallel-capable inflater when present
        for tool in ("pigz", "gzip"):
            fh = _popen_decompressor(tool, path)
            if fh is not None:
                return fh
        return gzip.open(path, "rb")
    if magic == b"BZh":
        for tool in ("pbzip2", "lbzip2", "bzip2"):
            fh = _popen_decompressor(tool, path)
            if fh is not None:
                return fh
        return bz2.open(path, "rb")
    return open(path, "rb")


def iter_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a (possibly compressed) FASTA or FASTQ file."""
    with _open(path) as fh:
        yield from _iter_fastx_stream(io.BufferedReader(fh, 1 << 20))


def _iter_fastx_stream(fh) -> Iterator[FastxRecord]:
    first = fh.peek(1)[:1]
    if not first:
        return
    if first == b">":
        name = None
        chunks: list[bytes] = []
        for line in fh:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    yield FastxRecord(name, b"".join(chunks))
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield FastxRecord(name, b"".join(chunks))
    elif first == b"@":
        while True:
            raw = fh.readline()
            if not raw:  # EOF (a blank line is just skipped)
                return
            hdr = raw.rstrip()
            if not hdr:
                continue
            seq = fh.readline().rstrip()
            fh.readline()  # +
            fh.readline()  # qual
            name = hdr[1:].split()[0].decode() if len(hdr) > 1 else ""
            yield FastxRecord(name, seq)
    else:
        raise ValueError(f"not FASTA/FASTQ (starts with {first!r})")


_NOT_N = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _NOT_N[_c] = True


def trim_n(seq: bytes) -> bytes:
    """Keep the first maximal run of non-N characters (reference TrimN)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    good = _NOT_N[arr]
    if good.all():
        return seq
    idx = np.flatnonzero(good)
    if len(idx) == 0:
        return b""
    b = idx[0]
    bad_after = np.flatnonzero(~good[b:])
    e = b + bad_after[0] if len(bad_after) else len(seq)
    return seq[b:e]


def _open_bulk(path: str):
    """Reader for whole-file ingestion. zlib via the Python module
    releases the GIL, so bulk reads inflate gzip in-process; the
    subprocess feeders serve the whole-buffer fallback."""
    with open(path, "rb") as probe:
        magic = probe.read(3)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")
    if magic == b"BZh":
        for tool in ("pbzip2", "lbzip2"):
            fh = _popen_decompressor(tool, path)
            if fh is not None:
                return fh
        return bz2.open(path, "rb")
    return open(path, "rb")


def _raw_chunks(path: str, chunk: int = 16 << 20):
    """Yield decompressed chunks with one-chunk background prefetch,
    so inflation (zlib releases the GIL) overlaps the consumer's
    native parse - the reference's FIFO-feeder pipeline parallelism
    (src/megahit:700-745) in-process."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that aborts when the consumer has gone away, so an
        # early generator close (e.g. malformed input breaking the parse
        # loop) can't leave this thread blocked on a full queue and the
        # finally-join deadlocked.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            with _open_bulk(path) as fh:
                while not stop.is_set():
                    data = fh.read(chunk)
                    if not data:
                        break
                    if not _put(bytes(data)):
                        return
            _put(None)
        except BaseException as e:  # surfaced by the consumer
            _put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is None:
                break
            yield item
    finally:
        stop.set()
        t.join()


def read_fastx_flat(
    path: str, do_trim_n: bool = True, chunk_bytes: int = 16 << 20
) -> tuple[np.ndarray, np.ndarray]:
    """Read a whole file into pool form (flat_codes, starts).

    Uses the native C++ parser (megahit_tpu_torch.native) - the
    reference's host I/O core is C++ too (kseq + SequencePackage).
    Chunked: the native partial parser consumes complete records per
    decompressed chunk (carrying the cut tail) while the next chunk
    inflates in a background thread; input it rejects as malformed
    goes to the whole-buffer Python line parser."""
    from .. import native

    code_parts, len_parts = [], []
    carry = b""
    ok = True
    for data in _raw_chunks(path, chunk_bytes):
        buf = carry + data if carry else data
        out = native.parse_fastx_partial(buf, eof=False,
                                         trim_n=do_trim_n)
        if out is None:  # malformed for the fast path
            ok = False
            break
        codes, lens, consumed = out
        code_parts.append(codes)
        len_parts.append(lens)
        carry = buf[consumed:]
    if ok and carry:
        out = native.parse_fastx_partial(carry, eof=True,
                                         trim_n=do_trim_n)
        if out is None:
            ok = False
        else:
            code_parts.append(out[0])
            len_parts.append(out[1])
    if ok:
        if not code_parts:
            return np.zeros(0, np.uint8), np.zeros(1, np.int64)
        flat = np.concatenate(code_parts)
        lens = np.concatenate(len_parts)
        starts = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        return flat, starts

    with _open(path) as fh:
        data = fh.read()
        if isinstance(data, memoryview):
            data = bytes(data)
    out = native.parse_fastx_buffer_flat(data, trim_n=do_trim_n)
    if out is not None:
        return out
    seqs = []
    for rec in _iter_fastx_bytes(data):
        s = trim_n(rec.seq) if do_trim_n else rec.seq
        seqs.append(packing.encode(s))
    return packing.pack_many(seqs)


def _iter_fastx_bytes(data: bytes):
    import io as _io

    fh = _io.BufferedReader(_io.BytesIO(data), 1 << 20)
    yield from _iter_fastx_stream(fh)
