"""ctypes bindings for the native C++ FASTA/FASTQ ingest (SURVEY.md C1/C2).

The extension parses + 2-bit-encodes straight into the padded int8
[batch, max_len] matrix the device consumes, skipping the per-read Python
object layer entirely. The library is built from ``native/pangea_io.cpp``
on first use, on the machine that runs it. Falls back silently to the numpy
reader (`pangea_tpu.io.fastx`) when it can't be built.
Encoding semantics are byte-identical to `core.semantics_np._BASE_LUT`
(SEMANTICS.md §1); verified in tests/test_io_native.py.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading

import numpy as np

_ID_STRIDE = 256
_lock = threading.Lock()
_lib = None
_lib_tried = False


def _native_dir() -> str:
    # repo_root/native relative to src/pangea_tpu/io/native.py
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "..", "native"))


def _build(d: str, so: str) -> None:
    """Build the library from source when it is missing or older than its
    source. Concurrent processes (test workers, multi-process runs) take an
    exclusive file lock; the compiler writes a temporary file that is
    renamed into place, so no process ever loads a half-written library."""
    src = os.path.join(d, "pangea_io.cpp")

    def stale() -> bool:
        return (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src))

    if not stale():
        return
    with open(os.path.join(d, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not stale():
            return                       # another process built it
        fd, tmp = tempfile.mkstemp(prefix=".libpangea_io.", suffix=".so",
                                   dir=d)
        os.close(fd)
        try:
            subprocess.run(["make", "-C", d, "-B", f"LIB={tmp}"],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _load_lib():
    """Load (building if needed) the shared library; None if unavailable."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        d = _native_dir()
        so = os.environ.get("PANGEA_IO_LIB")
        if so is None:
            so = os.path.join(d, "libpangea_io.so")
            if os.path.isfile(os.path.join(d, "pangea_io.cpp")):
                try:
                    _build(d, so)
                except (OSError, subprocess.SubprocessError):
                    return None
        if not os.path.exists(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.pangea_fastx_open.restype = ctypes.c_void_p
        lib.pangea_fastx_open.argtypes = [ctypes.c_char_p]
        lib.pangea_fastx_close.argtypes = [ctypes.c_void_p]
        lib.pangea_fastx_error.restype = ctypes.c_char_p
        lib.pangea_fastx_error.argtypes = [ctypes.c_void_p]
        lib.pangea_fastx_next_batch.restype = ctypes.c_long
        lib.pangea_fastx_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_long,
        ]
        lib.pangea_fastx_next_batch_packed.restype = ctypes.c_long
        lib.pangea_fastx_next_batch_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pangea_write_assignments.restype = ctypes.c_long
        lib.pangea_write_assignments.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeFastxReader:
    """Batched native reader: yields (ids, codes, lens, quals) with
    codes int8 [n, max_len] already padded (pad=4)."""

    def __init__(self, path: str, batch_size: int, max_len: int,
                 want_quals: bool = True):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        self._h = lib.pangea_fastx_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.path = path
        self.batch_size = batch_size
        self.max_len = max_len
        self.want_quals = want_quals

    def close(self):
        if self._h:
            self._lib.pangea_fastx_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def next_batch_raw(self):
        """Zero-Python-objects batch: returns (n, ids_raw: bytes
        [B*_ID_STRIDE], codes int8 [B,L], lens int32 [B], quals | None) or
        None at EOF. Rows ≥ n are uninitialized. lens carry the TRUE
        pre-truncation read lengths (may exceed max_len — rows hold the
        first max_len bases); callers clamp when slicing."""
        B, L = self.batch_size, self.max_len
        codes = np.empty((B, L), dtype=np.int8)
        lens = np.empty(B, dtype=np.int32)
        quals = np.empty((B, L), dtype=np.uint8) if self.want_quals else None
        ids = ctypes.create_string_buffer(B * _ID_STRIDE)
        qp = (quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
              if quals is not None else None)
        n = self._lib.pangea_fastx_next_batch(
            self._h, B, L,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qp, ids, _ID_STRIDE)
        if n < 0:
            err = self._lib.pangea_fastx_error(self._h).decode()
            raise ValueError(f"{self.path}: {err}")
        if n == 0:
            return None
        return n, ids.raw, codes, lens, quals

    def next_batch_packed(self):
        """Wire-format batch (pangea_io.cpp packed layout): returns
        (n, ids_raw: bytes, rows uint32 [B, W16+W32], lens int32 [B],
        quals uint8 [B, L] | None) or None at EOF. 2-bit codes + bad
        bitmask — 60 B per 150 bp read, ready to ship to the device as ONE
        array. lens are TRUE pre-truncation lengths (overlong reads:
        lens > max_len). quals (want_quals only) stay host-side for
        quality trimming — never shipped to the device."""
        B, L = self.batch_size, self.max_len
        stride = (L + 15) // 16 + (L + 31) // 32
        rows = np.empty((B, stride), dtype=np.uint32)
        lens = np.empty(B, dtype=np.int32)
        quals = np.empty((B, L), dtype=np.uint8) if self.want_quals else None
        ids = ctypes.create_string_buffer(B * _ID_STRIDE)
        n = self._lib.pangea_fastx_next_batch_packed(
            self._h, B, L,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ids, _ID_STRIDE,
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if quals is not None else None)
        if n < 0:
            err = self._lib.pangea_fastx_error(self._h).decode()
            raise ValueError(f"{self.path}: {err}")
        if n == 0:
            return None
        return n, ids.raw, rows, lens, quals

    def next_batch(self):
        """Returns (ids: list[str], codes int8 [n,L], lens int32 [n],
        quals uint8 [n,L] | None) or None at EOF."""
        b = self.next_batch_raw()
        if b is None:
            return None
        n, raw, codes, lens, quals = b
        id_list = [
            raw[i * _ID_STRIDE:(i + 1) * _ID_STRIDE].split(b"\0", 1)[0]
            .decode() for i in range(n)]
        return (id_list, codes[:n], lens[:n],
                quals[:n] if quals is not None else None)

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b


class _TaxBlobs:
    """Cached offset-blob encodings of a taxonomy's names/ranks for the
    native assignment writer."""

    def __init__(self, taxonomy):
        from ..taxonomy import RANK_NAMES
        names = [n.encode() for n in taxonomy.names]
        offs = np.zeros(len(names) + 1, dtype=np.int64)
        for i, n in enumerate(names):
            offs[i + 1] = offs[i] + len(n)
        self.names_blob = b"".join(names)
        self.name_off = offs
        ranks = [r.encode() for r in RANK_NAMES]
        roffs = np.zeros(len(ranks) + 1, dtype=np.int64)
        for i, r in enumerate(ranks):
            roffs[i + 1] = roffs[i] + len(r)
        self.rank_blob = b"".join(ranks)
        self.rank_off = roffs
        self.rank_code = np.ascontiguousarray(taxonomy.rank, dtype=np.int8)


_tax_blob_cache: dict = {}


def write_assignments_native(path: str, append: bool, ids_raw: bytes,
                             id_stride: int, n: int, taxon, best, nvalid,
                             taxonomy, strip_mate_suffix: bool = True,
                             do_fsync: bool = True) -> int:
    """Bulk-write n SEMANTICS.md §10.1 lines from device-output arrays and
    the reader's raw id buffer — no per-read Python objects. Returns the
    file offset after the write (durable when do_fsync). Byte-identical to
    report.writers.format_assignment."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native io library unavailable")
    key = id(taxonomy)
    blobs = _tax_blob_cache.get(key)
    if blobs is None:
        blobs = _tax_blob_cache[key] = _TaxBlobs(taxonomy)
    taxon = np.ascontiguousarray(taxon, dtype=np.int32)
    best = np.ascontiguousarray(best, dtype=np.int32)
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int32)
    off = lib.pangea_write_assignments(
        path.encode(), 1 if append else 0, n,
        ids_raw, id_stride, 1 if strip_mate_suffix else 0,
        taxon.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        blobs.rank_code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        blobs.names_blob,
        blobs.name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        blobs.rank_blob,
        blobs.rank_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if do_fsync else 0)
    if off < 0:
        raise OSError(f"native assignment write failed: {path}")
    return int(off)


def read_batches_native(path: str, batch_size: int, max_len: int,
                        mate_path: str | None = None,
                        sample: str | None = None):
    """Native-path equivalent of `fastx.read_batches`, yielding ReadBatch
    with the padded code matrix attached as ``batch.padded`` (and
    ``batch.mate_padded``) so the pipeline can skip pad_batch when the
    batch reaches the device unmodified."""
    from .fastx import ReadBatch, sniff_format

    r1 = NativeFastxReader(path, batch_size, max_len,
                           want_quals=sniff_format(path) == "fastq")
    r2 = (NativeFastxReader(mate_path, batch_size, max_len,
                            want_quals=sniff_format(mate_path) == "fastq")
          if mate_path else None)
    try:
        while True:
            b1 = r1.next_batch()
            if b1 is None:
                if r2 is not None and r2.next_batch() is not None:
                    raise ValueError(
                        f"{mate_path}: more records than {path}")
                return
            ids, codes, lens, quals = b1
            if r2 is not None:
                b2 = r2.next_batch()
                if b2 is None or len(b2[0]) != len(ids):
                    raise ValueError(
                        f"{mate_path}: fewer records than {path}")
                _, mcodes, mlens, mquals = b2
            ids = [i[:-2] if i.endswith(("/1", "/2")) else i for i in ids]
            n = len(ids)
            # lens are TRUE lengths; numpy slicing clips at max_len, so
            # seqs hold the (possibly truncated) stored bases. Exact
            # long-read classification uses the numpy reader instead
            # (pipeline gates on cfg.input.long_reads).
            batch = ReadBatch(
                ids=ids,
                seqs=[codes[i, :lens[i]].view(np.uint8) for i in range(n)],
                quals=([quals[i, :lens[i]] for i in range(n)]
                       if quals is not None else None),
                mate_seqs=([mcodes[i, :mlens[i]].view(np.uint8)
                            for i in range(n)] if r2 is not None else None),
                mate_quals=([mquals[i, :mlens[i]] for i in range(n)]
                            if (r2 is not None and mquals is not None)
                            else None),
                sample=sample,
            )
            batch.padded = codes
            batch.mate_padded = mcodes if r2 is not None else None
            yield batch
    finally:
        r1.close()
        if r2 is not None:
            r2.close()
