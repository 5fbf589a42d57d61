"""Native host-side data plane: CSV parsing, PNM decoding and record
splitting in C++ (port of ``keystone_tpu/native/__init__.py``; the
analog of the reference's src/main/cpp tier, loaded there through
System.loadLibrary, utils/external/VLFeat.scala:4), and a row-stable
float32 product on the host (``row_stable.cpp``, which the port adds):
fused multiply-add chains in fixed chunks of the reduction index, the
order the card's kernels sum in, which the CPU forms of
``cuda_ops.row_stable_matmul_ref`` and of the cosine plain version's
pre-activation take.

The C++ sources beside this file are compiled with ``g++`` at first use
into ``build/keystone_tpu_torch/libkeystone_native-<digest>.so`` (the
digest hashes the sources and flags, so an edit never loads a stale
library) and bound through ``ctypes``.

Difference from the reference: where the library will not build, the
reference falls back to Python parsing; the port raises with the
compiler's message, as its CUDA kernels do. The Python forms stay as the
plain versions the tests hold the library against
(:func:`parse_csv_floats_ref`, :func:`decode_pnm_ref`,
:func:`split_records_ref`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR.parent.parent / "build" / "keystone_tpu_torch"
_SOURCES = [_DIR / "csv_loader.cpp", _DIR / "data_plane.cpp", _DIR / "row_stable.cpp"]
# No fused multiply-add: the row-stable product rounds every product and sum.
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_c_long_p = ctypes.POINTER(ctypes.c_long)


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _SOURCES) + " ".join(_FLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD / f"libkeystone_native-{digest}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises with the compiler's output when ``g++`` fails."""
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(p) for p in _SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native data plane: cannot run g++ ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"native data plane: g++ failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.ks_parse_csv.restype = ctypes.c_long
        lib.ks_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, _c_long_p, _c_long_p,
        ]
        lib.ks_split_records.restype = None
        lib.ks_split_records.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ks_parse_csv_many.restype = None
        lib.ks_parse_csv_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _c_long_p, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)), _c_long_p,
            _c_long_p, _c_long_p, _c_long_p,
        ]
        lib.ks_decode_pnm_many.restype = None
        lib.ks_decode_pnm_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _c_long_p, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), _c_long_p,
            _c_long_p, _c_long_p, _c_long_p, _c_long_p,
        ]
        lib.ks_matmul_fma_chain_f32.restype = None
        lib.ks_matmul_fma_chain_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        lib.ks_decode_pnm.restype = ctypes.c_int
        lib.ks_decode_pnm.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, _c_long_p, _c_long_p, _c_long_p,
        ]
        _lib = lib
        return lib


def _csv_max_vals(text: bytes) -> int:
    """Upper bound on the value count of a CSV buffer: every value is
    preceded by a separator (CR included, which the parser skips) or
    starts the buffer."""
    return (
        text.count(b",") + text.count(b"\n") + text.count(b" ")
        + text.count(b"\t") + text.count(b"\r") + 2
    )


def _f64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_csv_floats(text: bytes) -> Tuple[np.ndarray, int, int]:
    """Parse a CSV byte buffer into (flat float64 values, number of
    columns, number of rows). Callers check values.size == rows · columns
    to reject ragged input."""
    lib = get_lib()
    max_vals = _csv_max_vals(text)
    out = np.empty(max_vals, dtype=np.float64)
    ncols, nrows = ctypes.c_long(0), ctypes.c_long(0)
    n = lib.ks_parse_csv(text, len(text), _f64_ptr(out), max_vals,
                         ctypes.byref(ncols), ctypes.byref(nrows))
    return out[:n].copy(), int(ncols.value), int(nrows.value)


def parse_csv_floats_ref(text: bytes) -> Tuple[np.ndarray, int, int]:
    """Plain Python version of :func:`parse_csv_floats` (the reference's
    fallback parser) for well-formed numeric CSV."""
    rows = [r for r in text.decode("utf-8", "ignore").splitlines() if r.strip()]
    vals: List[float] = []
    ncols = 0
    for r in rows:
        parts = [p for p in r.replace(",", " ").split() if p]
        if not ncols:
            ncols = len(parts)
        vals.extend(float(p) for p in parts)
    return np.asarray(vals, dtype=np.float64), ncols, len(rows)


def parse_csv_floats_many(texts) -> list:
    """Parse many CSV byte buffers concurrently in the native thread pool:
    a list of (flat values, number of columns, number of rows)."""
    lib = get_lib()
    n = len(texts)
    if n == 0:
        return []
    bufs = (ctypes.c_char_p * n)(*texts)
    lens = (ctypes.c_long * n)(*[len(t) for t in texts])
    max_vals_list = [_csv_max_vals(t) for t in texts]
    outs_np = [np.empty(m, dtype=np.float64) for m in max_vals_list]
    outs = (ctypes.POINTER(ctypes.c_double) * n)(*[_f64_ptr(o) for o in outs_np])
    max_vals = (ctypes.c_long * n)(*max_vals_list)
    counts, ncols, nrows = ((ctypes.c_long * n)() for _ in range(3))
    lib.ks_parse_csv_many(bufs, lens, n, outs, max_vals, counts, ncols, nrows)
    return [
        (outs_np[i][: counts[i]].copy(), int(ncols[i]), int(nrows[i]))
        for i in range(n)
    ]


def decode_pnm(data: bytes) -> Optional[np.ndarray]:
    """Decode binary PPM (P6) / PGM (P5) bytes to a float32 (x, y, c)
    array; None when the bytes do not decode (16-bit samples included)."""
    lib = get_lib()
    max_vals = len(data) * 3
    out = np.empty(max_vals, dtype=np.float32)
    x, y, c = ctypes.c_long(0), ctypes.c_long(0), ctypes.c_long(0)
    rc = lib.ks_decode_pnm(data, len(data), _f32_ptr(out), max_vals,
                           ctypes.byref(x), ctypes.byref(y), ctypes.byref(c))
    if rc != 0:
        return None
    count = x.value * y.value * c.value
    return out[:count].copy().reshape(x.value, y.value, c.value)


def decode_pnm_ref(data: bytes) -> Optional[np.ndarray]:
    """Plain Python version of :func:`decode_pnm`: the same header grammar
    (whitespace, ``#`` comments, one whitespace byte after maxval) and
    the same float32 rescale to [0, 255]."""
    if len(data) < 2 or data[0:1] != b"P" or data[1:2] not in (b"5", b"6"):
        return None
    channels = 3 if data[1:2] == b"6" else 1
    pos, vals = 2, []
    while len(vals) < 3 and pos < len(data):
        while pos < len(data) and (chr(data[pos]).isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(data) and chr(data[pos]).isdigit():
            pos += 1
        if pos == start:
            return None
        vals.append(int(data[start:pos]))
    if len(vals) < 3 or pos >= len(data):
        return None
    pos += 1
    w, h, maxval = vals
    if maxval <= 0 or maxval > 255:
        return None
    count = h * w * channels
    if pos + count > len(data):
        return None
    scale = np.float32(255.0) / np.float32(maxval)
    px = np.frombuffer(data, dtype=np.uint8, count=count, offset=pos).astype(np.float32)
    return (px * scale).reshape(h, w, channels)


def decode_pnm_many(datas) -> list:
    """Decode many binary PNM buffers concurrently in the native thread
    pool: a list of float32 (x, y, c) arrays, None for each that did not
    decode."""
    lib = get_lib()
    n = len(datas)
    if n == 0:
        return []
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_long * n)(*[len(d) for d in datas])
    max_vals_list = [len(d) * 3 for d in datas]
    outs_np = [np.empty(m, dtype=np.float32) for m in max_vals_list]
    outs = (ctypes.POINTER(ctypes.c_float) * n)(*[_f32_ptr(o) for o in outs_np])
    max_vals = (ctypes.c_long * n)(*max_vals_list)
    xs, ys, cs, rcs = ((ctypes.c_long * n)() for _ in range(4))
    lib.ks_decode_pnm_many(bufs, lens, n, outs, max_vals, xs, ys, cs, rcs)
    results = []
    for i in range(n):
        if rcs[i] != 0:
            results.append(None)
            continue
        count = xs[i] * ys[i] * cs[i]
        results.append(outs_np[i][:count].copy().reshape(xs[i], ys[i], cs[i]))
    return results


def split_records(
    buf: bytes,
    label_bytes: int,
    channels: int,
    height: int,
    width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deinterleave CIFAR-style fixed records [label_bytes | planar pixels]
    into (int64 labels, float32 HWC images) in a threaded native loop. The
    last label byte is used (CIFAR-10's only byte; CIFAR-100's fine
    label)."""
    if label_bytes < 1:
        raise ValueError("label_bytes must be >= 1")
    img_bytes = channels * height * width
    rec = label_bytes + img_bytes
    if len(buf) % rec != 0:
        raise ValueError(f"buffer not a multiple of record size {rec}")
    lib = get_lib()
    n = len(buf) // rec
    labels = np.empty(n, dtype=np.int64)
    images = np.empty((n, height, width, channels), dtype=np.float32)
    lib.ks_split_records(
        buf, n, label_bytes, channels, height, width,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _f32_ptr(images),
    )
    return labels, images


def split_records_ref(buf: bytes, label_bytes: int, channels: int, height: int,
                      width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of :func:`split_records` (the reference's
    numpy CIFAR path)."""
    rec = label_bytes + channels * height * width
    records = np.frombuffer(buf, dtype=np.uint8).reshape(-1, rec)
    labels = records[:, label_bytes - 1].astype(np.int64)
    images = (
        records[:, label_bytes:].reshape(-1, channels, height, width)
        .transpose(0, 2, 3, 1).astype(np.float32)
    )
    return labels, images


def _threads_for(macs: int, threads: int) -> int:
    """Threads for a product of ``macs`` multiply-adds: one for each 2^20
    of them, at most ``threads`` (a small product pays no thread start)."""
    return max(1, min(int(threads), macs >> 20))


def matmul_fma_chain_f32(X, W, chunk: int, threads: int):
    """out = X @ W for float32 CPU tensors X (m, k) and W (k, n) with rows
    of unit stride: each output one fused multiply-add chain in index order
    over each ``chunk`` reduction indices, the chunk sums added in order
    (one chain when ``chunk >= k``), on up to ``threads`` threads; a row's
    bits depend on that row and W alone."""
    import torch

    m, k = X.shape
    n = W.shape[1]
    out = torch.empty((m, n), dtype=torch.float32)
    get_lib().ks_matmul_fma_chain_f32(
        X.data_ptr(), m, k, X.stride(0), W.data_ptr(), n, W.stride(0), out.data_ptr(),
        out.stride(0), chunk, _threads_for(m * k * n, threads),
    )
    return out
