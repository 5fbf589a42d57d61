"""Durable on-disk state: checksummed atomic writes and fit checkpoints
(port of ``keystone_tpu/data/durable.py``, whole).

  - **Atomic metadata**: :func:`atomic_write_json` writes to a temp name
    in the same directory, fsyncs, then ``os.replace``\\ s — a reader
    either sees the old meta, no meta, or the complete new meta, never a
    torn one. Writers order *meta last*.
  - **Checksums**: CRC32C when a ``crc32c`` module is available, else
    zlib's CRC32; the algorithm used is recorded next to every digest,
    so readers verify with the writer's algorithm.
  - **Fit checkpoints**: :class:`CheckpointSpec` + save/load of a fit's
    carry (accumulators + segment cursor), bit-exact: arrays round-trip
    as raw bytes with a dtype/shape manifest, so a resumed fit folds the
    identical state the interrupted run held. Snapshot writes go through
    the data-plane runtime's ``checkpoint`` lane (``data/runtime.py``).
    Torch tensors are taken as their host copies (``maybe_save`` is the
    device sync).
  - **Content identity**: :func:`fingerprint_token` reads a tensor's
    shape, dtype and content CRC from a host copy, wherever the tensor
    lies: a CUDA tensor is copied to the host first (the reference's
    ``np.asarray`` of a device array cannot do that for a CUDA tensor,
    and would degrade it to its type name, so two plans differing only
    in weights would share a fingerprint). bfloat16, which numpy lacks,
    is hashed through its 16-bit pattern and named ``bfloat16``, as the
    reference names an ``ml_dtypes`` array. :func:`source_fingerprint`
    names a segment source's shard directory and digests its recorded
    per-tile checksums, the identity a resumable disk fit keys on.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.utils import faults

__all__ = [
    "CheckpointSpec",
    "ShardCorrupted",
    "atomic_write_json",
    "checksum_algo",
    "corrupted",
    "crc_of_array",
    "fingerprint_token",
    "fsync_file",
    "resolve_checkpoint",
    "source_fingerprint",
    "verify_array",
]


class ShardCorrupted(RuntimeError):
    """On-disk bytes failed checksum verification (torn write, bit flip,
    or injected corruption). Deliberately NOT an OSError: corruption is
    persistent state — the retry layer must never spin on it, and no
    caller may silently fold the data. Raise through :func:`corrupted`
    so the postmortem flight record rides the log beside it."""


def corrupted(message: str) -> ShardCorrupted:
    """Build a :class:`ShardCorrupted` to raise, dumping the obs flight
    record beside it (the postmortem block naming the recent spans and
    the ones in flight)."""
    obs.flight.dump_flight_record("ShardCorrupted: " + message)
    return ShardCorrupted(message)


try:  # pragma: no cover - depends on the optional wheel
    import crc32c as _crc32c_mod

    def _crc(data, value: int = 0) -> int:
        return _crc32c_mod.crc32c(data, value)

    _ALGO = "crc32c"
except ImportError:
    def _crc(data, value: int = 0) -> int:
        return zlib.crc32(data, value) & 0xFFFFFFFF

    _ALGO = "crc32"


def checksum_algo() -> str:
    """The digest algorithm this process WRITES ("crc32c" when the
    optional module exists, else "crc32"). Readers always verify with
    the algorithm recorded in the metadata being read."""
    return _ALGO


def _crc_named(algo: str):
    if algo == _ALGO:
        return _crc
    if algo == "crc32":
        return lambda data, value=0: zlib.crc32(data, value) & 0xFFFFFFFF
    if algo == "crc32c":
        raise corrupted(
            "metadata was written with crc32c but no crc32c module is "
            "available to verify it"
        )
    raise corrupted(f"unknown checksum algorithm {algo!r}")


def crc_of_array(arr: np.ndarray, algo: Optional[str] = None) -> int:
    """Digest of an array's raw bytes (C-order copy if needed)."""
    fn = _crc if algo is None else _crc_named(algo)
    return fn(np.ascontiguousarray(arr).view(np.uint8).reshape(-1).data)


def verify_array(
    arr: np.ndarray, expected: int, algo: str, what: str
) -> None:
    got = crc_of_array(arr, algo)
    if got != int(expected):
        raise corrupted(
            f"{what}: checksum mismatch ({algo} {got:#010x} != recorded "
            f"{int(expected):#010x}) — torn write or bit corruption; "
            f"re-ingest the shard directory"
        )


def _host_copy(a) -> np.ndarray:
    """A checkpoint array's host form: numpy as it is, a tensor's host
    copy (the device sync of a CUDA tensor)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise TypeError("checkpoint arrays cannot be bfloat16 (numpy has no such dtype)")
        return t.numpy()
    return np.asarray(a)


def fsync_file(path: str) -> None:
    """Flush a file's contents to stable storage (best-effort on
    filesystems that reject fsync, e.g. some overlayfs tmp mounts)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - fs-dependent
        pass


def atomic_write_json(path: str, obj: Any) -> None:
    """Write JSON so ``path`` is either absent, the old content, or the
    complete new content — never torn. Temp file in the same directory
    (os.replace must not cross filesystems), fsync'd before the rename,
    directory fsync'd after so the rename itself is durable."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.", dir=directory
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:  # pragma: no cover - fs-dependent
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Fit checkpoints
# ---------------------------------------------------------------------------

_CKPT_META = "checkpoint.json"
_CKPT_DATA = "carry.bin"


class CheckpointSpec:
    """Where and how often a streamed fit snapshots its fold carry.

    ``directory`` holds at most one checkpoint PER FIT: snapshots are
    namespaced by a digest of the fit's fingerprint (``fit-<digest>/``
    subdirectories), so one global ``--checkpoint-dir`` serves a
    pipeline with several segmented streamed fits — fit A's snapshots
    and clears never clobber fit B's. Within a fit only the latest
    snapshot is kept (the carry is cumulative, so older snapshots are
    strictly dominated). ``every_segments`` is the snapshot cadence K.
    Snapshot cost is one device→host sync of the carry plus an atomic
    file write, so the steady-state overhead is ~(carry_bytes /
    disk_rate) per K segments.

    A checkpoint records a caller-built *fingerprint* (fit kind, segment
    count, featurizer identity + parameter digests, source identity);
    :meth:`load` returns None when the fingerprint does not match, so a
    stale checkpoint from a different fit — including the same geometry
    under a different feature bank or a re-ingested shard directory —
    can never leak its accumulators into this one. (Resident operands
    are fingerprinted by shape/dtype only: digesting gigabytes of live
    arrays per snapshot would dwarf the snapshot itself; disk sources
    are covered through their recorded per-tile checksums.)

    **Write-behind:** snapshot writes go through the data-plane
    runtime's ``checkpoint`` lane (:mod:`keystone_tpu_torch.data.runtime`)
    by default, so :meth:`maybe_save` blocks the fold only for the
    device→host carry transfer plus queue-submit time, not for the
    fsync. Durability is unchanged: :meth:`save` is atomic and versioned
    either way, so a kill DURING an in-flight async write leaves the
    previous complete snapshot resumable. Ordering is structural
    (the lane is FIFO), every read-side entry point (:meth:`load` /
    :meth:`restore` / :meth:`has_snapshot` / :meth:`clear`) flushes
    pending writes first, and an async write failure surfaces LOUDLY at
    the next :meth:`maybe_save` or :meth:`flush` — a fit never
    completes thinking it was insured when it was not. ``runtime=False``
    (or ``KEYSTONE_CHECKPOINT_SYNC=1``) restores synchronous writes.
    """

    def __init__(self, directory: str, every_segments: int = 8,
                 runtime=None):
        if every_segments < 1:
            raise ValueError(
                f"every_segments must be >= 1, got {every_segments}"
            )
        self.directory = str(directory)
        self.every_segments = int(every_segments)
        # None -> the shared data-plane runtime (write-behind, the
        # default); False -> synchronous writes; or an explicit
        # DataPlaneRuntime.
        self._runtime = runtime
        self._pending: List[Any] = []  # outstanding write futures (FIFO)

    def _rt(self):
        if self._runtime is False:
            return None
        if os.environ.get("KEYSTONE_CHECKPOINT_SYNC", "").strip() in (
            "1", "true", "on"
        ):
            return None
        if self._runtime is None:
            from keystone_tpu_torch.data.runtime import default_runtime

            return default_runtime()
        return self._runtime

    # -- write-behind plumbing --------------------------------------------

    def flush(self, timeout: float = 120.0,
              raise_errors: bool = True) -> None:
        """Wait for every pending snapshot write and re-raise the first
        failure — the loud-surface point of the write-behind contract.
        Every read-side entry point calls this first, so observers never
        race an in-flight write in the same process. ``raise_errors=
        False`` (the post-completion :meth:`clear` path, where the
        snapshot is about to be deleted anyway) demotes failures to a
        warning instead of destroying a fit that already finished."""
        futs, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for i, fut in enumerate(futs):
            try:
                fut.result(timeout=timeout)
            except FutureTimeoutError as e:
                # The write is STILL RUNNING — dropping its future here
                # would let a later clear() delete the fit dir and the
                # stalled write resurrect a stale snapshot afterwards.
                # Keep it (and everything behind it on the FIFO lane)
                # pending and fail loudly regardless of raise_errors:
                # "flushed" must mean "no write in flight".
                self._pending = futs[i:] + self._pending
                if first is not None:
                    # An earlier write already FAILED and was consumed
                    # from pending above; swallowing it under the
                    # timeout would let a later flush succeed and the
                    # fit complete uninsured. The failure outranks the
                    # still-running write.
                    raise first from e
                raise
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first is None:
                    first = e
        if first is not None:
            if raise_errors:
                raise first
            import logging

            logging.getLogger("keystone_tpu_torch.durable").warning(
                "async checkpoint write failed (fit already complete; "
                "snapshot being cleared): %s", first,
            )

    def _surface_pending_failure(self) -> None:
        """Raise a COMPLETED pending write's failure without blocking on
        ones still in flight (the per-maybe_save check: a dead
        checkpoint disk fails the fit at the next snapshot boundary,
        not at the end). Unfinished futures are retained — their
        outcome surfaces at the next boundary or at flush. A surfaced
        failure is CONSUMED (raised once, here) — re-raising the same
        dead write at every later flush would mask the recovery path."""
        still = []
        first: Optional[BaseException] = None
        for fut in self._pending:
            if not fut.done():
                still.append(fut)
                continue
            exc = fut.exception()
            if exc is not None and first is None:
                first = exc
        self._pending = still
        if first is not None:
            raise first

    def _fit_dir(self, fingerprint: Dict[str, Any]) -> str:
        """The fingerprint-digest subdirectory this fit's snapshot lives
        in — the namespacing that lets several fits share one
        ``--checkpoint-dir`` without clobbering each other."""
        canonical = json.dumps(fingerprint, sort_keys=True).encode()
        return os.path.join(self.directory, f"fit-{_crc(canonical):08x}")

    # -- save --------------------------------------------------------------

    def save(
        self,
        arrays: Sequence[np.ndarray],
        cursor: int,
        fingerprint: Dict[str, Any],
    ) -> None:
        """Atomically snapshot (arrays, cursor). The data file is
        VERSIONED per cursor (``carry-<cursor>.bin``) and the meta —
        written last, atomically — names the file it describes: a kill
        at ANY point (including between the data write and the meta
        write, where a fixed data name would pair old meta with new
        bytes) leaves either the previous complete checkpoint or the
        new one, never a meta describing the wrong data. Superseded
        data files are deleted only after the new meta is durable."""
        # The chaos hook: fires once per snapshot write attempt — on the
        # write-behind worker for async specs, inline for sync ones.
        faults.maybe_fail(faults.SITE_CHECKPOINT_WRITE)
        fit_dir = self._fit_dir(fingerprint)
        os.makedirs(fit_dir, exist_ok=True)
        arrays = [_host_copy(a) for a in arrays]
        manifest: List[Dict[str, Any]] = []
        offset = 0
        data_name = f"carry-{int(cursor)}.bin"
        data_path = os.path.join(fit_dir, data_name)
        fd, tmp = tempfile.mkstemp(prefix=data_name + ".tmp.",
                                   dir=fit_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                for i, a in enumerate(arrays):
                    raw = np.ascontiguousarray(a).tobytes()
                    f.write(raw)
                    manifest.append({
                        "index": i,
                        "dtype": str(a.dtype),
                        "shape": list(a.shape),
                        "offset": offset,
                        "nbytes": len(raw),
                        "crc": _crc(raw),
                    })
                    offset += len(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, data_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        atomic_write_json(
            os.path.join(fit_dir, _CKPT_META),
            {
                "cursor": int(cursor),
                "algo": _ALGO,
                "data": data_name,
                "fingerprint": fingerprint,
                "arrays": manifest,
            },
        )
        # The new meta is durable: earlier snapshots' data files are now
        # unreachable — reclaim them.
        for name in self._data_files(fit_dir):
            if name != data_name:
                try:
                    os.unlink(os.path.join(fit_dir, name))
                except OSError:
                    pass

    @staticmethod
    def _data_files(fit_dir: str) -> List[str]:
        try:
            entries = os.listdir(fit_dir)
        except OSError:
            return []
        return [
            e for e in entries
            if (e == _CKPT_DATA
                or (e.startswith("carry-") and e.endswith(".bin")))
        ]

    # -- load --------------------------------------------------------------

    def load(
        self, fingerprint: Dict[str, Any]
    ) -> Optional[Tuple[List[np.ndarray], int]]:
        """(carry arrays, next segment cursor) from the latest snapshot,
        or None when no checkpoint exists or its fingerprint belongs to
        a different fit (the namespaced directory makes a mismatch a
        digest collision — still checked). Corrupt data raises
        :class:`ShardCorrupted` — a bad checkpoint must never silently
        seed a fresh-looking fit."""
        self.flush()
        fit_dir = self._fit_dir(fingerprint)
        meta_path = os.path.join(fit_dir, _CKPT_META)
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("fingerprint") != fingerprint:
            return None
        crc_fn = _crc_named(meta.get("algo", "crc32"))
        arrays: List[np.ndarray] = []
        data_name = meta.get("data", _CKPT_DATA)  # legacy fixed name
        with open(os.path.join(fit_dir, data_name), "rb") as f:
            blob = f.read()
        for ent in meta["arrays"]:
            raw = blob[ent["offset"]: ent["offset"] + ent["nbytes"]]
            if len(raw) != ent["nbytes"] or crc_fn(raw) != ent["crc"]:
                raise corrupted(
                    f"checkpoint array {ent['index']} in "
                    f"{fit_dir}: checksum mismatch — discard the "
                    f"checkpoint directory and restart the fit"
                )
            arrays.append(
                np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
                .reshape(ent["shape"])
            )
        return arrays, int(meta["cursor"])

    def restore(
        self, fingerprint: Dict[str, Any]
    ) -> Tuple[Optional[List[np.ndarray]], int]:
        """(carry arrays, start segment) — (None, 0) when there is
        nothing (matching) to resume from. The shared entry point of
        both streamed solvers, so resume semantics cannot drift apart."""
        loaded = self.load(fingerprint)
        if loaded is None:
            return None, 0
        return loaded

    def maybe_save(
        self,
        arrays: Sequence[Any],
        segment: int,
        num_segments: int,
        fingerprint: Dict[str, Any],
        stats=None,
    ) -> bool:
        """Shared snapshot cadence of the streamed solvers: after
        ``segment``, snapshot when the every-K boundary hits and it is
        not the final segment (a completed fit clears instead of
        snapshotting). The host copy here is the device sync — the
        snapshot captures exactly the post-segment carry a resumed run
        restores, and it MUST run on the calling thread, before the
        next fold updates the carry in place. The disk write itself is
        write-behind (class docstring) — the fold blocks for
        sync + queue-submit only. Returns whether a snapshot was
        written (submitted, for async specs).

        ``stats``: optional sink with ``add_busy`` / ``add_wait`` — the
        write's wall lands in its ``checkpoint`` busy seconds
        (worker-side for async specs) and the fold-blocking share in its
        ``checkpoint`` wait seconds."""
        if (
            (segment + 1) % self.every_segments != 0
            or (segment + 1) >= num_segments
        ):
            return False
        t0 = time.perf_counter()
        host = [_host_copy(a) for a in arrays]
        rt = self._rt()
        if rt is None:
            with obs.span("checkpoint.write", cursor=segment + 1,
                          sync=True):
                self.save(host, segment + 1, fingerprint)
            dt = time.perf_counter() - t0
            if stats is not None and hasattr(stats, "add_busy"):
                stats.add_busy("checkpoint", dt)
                stats.add_wait("checkpoint", dt)  # inline = fully waited
            return True
        # The host form of a CPU tensor (or a numpy carry) is a
        # ZERO-COPY view of memory the fold keeps updating in place — by
        # the time the checkpoint worker serializes, the next segment may
        # have changed it, producing a self-consistent (checksummed at
        # write time!) but WRONG snapshot. The async path must own its
        # bytes before the fold is allowed to continue — but only copy
        # when it doesn't already (a CUDA tensor's host copy is owned).
        # (`h is a` catches raw numpy input, returned as the caller's
        # own — mutable — array.)
        host = [
            h if (h is not a and h.flags.owndata)
            else np.array(h, copy=True)
            for h, a in zip(host, arrays)
        ]
        # A previously-submitted write that already failed must stop the
        # fit HERE — snapshotting onto a dead disk forever, silently,
        # is the one thing the insurance layer must never do.
        self._surface_pending_failure()
        with obs.span("checkpoint.submit", cursor=segment + 1):
            self._pending.append(rt.submit(
                "checkpoint", self._write_snapshot,
                host, segment + 1, fingerprint, stats,
            ))
        if stats is not None and hasattr(stats, "add_wait"):
            stats.add_wait("checkpoint", time.perf_counter() - t0)
        return True

    def _write_snapshot(self, host_arrays, cursor, fingerprint, stats):
        """The write-behind task body (runs on the runtime's
        ``checkpoint`` worker): pure host IO — the arrays were already
        device-synced by maybe_save on the owner thread. The span covers
        exactly the region the busy counter covers (the
        trace-correctness contract)."""
        t0 = time.perf_counter()
        with obs.span("checkpoint.write", cursor=cursor, sync=False):
            self.save(host_arrays, cursor, fingerprint)
        if stats is not None and hasattr(stats, "add_busy"):
            stats.add_busy("checkpoint", time.perf_counter() - t0)

    def has_snapshot(
        self, fingerprint: Optional[Dict[str, Any]] = None
    ) -> bool:
        """Whether a snapshot exists — for ``fingerprint``'s fit, or for
        ANY fit in the directory when None (the drill/test probe)."""
        self.flush()
        if fingerprint is not None:
            return os.path.exists(
                os.path.join(self._fit_dir(fingerprint), _CKPT_META)
            )
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return False
        return any(
            os.path.exists(os.path.join(self.directory, e, _CKPT_META))
            for e in entries if e.startswith("fit-")
        )

    def clear(self, fingerprint: Optional[Dict[str, Any]] = None) -> None:
        """Remove ``fingerprint``'s snapshot (called after a successful
        fit so a later fit with the same fingerprint starts fresh) —
        ONLY that fit's: other fits sharing the directory keep theirs.
        With no fingerprint, every fit's snapshot is removed. Pending
        write-behind snapshots are flushed first — a queued write must
        not resurrect a snapshot after the clear."""
        self.flush(raise_errors=False)
        if fingerprint is not None:
            dirs = [self._fit_dir(fingerprint)]
        else:
            try:
                dirs = [
                    os.path.join(self.directory, e)
                    for e in os.listdir(self.directory)
                    if e.startswith("fit-")
                ]
            except OSError:
                dirs = []
        for d in dirs:
            for name in [_CKPT_META] + self._data_files(d):
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass
            try:
                os.rmdir(d)
            except OSError:
                pass


def _host_array(x: torch.Tensor):
    """(numpy array of the tensor's bits, dtype name): a host copy, bf16
    through its 16-bit pattern."""
    t = x.detach()
    if t.is_meta:
        raise TypeError("a meta tensor has no content")
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def fingerprint_token(x: Any) -> Any:
    """A JSON-safe, address-free identity token for fingerprint fields:
    scalars pass through, sequences tokenize elementwise, callables
    become ``module.qualname`` (``repr`` would embed a memory address
    and never match across processes), arrays and tensors become a
    shape/dtype/content-CRC triple (a tensor's from its host copy), and
    anything else degrades to its type name."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [fingerprint_token(v) for v in x]
    if isinstance(x, torch.Tensor):
        try:
            arr, dtype = _host_array(x)
        except Exception:
            return type(x).__name__
        return {"shape": list(arr.shape), "dtype": dtype, "crc": int(crc_of_array(arr))}
    if callable(x):
        mod = getattr(x, "__module__", "?")
        qn = getattr(x, "__qualname__", type(x).__name__)
        return f"{mod}.{qn}"
    try:
        arr = np.asarray(x)
        if arr.dtype == object:
            return type(x).__name__
        return {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": int(crc_of_array(arr)),
        }
    except Exception:
        return type(x).__name__


def _shards_behind(obj: Any, depth: int = 0):
    """The Disk*Shards object a segment source is a view over, through
    any of the documented source forms: the shards object itself, a
    ShardSource wrapper (``.shards``), a field view (``.paired``), or a
    bound method like ``shards.segment_source`` (``__self__``, the
    callable form the solvers also accept)."""
    if obj is None or depth > 4:
        return None
    if hasattr(obj, "_checksums") and hasattr(obj, "directory"):
        return obj
    for attr in ("shards", "paired", "__self__"):
        found = _shards_behind(getattr(obj, attr, None), depth + 1)
        if found is not None:
            return found
    return None


def source_fingerprint(source: Any) -> Optional[Dict[str, Any]]:
    """Identity of a segment source's backing data, for checkpoint
    fingerprints: the shard directory plus a digest of its recorded
    per-tile checksums. The CRCs were computed at write time, so the
    content identity costs nothing, and a re-ingested directory with
    different rows of the same geometry never matches a stale snapshot.
    None for sources with no disk shards behind them."""
    shards = _shards_behind(source)
    if shards is None:
        return None
    sums = getattr(shards, "_checksums", None)
    return {
        "directory": getattr(shards, "directory", None),
        "checksums_crc": (
            None if sums is None
            else int(_crc(repr(sorted(sums.items())).encode()))
        ),
    }


def resolve_checkpoint(checkpoint) -> Optional[CheckpointSpec]:
    """Normalize a streamed fit's ``checkpoint`` argument: a
    CheckpointSpec passes through, a string becomes a spec at the
    default cadence, and None consults ``KEYSTONE_CHECKPOINT_DIR`` (the
    ``run.py --checkpoint-dir`` wiring) — unset means no checkpointing,
    exactly the pre-reliability behavior."""
    if checkpoint is None:
        env = os.environ.get("KEYSTONE_CHECKPOINT_DIR", "").strip()
        if not env:
            return None
        every = int(os.environ.get("KEYSTONE_CHECKPOINT_EVERY", "8"))
        return CheckpointSpec(env, every_segments=every)
    if isinstance(checkpoint, str):
        return CheckpointSpec(checkpoint)
    return checkpoint
