"""Device mesh management: the substrate that replaces the Spark cluster.

Port of ``keystone_tpu/parallel/mesh.py``, one host. The reference's
substrate is a ``jax.sharding.Mesh`` over TPU chips (or forced-CPU devices
in tests) driven by one Python program; here a :class:`Mesh` names its
axes over a grid of ``torch.device`` objects, and the one program drives
every shard in turn (a single controller, as JAX is on one host). Axis
conventions:

  - ``data``  — examples (rows). The analog of RDD row-partitioning.
  - ``model`` — features/columns. The analog of VectorSplitter feature blocks
    (reference: nodes/util/VectorSplitter.scala:10-36).

A device may appear more than once, the way XLA's
``--xla_force_host_platform_device_count`` splits one CPU into devices:
tests build 8 shards on the CPU, and one card holds 8 shards on
``cuda:0``.

A row-sharded tensor (:class:`ShardedRows`) is one tensor a shard, in shard
order, each on its device, zero-padded past the true row count to a
multiple of the axis (:func:`pad_rows`). :func:`shard_map` runs a body once
a shard; its one collective is a ``psum`` at a body's end: the port adds
the shards' partials in shard order on the axis's first device
(:func:`psum`), so a mesh fit gives the same bits from run to run.
Partials of other devices reach it by peer copies (``Tensor.to``), not
``torch.cuda.comm.reduce_add``, whose summation order is NCCL's and not
fixed.

A single controller cannot hand a shard to its neighbour in the middle of
a body, so the ring tier (``parallel/ring.py``) runs a ring as a loop at
the controller's level: P steps, each one pass over the shards followed by
one rotation. Its collectives act on lists of per-shard tensors, each in a
fixed order: :func:`ppermute` (a rotation, a peer copy to the
destination's device, no copy where both shards share one),
:func:`all_gather` (tiled, in shard order, made once a distinct device)
and :func:`psum_scatter` (the partials summed in shard order, stripe j
handed to shard j).

The multi-process form (the reference's ``init_distributed`` and
``make_hybrid_mesh``'s DCN axes) composes on top of this one: each process
joins one ``torch.distributed`` group (:func:`init_distributed`: NCCL where
each rank owns its card, gloo for CPU processes and for several ranks on
one card), and :func:`make_hybrid_mesh` lays the DCN axes across the
processes and the ICI axes over each process's local devices (the
reference's ``process_is_granule`` layout). A :class:`Mesh` then records
which process owns each entry of its grid; a :class:`ShardedRows` holds
only its own process's shards with their global indices; each process runs
bodies and kernels on its local shards. The collectives keep their
contract across processes: every shard's partial is all-gathered over the
group (never pre-summed a process, never an ``all_reduce``, whose order is
the backend's) and added in global shard order, so two processes of four
shards give the one-process eight-shard mesh's bits. On gloo, CUDA tensors
go through host memory explicitly; on NCCL they go as they are.
:func:`ppermute` sends and receives point to point, every rank posting its
operations in the permutation's order. :meth:`ShardedRows.gather` refuses
a multi-process array (read it with :func:`process_allgather`), as JAX
refuses to read an array that is not addressable.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_default_mesh: Optional["Mesh"] = None


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s role).

    ``devices``: an array of ``torch.device`` whose shape is the mesh's;
    ``shape`` maps each axis name to its size, in order. ``owners``: the
    process rank owning each entry (a multi-process mesh,
    :func:`make_hybrid_mesh`); None for a mesh of this process alone. An
    entry another process owns names that process's device of the same
    local position."""

    def __init__(self, devices, axis_names: Sequence[str], owners=None):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {grid.shape} needs {grid.ndim} axis names, got "
                f"{tuple(axis_names)}"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.owners = None if owners is None else np.asarray(owners, dtype=np.int64).reshape(
            grid.shape)
        self.process_index = _process_rank() if owners is not None else 0
        self._groups: Dict[object, Optional["ShardGroup"]] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_multi_process(self) -> bool:
        return self.owners is not None and len(set(self.owners.flat)) > 1

    def _line(self, grid, axis) -> list:
        """``grid``'s entries along ``axis`` (a name, or a tuple of names
        flattened first major), every other axis at index 0."""
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if len(axes) == 1 and axes[0] not in self.shape:
            return [grid.flat[0]]
        pos = [self.axis_names.index(a) for a in axes]
        out = []
        for flat in np.ndindex(*[self.shape[a] for a in axes]):
            index = [0] * self.devices.ndim
            for p, i in zip(pos, flat):
                index[p] = i
            out.append(grid[tuple(index)])
        return out

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        that axis's shards live."""
        return self._line(self.devices, axis)

    def flat_devices(self, axes: Sequence[str]) -> List[torch.device]:
        """The devices of the row shards over ``axes`` flattened, the first
        axis major (the reference's ``P((data, model))`` row split); axes
        not named keep index 0."""
        return self._line(self.devices, tuple(axes))

    def axis_owners(self, axis) -> List[int]:
        """The process owning each shard along ``axis`` (a name or a tuple
        of names, as :meth:`axis_devices` / :meth:`flat_devices`)."""
        if self.owners is None:
            return [self.process_index] * len(self._line(self.devices, axis))
        return [int(o) for o in self._line(self.owners, axis)]

    def local_shards(self, axis) -> List[int]:
        """The global indices, along ``axis``, of the shards this process
        owns, in order."""
        return [i for i, o in enumerate(self.axis_owners(axis)) if o == self.process_index]

    def group(self, axis) -> Optional["ShardGroup"]:
        """The process group a collective over ``axis`` spans, or None
        where this process owns every shard of the axis (a one-process
        mesh, or an axis inside one process)."""
        key = tuple(axis) if isinstance(axis, (tuple, list)) else axis
        if key not in self._groups:
            owners = self.axis_owners(axis)
            self._groups[key] = (None if set(owners) == {self.process_index}
                                 else ShardGroup.of(owners, self.process_index))
        return self._groups[key]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        procs = f", processes={len(set(self.owners.flat))}" if self.is_multi_process else ""
        return f"Mesh({self.shape}, devices={devs}{procs})"


@dataclass(frozen=True)
class ShardGroup:
    """The shards of one mesh axis spread over processes: ``owners[i]`` is
    the rank holding global shard ``i``, ``rank`` this process's. Every
    process holds as many shards (the hybrid mesh's layout), and the axis
    spans the whole process group."""

    owners: Tuple[int, ...]
    rank: int

    @staticmethod
    def of(owners: Sequence[int], rank: int) -> "ShardGroup":
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = sorted(set(owners))
        if ranks != list(range(world)):
            raise ValueError(
                f"an axis whose shards lie on processes {ranks} of a group of {world}: "
                "put the data axis alone across processes (the DCN axes)")
        counts = {r: list(owners).count(r) for r in ranks}
        if len(set(counts.values())) != 1:
            raise ValueError(f"processes hold unequal shard counts {counts}")
        return ShardGroup(tuple(int(o) for o in owners), int(rank))

    @property
    def size(self) -> int:
        return len(self.owners)

    @property
    def world(self) -> int:
        return len(set(self.owners))

    def indices_of(self, rank: int) -> List[int]:
        return [i for i, o in enumerate(self.owners) if o == rank]

    @property
    def local(self) -> List[int]:
        return self.indices_of(self.rank)


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def available_devices() -> List[torch.device]:
    """Every CUDA device, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh.

    Default: a 1-D ``data`` mesh over the available devices. Pass ``shape``
    and ``axis_names`` for 2-D data × model meshes. ``devices`` must hold
    one device a mesh position (a device may repeat); left out, the
    available devices fill ``shape`` in turn, repeating as needed, so
    ``make_mesh((8,))`` on one card gives 8 shards on it."""
    if devices is None:
        avail = available_devices()
        size = len(avail) if shape is None else int(np.prod(shape))
        devs = [avail[i % len(avail)] for i in range(size)]
    else:
        devs = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devs),)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"{len(devs)} devices do not fill a mesh of shape {tuple(shape)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def default_mesh() -> Mesh:
    """Process-wide default mesh (1-D over the available devices), created
    on demand."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Temporarily install `mesh` as the process default."""
    global _default_mesh
    prev = _default_mesh
    _default_mesh = mesh
    try:
        yield mesh
    finally:
        _default_mesh = prev


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def is_multi_device(mesh: Optional[Mesh]) -> bool:
    """True for a mesh with an axis of more than one shard (the reference's
    estimators' ``any(s > 1 for s in mesh.shape.values())``)."""
    return mesh is not None and any(s > 1 for s in mesh.shape.values())


# The process group's timeout: a wrong coordinator, or a peer that never
# comes, fails the join within a minute instead of torch's 30-minute default.
DIST_TIMEOUT_S = 60.0


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout_s: float = DIST_TIMEOUT_S) -> None:
    """Join the multi-process runtime: one ``torch.distributed`` process
    group (the reference's ``jax.distributed.initialize``).

    ``coordinator_address``: ``host:port`` (a TCP store, served by process
    0) or a URL (``tcp://...``, ``file:///path`` for processes of one
    host), with ``num_processes`` and ``process_id``. Without one,
    torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` are read; with
    neither, this is a single-process run and a no-op, as the reference's
    without ``JAX_COORDINATOR_ADDRESS``. A no-op too where a group already
    exists. ``backend``: ``"nccl"`` where each rank owns its own card,
    ``"gloo"`` for CPU processes and for several ranks on one card (NCCL
    refuses two ranks on one device); unset, NCCL where CUDA is present and
    gloo where it is not. Nothing falls back from one to the other.
    ``timeout_s`` bounds the join and every collective."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not _torchrun_env():
            return  # single-process run
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed: a coordinator address needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} outside a group of {num_processes}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout_s)))


def _repeated(devices, shape) -> Optional[list]:
    """``devices`` repeated in turn to fill ``shape`` (None stays None:
    :func:`make_mesh` then repeats the available devices)."""
    if devices is None:
        return None
    return [devices[i % len(devices)] for i in range(int(np.prod(shape)))]


def make_hybrid_mesh(
    ici_shape: Tuple[int, ...],
    dcn_shape: Tuple[int, ...],
    axis_names: Sequence[str],
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over a multi-process topology: ``ici_shape`` axes within a
    process, over its local devices (``devices``, default the available
    ones, repeated to fill ``prod(ici_shape)`` as :func:`make_mesh` fills
    a shape); ``dcn_shape`` axes across processes, rank ``r`` at the
    row-major position ``r`` of the DCN grid. Axis ``a``'s global index is
    ``dcn_index · ici_shape[a] + ici_index`` (the reference's
    ``process_is_granule`` layout, reference ``mesh.py:124-131``). Put the
    data axis on DCN. A DCN product of 1 is the plain mesh, as the
    reference's single slice degenerates (reference ``mesh.py:118-120``)."""
    import torch.distributed as dist

    dcn_size = int(np.prod(dcn_shape))
    if len(ici_shape) != len(dcn_shape) or len(ici_shape) != len(axis_names):
        raise ValueError(
            f"ici_shape {tuple(ici_shape)}, dcn_shape {tuple(dcn_shape)} and axis names "
            f"{tuple(axis_names)} must have one entry an axis")
    full = tuple(int(d) * int(i) for d, i in zip(dcn_shape, ici_shape))
    if dcn_size == 1:
        return make_mesh(full, axis_names, devices=_repeated(devices, full))
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"make_hybrid_mesh: DCN axes {tuple(dcn_shape)} span {dcn_size} processes, but "
            "no process group is initialized (init_distributed first)")
    world = dist.get_world_size()
    if dcn_size != world:
        raise ValueError(
            f"make_hybrid_mesh: DCN axes {tuple(dcn_shape)} make {dcn_size} processes; the "
            f"process group has {world}")
    local = make_mesh(tuple(ici_shape), axis_names,
                      devices=_repeated(devices, ici_shape)).devices
    grid = np.empty(full, dtype=object)
    owners = np.empty(full, dtype=np.int64)
    for idx in np.ndindex(*full):
        dcn_idx = tuple(i // int(c) for i, c in zip(idx, ici_shape))
        ici_idx = tuple(i % int(c) for i, c in zip(idx, ici_shape))
        owners[idx] = np.ravel_multi_index(dcn_idx, tuple(dcn_shape))
        grid[idx] = local[ici_idx]
    return Mesh(grid, axis_names, owners=owners)


def pad_rows(x: np.ndarray, multiple: int):
    """Zero-pad the leading axis up to a multiple; returns (padded, n_valid).

    Zero padding is the invariant the solvers rely on: padded rows contribute
    nothing to Gramians (AtA), moment sums, or gradient accumulations, so only
    divisions by n need the true count.
    """
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        pad = torch.zeros((rem,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, pad]), n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width), n


class ShardedRows:
    """A row-sharded tensor: global shard ``i`` holds rows ``[i·r, (i+1)·r)``
    of the global (padded) array on the mesh's ``i``-th device along
    ``axis`` (``r`` rows a shard). Shape and dtype are the global array's.
    ``shards`` are this process's shards, in order, and ``indices`` their
    global indices (of a one-process mesh: every shard, ``0 … P−1``).
    Code that is not mesh-aware reads it through
    :func:`~keystone_tpu_torch.data.dataset.as_tensor`, which gathers the
    shards onto the first one's device, as a sharded ``jax.Array`` reads
    as one array; a multi-process array refuses (:meth:`gather`)."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, axis=DATA_AXIS,
                 indices: Optional[Sequence[int]] = None):
        self.shards = tuple(shards)
        self.mesh = mesh
        self.axis = axis
        group = mesh.group(axis)
        if indices is None:
            indices = range(len(self.shards)) if group is None else group.local
        self.indices = tuple(int(i) for i in indices)
        if len(self.indices) != len(self.shards):
            raise ValueError(f"{len(self.shards)} shards with {len(self.indices)} indices")
        self._total = len(self.shards) if group is None else group.size
        rows = {int(s.shape[0]) for s in self.shards}
        if len(rows) != 1:
            raise ValueError(f"shards must hold equal row counts, got {sorted(rows)}")

    @property
    def group(self) -> Optional[ShardGroup]:
        """The process group the shards span (None: all are this process's)."""
        return self.mesh.group(self.axis)

    @property
    def num_shards(self) -> int:
        """The global shard count."""
        return self._total

    @property
    def shard_rows(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        first = self.shards[0].shape
        return torch.Size((self.num_shards * first[0],) + tuple(first[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def ndim(self) -> int:
        return self.shards[0].dim()

    def dim(self) -> int:
        return self.ndim

    def __len__(self) -> int:
        return self.shape[0]

    def _refuse_remote(self, what: str) -> None:
        if self.group is not None:
            raise RuntimeError(
                f"ShardedRows.{what}: the array spans {self.group.world} processes and this "
                f"one holds shards {list(self.indices)} of {self.num_shards}; read it with "
                "mesh.process_allgather (a non-addressable array does not read as one)")

    def gather(self) -> torch.Tensor:
        """The global array on the first shard's device."""
        self._refuse_remote("gather")
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])

    def head(self, k: int) -> torch.Tensor:
        """The first ``k`` global rows, on the first shard's device."""
        self._refuse_remote("head")
        dev, parts, left = self.shards[0].device, [], int(k)
        for s in self.shards:
            if left <= 0:
                break
            parts.append(s[:left].to(dev))
            left -= int(s.shape[0])
        return torch.cat(parts) if parts else self.shards[0][:0]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedRows":
        """``fn`` applied to each shard (a row-local function)."""
        return ShardedRows([fn(s) for s in self.shards], self.mesh, self.axis, self.indices)

    def __repr__(self) -> str:
        where = "" if self.group is None else f", local {list(self.indices)}"
        return (f"ShardedRows(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"shards={self.num_shards} over {self.axis!r}{where})")


def _axis_devices(mesh: Mesh, axis) -> List[torch.device]:
    if isinstance(axis, (tuple, list)):
        return mesh.flat_devices(axis)
    return mesh.axis_devices(axis)


def host_tensor(x) -> torch.Tensor:
    """A host array as a CPU tensor; float64 becomes float32, since the
    port computes in float32, as the reference does outside its x64 tests.
    A tensor is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_rows(x, mesh: Optional[Mesh] = None, axis=DATA_AXIS) -> ShardedRows:
    """Place an array on the mesh, sharded along its leading (example)
    axis. Its row count must divide by the axis's shards (pad first, with
    :func:`pad_rows`); ``axis`` may be a tuple of axes, flattened first
    major. Host arrays convert as :func:`host_tensor` converts them, so
    sharded float64 rows fit in float32 as unsharded ones do. ``x`` is the
    global array: on a multi-process mesh every process passes the same
    rows and keeps its own shards (``jax.device_put`` of a global array);
    where each process holds only its own rows, :func:`shard_local_rows`."""
    mesh = mesh or default_mesh()
    if isinstance(x, ShardedRows):
        x = x.gather()
    x = host_tensor(x)
    devices = _axis_devices(mesh, axis)
    num = len(devices)
    if x.shape[0] % num:
        raise ValueError(
            f"{x.shape[0]} rows do not divide over {num} shards; pad them first (pad_rows)"
        )
    rows = x.shape[0] // num
    local = mesh.local_shards(axis)
    return ShardedRows([x[i * rows:(i + 1) * rows].to(devices[i]) for i in local],
                       mesh, axis, local)


def shard_local_rows(x, mesh: Optional[Mesh] = None, axis=DATA_AXIS) -> ShardedRows:
    """This process's rows as its shards of a global row-sharded array:
    the twin of ``jax.make_array_from_process_local_data``. Each process
    passes the contiguous block of global rows its shards cover (process
    ``p`` of a hybrid mesh's data axis: rows ``[p·m, (p+1)·m)``, ``m`` the
    same on every process); they split evenly over its local shards. On a
    one-process mesh it is :func:`shard_rows`."""
    mesh = mesh or default_mesh()
    x = host_tensor(x)
    local = mesh.local_shards(axis)
    if local != list(range(local[0], local[0] + len(local))):
        raise ValueError(f"this process's shards {local} along {axis!r} are not contiguous")
    if x.shape[0] % len(local):
        raise ValueError(
            f"{x.shape[0]} local rows do not divide over {len(local)} local shards")
    rows = x.shape[0] // len(local)
    devices = _axis_devices(mesh, axis)
    return ShardedRows([x[j * rows:(j + 1) * rows].to(devices[i]) for j, i in enumerate(local)],
                       mesh, axis, local)


def replicate(x, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, ...]:
    """The array on every local data shard's device (the ``broadcast``
    analog): one tensor a shard, the same storage where devices coincide."""
    mesh = mesh or default_mesh()
    x = host_tensor(x)
    devices = mesh.axis_devices(DATA_AXIS)
    return tuple(x.to(devices[i]) for i in mesh.local_shards(DATA_AXIS))


def _backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group's transport takes it: gloo moves host
    memory, so a CUDA tensor goes through the host explicitly; NCCL takes
    it where it lies."""
    t = t.contiguous()
    return t.cpu() if _backend() == "gloo" else t


def _gather_parts(parts: Sequence[torch.Tensor], group: ShardGroup) -> List[torch.Tensor]:
    """Every shard's tensor, in global shard order: this process's own
    ``parts`` as they are, the others' all-gathered over the group (each
    process contributes its shards stacked; equal shapes)."""
    import torch.distributed as dist

    if len(parts) != len(group.local):
        raise ValueError(f"{len(parts)} parts for this process's {len(group.local)} shards")
    mine = _staged(torch.stack([p.contiguous() for p in parts]))
    got = [torch.empty_like(mine) for _ in range(group.world)]
    dist.all_gather(got, mine)
    out: List[Optional[torch.Tensor]] = [None] * group.size
    for rank, stacked in enumerate(got):
        for j, i in enumerate(group.indices_of(rank)):
            out[i] = parts[j] if rank == group.rank else stacked[j]
    return out


def process_allgather(x) -> np.ndarray:
    """Each process's host array, stacked in process order: shape
    ``(num_processes, *x.shape)`` (the twin of
    ``multihost_utils.process_allgather``). Every process passes an array
    of the same shape and dtype. Without a process group: ``x[None]``."""
    import torch.distributed as dist

    t = torch.as_tensor(np.ascontiguousarray(np.asarray(x)))
    if not (dist.is_available() and dist.is_initialized()):
        return t.numpy()[None]
    if _backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    return torch.stack(got).cpu().numpy()


def psum(parts: Sequence[torch.Tensor], device=None, *,
         group: Optional[ShardGroup] = None) -> torch.Tensor:
    """The sum of the shards' partials, added in shard order on ``device``
    (default: the first partial's), a fresh tensor: the fixed-order form
    of the reference's ``lax.psum`` over an axis. With ``group`` (the
    axis spans processes), ``parts`` are this process's shards' partials:
    every shard's partial is all-gathered, then added in global shard
    order, so each process holds the one-process sum's bits."""
    dev = parts[0].device if device is None else torch.device(device)
    if group is not None:
        parts = _gather_parts(parts, group)
    acc = parts[0].to(dev, copy=True)
    for p in parts[1:]:
        acc += p.to(dev)
    return acc


_local = threading.local()


def axis_index(axis: str) -> int:
    """Inside a :func:`shard_map` body: the global index of the shard it
    runs on along ``axis`` (``jax.lax.axis_index``)."""
    stack = getattr(_local, "index", None)
    if not stack or axis not in stack[-1]:
        raise RuntimeError(f"axis_index({axis!r}) outside a shard_map body over it")
    return stack[-1][axis]


def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs, axis: str = DATA_AXIS) -> Callable:
    """Run ``f`` once a shard of ``axis`` (``jax.shard_map``'s role), on
    this process's shards.

    ``in_specs`` / ``out_specs``: one entry an argument / output, the axis
    name for a row-sharded value, ``None`` for a replicated one. A
    sharded input is a :class:`ShardedRows` over the axis (a plain tensor
    is sharded first); a replicated input reaches each body on its
    shard's device. A sharded output is collected into a
    :class:`ShardedRows`; a replicated output is the :func:`psum` of the
    bodies' outputs (across processes where the axis spans them) on the
    first local shard's device, the one collective a body can end in (a
    ring's rotations run between bodies: ``parallel/ring.py``).
    ``axis_index`` inside the body reads the shard's global index. A
    single spec (not a tuple) stands for a single argument or output."""
    single_out = not isinstance(out_specs, (tuple, list))
    outs_spec = (out_specs,) if single_out else tuple(out_specs)
    ins_spec = tuple(in_specs) if isinstance(in_specs, (tuple, list)) else (in_specs,)
    devices = mesh.axis_devices(axis)
    local = mesh.local_shards(axis)
    group = mesh.group(axis)

    def run(*args):
        if len(args) != len(ins_spec):
            raise TypeError(f"shard_map body takes {len(ins_spec)} arguments, got {len(args)}")
        placed = []
        for a, spec in zip(args, ins_spec):
            if spec is None:
                placed.append([_to(a, devices[i]) for i in local])
            else:
                sh = a if isinstance(a, ShardedRows) else shard_rows(a, mesh, axis)
                if sh.num_shards != len(devices):
                    raise ValueError(
                        f"argument holds {sh.num_shards} shards, the axis {len(devices)}"
                    )
                placed.append(list(sh.shards))
        stack = getattr(_local, "index", None)
        if stack is None:
            stack = _local.index = []
        per_shard = []
        for j, i in enumerate(local):
            stack.append({axis: i})
            try:
                out = f(*[p[j] for p in placed])
            finally:
                stack.pop()
            per_shard.append((out,) if single_out else tuple(out))
        results = []
        for k, spec in enumerate(outs_spec):
            parts = [o[k] for o in per_shard]
            results.append(psum(parts, devices[local[0]], group=group) if spec is None
                           else ShardedRows(parts, mesh, axis, local))
        return results[0] if single_out else tuple(results)

    return run


def _to(a, device):
    return a.to(device) if isinstance(a, torch.Tensor) else a


def _parts_devices(parts, devices) -> List[torch.device]:
    if devices is None:
        return [p.device for p in parts]
    devices = [torch.device(d) for d in devices]
    if len(devices) != len(parts):
        raise ValueError(f"{len(parts)} shards on {len(devices)} devices")
    return devices


def ring_perm(p: int) -> List[Tuple[int, int]]:
    """The forward ring over ``p`` shards: shard i sends to shard i + 1."""
    return [(i, (i + 1) % p) for i in range(p)]


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices=None, *, group: Optional[ShardGroup] = None) -> List[torch.Tensor]:
    """``lax.ppermute`` over a list of shards: for each ``(src, dst)`` of
    ``perm`` (global shard indices), shard ``dst`` receives shard ``src``,
    copied to ``dst``'s device (``devices``, default each part's own); a
    shard no pair sends to receives zeros, as in JAX. Where both lie on
    one device (8 shards on ``cuda:0``) the result is the source tensor
    itself, not a copy, so a step must not write in place into a shard it
    was handed.

    With ``group``, ``parts`` are this process's shards and a pair whose
    ends lie in two processes goes point to point: every rank posts its
    sends and receives in ``perm``'s order, all before it waits on any
    (gloo: ``isend`` / ``irecv`` tagged by the destination; NCCL: one
    ``batch_isend_irecv``), so no two ranks wait on each other."""
    devices = _parts_devices(parts, devices)
    twice = [dst for dst, count in Counter(d for _, d in perm).items() if count > 1]
    if twice:
        raise ValueError(f"ppermute: shard {twice[0]} receives twice in {list(perm)}")
    if group is None:
        out: List[Optional[torch.Tensor]] = [None] * len(parts)
        for src, dst in perm:
            out[dst] = parts[src].to(devices[dst])
        return [o if o is not None else torch.zeros_like(parts[i], device=devices[i])
                for i, o in enumerate(out)]
    import torch.distributed as dist

    pos = {i: j for j, i in enumerate(group.local)}
    out = [None] * len(parts)
    ops, received = [], []
    nccl = _backend() == "nccl"
    for src, dst in perm:
        src_rank, dst_rank = group.owners[src], group.owners[dst]
        if src_rank == group.rank and dst_rank == group.rank:
            out[pos[dst]] = parts[pos[src]].to(devices[pos[dst]])
        elif src_rank == group.rank:
            buf = _staged(parts[pos[src]])
            ops.append(dist.P2POp(dist.isend, buf, dst_rank) if nccl
                       else dist.isend(buf, dst_rank, tag=int(dst)))
        elif dst_rank == group.rank:
            buf = torch.empty_like(_staged(parts[pos[dst]]))
            ops.append(dist.P2POp(dist.irecv, buf, src_rank) if nccl
                       else dist.irecv(buf, src_rank, tag=int(dst)))
            received.append((pos[dst], buf))
    reqs = dist.batch_isend_irecv(ops) if nccl and ops else ops
    for r in reqs:
        r.wait()
    for j, buf in received:
        out[j] = buf.to(devices[j])
    return [o if o is not None else torch.zeros_like(parts[j], device=devices[j])
            for j, o in enumerate(out)]


def all_gather(parts: Sequence[torch.Tensor], devices=None, *,
               group: Optional[ShardGroup] = None) -> List[torch.Tensor]:
    """Tiled ``lax.all_gather``: the shards concatenated in shard order,
    one tensor for each (local) shard. The concatenation is made once for
    each distinct device and shared by the shards on it (read-only). With
    ``group``, every process's shards join in global order."""
    devices = _parts_devices(parts, devices)
    every = list(parts) if group is None else _gather_parts(parts, group)
    made = {}
    out = []
    for dev in devices:
        if dev not in made:
            made[dev] = torch.cat([p.to(dev) for p in every])
        out.append(made[dev])
    return out


def psum_scatter(parts: Sequence[torch.Tensor], devices=None, *,
                 group: Optional[ShardGroup] = None) -> List[torch.Tensor]:
    """Tiled ``lax.psum_scatter`` with ``scatter_dimension=0``: the sum of
    the partials, stripe j of its leading axis (equal stripes) on shard
    j's device. Each stripe is summed on its destination in shard order,
    so its bits are those of :func:`psum` whatever the devices. With
    ``group``, ``parts`` are this process's and it receives its own
    shards' stripes."""
    devices = _parts_devices(parts, devices)
    every = list(parts) if group is None else _gather_parts(parts, group)
    mine = range(len(parts)) if group is None else group.local
    p = len(every)
    rows = int(every[0].shape[0])
    if rows % p:
        raise ValueError(f"psum_scatter: {rows} rows do not split into {p} stripes")
    r = rows // p
    out = []
    for j, dev in zip(mine, devices):
        acc = every[0][j * r:(j + 1) * r].to(dev, copy=True)
        for part in every[1:]:
            acc += part[j * r:(j + 1) * r].to(dev)
        out.append(acc)
    return out


def sync_if_cpu(x) -> None:
    """The reference's barrier after a dispatched step on its CPU backend,
    whose forced-host devices deadlock when many collective programs queue
    asynchronously. The single controller queues no collective program:
    a no-op kept for the call sites' shape."""
    return None
