"""Dataset: the collection abstraction replacing RDDs.

Port of ``keystone_tpu/data/dataset.py``, single device:

  - **Array form** (the common case): ``data`` is a ``torch.Tensor`` with a
    leading example axis, a (nested) tuple of them — the output of a
    gather — or a dict of them (the padded-COO sparse batch
    ``{"indices", "values"}`` of ``ops/sparse.py``). It may carry zero
    padding rows past the true count ``n``; padding rows are all-zero so
    Gramians and moment sums are unaffected.
  - **Host form**: a Python list of arbitrary objects for stages that must
    run host-side.
  - **Shard form**: ``data`` is a :class:`~keystone_tpu_torch.data.prefetch.
    ShardSource`, ordered disk or host segments delivered one at a time,
    for datasets whose resident size exceeds the host-RAM budget. Streamed
    solvers consume the source directly (prefetched, never resident);
    anything else calls ``materialize()``, which only small sources
    should ever reach.

An array-form dataset may be sharded over a one-host device mesh
(``shard()``, ``parallel/mesh.py``): each array is then a
:class:`~keystone_tpu_torch.parallel.mesh.ShardedRows`, zero-padded to a
multiple of the mesh's ``data`` axis, and ``mesh`` names the mesh.
``map_batch`` runs a (row-local) batched function on each shard and
zeroes the padding rows again; code that is not mesh-aware reads a
sharded array through ``as_tensor``, which gathers it, as the reference
reads a sharded ``jax.Array``. Numpy arrays handed to ``Dataset.of`` stay
numpy until a node moves them to its device, exactly as the reference
leaves host arrays to ``jnp.asarray``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.mesh import ShardedRows

from .prefetch import ShardSource

def _is_arraylike(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor)) or (
        hasattr(x, "shape") and hasattr(x, "dtype")
    )


def tree_leaves(data: Any) -> List[Any]:
    """The arrays of an array-form payload, in order (a dict's in sorted key
    order, as JAX flattens one)."""
    if isinstance(data, tuple):
        return [leaf for d in data for leaf in tree_leaves(d)]
    if isinstance(data, dict):
        return [leaf for key in sorted(data) for leaf in tree_leaves(data[key])]
    return [data]


def tree_map(fn: Callable[[Any], Any], data: Any) -> Any:
    """``fn`` applied to every array of an array-form payload."""
    if isinstance(data, tuple):
        return tuple(tree_map(fn, d) for d in data)
    if isinstance(data, dict):
        return {key: tree_map(fn, value) for key, value in data.items()}
    return fn(data)


def as_tensor(x: Any, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (default: where it already lives,
    or the CPU for host arrays). float64 host arrays become float32: the
    port computes in float32, as the reference does outside its x64 tests.
    A row-sharded array is gathered onto its first shard's device."""
    if isinstance(x, ShardedRows):
        x = x.gather()
    t = mesh_lib.host_tensor(x)
    if device is not None and t.device != torch.device(device):
        t = t.to(device)
    return t


class Dataset:
    """A batch of n examples, in tensor or host-list form."""

    def __init__(self, data: Any, n: Optional[int] = None, mesh=None):
        if isinstance(data, Dataset):
            raise TypeError("Dataset(data) may not wrap another Dataset")
        self.data = data
        self.mesh = mesh
        if isinstance(data, list):
            self.n = len(data) if n is None else n
        elif isinstance(data, ShardSource):
            self.n = data.n_true if n is None else n
        else:
            leaves = tree_leaves(data)
            if not leaves:
                raise ValueError("Array dataset must contain at least one array")
            self.n = int(leaves[0].shape[0]) if n is None else n

    # -- constructors -------------------------------------------------------

    @staticmethod
    def of(data: Any, mesh=None) -> "Dataset":
        """Wrap a list (host form) or array / tuple of arrays (array form).
        ``mesh`` records the mesh an already-sharded array lies on."""
        if isinstance(data, Dataset):
            return data
        if isinstance(data, list) and not (data and _is_arraylike(data[0])):
            return Dataset(list(data))
        if isinstance(data, list):
            # list of per-example arrays with identical shapes -> stack;
            # ragged -> host form
            shapes = {tuple(np.shape(x)) for x in data}
            if len(shapes) == 1:
                if isinstance(data[0], torch.Tensor):
                    return Dataset(torch.stack(data), mesh=mesh)
                return Dataset(np.stack([np.asarray(x) for x in data]), mesh=mesh)
            return Dataset(list(data))
        return Dataset(data, mesh=mesh)

    @staticmethod
    def gather(branches: List["Dataset"]) -> "Dataset":
        """Zip branches into a dataset of tuples (GatherTransformerOperator.scala:9-18)."""
        ns = {b.n for b in branches}
        if len(ns) != 1:
            raise ValueError(f"Gathered branches must have equal sizes, got {ns}")
        if all(not b.is_host for b in branches):
            return Dataset(tuple(b.data for b in branches), n=branches[0].n,
                           mesh=branches[0].mesh)
        items = [b.to_list() for b in branches]
        return Dataset([tuple(vals) for vals in zip(*items)])

    @staticmethod
    def from_shards(source: ShardSource, n: Optional[int] = None) -> "Dataset":
        """A Dataset backed by an out-of-core :class:`ShardSource`."""
        return Dataset(source, n=n)

    # -- properties ---------------------------------------------------------

    @property
    def is_host(self) -> bool:
        return isinstance(self.data, list)

    @property
    def is_shard_backed(self) -> bool:
        return isinstance(self.data, ShardSource)

    @property
    def shard_source(self) -> ShardSource:
        if not self.is_shard_backed:
            raise ValueError("Dataset is not shard-backed")
        return self.data

    def materialize(self) -> "Dataset":
        """Shard form -> array form (concatenates every segment on the
        host; only sources that fit host RAM should ever reach this: the
        streamed solvers consume the source directly instead)."""
        if not self.is_shard_backed:
            return self
        mat = self.data.materialize()
        if isinstance(mat, tuple):
            mat = mat[0]  # a paired (X, Y) source read as a data Dataset
        return Dataset(np.asarray(mat), n=self.n, mesh=self.mesh)

    @property
    def array(self):
        """The single underlying array (errors for tuple datasets): a
        :class:`~keystone_tpu_torch.parallel.mesh.ShardedRows` when
        sharded."""
        if self.is_shard_backed:
            return self.materialize().array
        if self.is_host:
            return np.stack([np.asarray(x) for x in self.data])
        if isinstance(self.data, (tuple, dict)):
            raise ValueError("Dataset holds a tuple or dict of arrays; use .data")
        return self.data

    @property
    def num_padded(self) -> int:
        if self.is_host:
            return len(self.data)
        if self.is_shard_backed:
            return self.n
        return int(tree_leaves(self.data)[0].shape[0])

    def __len__(self) -> int:
        return self.n

    # -- transforms ---------------------------------------------------------

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        """Apply `fn` per example (a host loop: the port has no vmap on the
        slice's path, and every node there declares a batched form)."""
        return Dataset.of([fn(x) for x in self.to_list()])

    @property
    def is_sharded(self) -> bool:
        return not self.is_host and not self.is_shard_backed and any(
            isinstance(leaf, ShardedRows) for leaf in tree_leaves(self.data))

    def map_batch(self, fn: Callable[[Any], Any]) -> "Dataset":
        """Apply a whole-batch (vectorized) function to the array form; a
        sharded dataset runs it on each shard (it must be row-local, the
        ``device_fn`` contract), as the reference's sharded programs
        partition."""
        if self.is_sharded:
            return Dataset(_map_shards(fn, self.data), n=self.n,
                           mesh=self.mesh)._rezero_padding()
        return Dataset(fn(self.data), n=self.n, mesh=self.mesh)._rezero_padding()

    def _rezero_padding(self) -> "Dataset":
        """Restore the all-zero-padding invariant after a non-zero-preserving
        transform (padding rows must not pollute Gramians/moment sums)."""
        if self.is_host or self.num_padded == self.n:
            return self
        n = self.n

        def zero(leaf):
            if isinstance(leaf, ShardedRows):
                rows = leaf.shard_rows
                shards = []
                for i, s in enumerate(leaf.shards):
                    keep = n - i * rows
                    if keep < rows:
                        s = s.clone()
                        s[max(keep, 0):] = 0
                    shards.append(s)
                return ShardedRows(shards, leaf.mesh, leaf.axis)
            leaf = as_tensor(leaf).clone()
            leaf[n:] = 0
            return leaf

        return Dataset(tree_map(zero, self.data), n=n, mesh=self.mesh)

    def to_list(self) -> List[Any]:
        """Materialize as a host list of per-example values (padding dropped)."""
        if self.is_shard_backed:
            return self.materialize().to_list()
        if self.is_host:
            return list(self.data)
        if isinstance(self.data, tuple):
            parts = [_to_numpy(leaf)[: self.n] for leaf in self.data]
            return [tuple(p[i] for p in parts) for i in range(self.n)]
        return list(_to_numpy(self.array)[: self.n])

    def to_numpy(self) -> np.ndarray:
        """The underlying array with padding rows dropped, as numpy."""
        return _to_numpy(self.array)[: self.n]

    # -- distribution -------------------------------------------------------

    def shard(self, mesh=None, axis: str = mesh_lib.DATA_AXIS) -> "Dataset":
        """Pad to divisibility and shard the leading axis over the mesh."""
        if self.is_shard_backed:
            return self.materialize().shard(mesh, axis)
        if self.is_host:
            raise ValueError("Host datasets cannot be device-sharded; vectorize first")
        mesh = mesh or mesh_lib.default_mesh()
        size = mesh_lib.axis_size(mesh, axis)

        def place(leaf):
            if isinstance(leaf, ShardedRows):
                leaf = leaf.gather()
            padded, _ = mesh_lib.pad_rows(leaf if isinstance(leaf, torch.Tensor)
                                          else np.asarray(leaf), size)
            return mesh_lib.shard_rows(padded, mesh, axis)

        return Dataset(tree_map(place, self.data), n=self.n, mesh=mesh)

    def valid_mask(self) -> torch.Tensor:
        """(num_padded,) float mask: 1 for real rows, 0 for padding."""
        return (torch.arange(self.num_padded) < self.n).to(torch.float32)

    def cache(self) -> "Dataset":
        """Force materialization now (the Cacher analog): wait for the
        device work that produced this dataset."""
        if not self.is_host and not self.is_shard_backed:
            for leaf in tree_leaves(self.data):
                if isinstance(leaf, ShardedRows):
                    leaf = leaf.shards[-1]
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                    break
        return self

    def __repr__(self) -> str:
        if self.is_shard_backed:
            return f"Dataset(shards, n={self.n}, segments={self.data.num_segments})"
        if self.is_host:
            return f"Dataset(host, n={self.n})"
        shapes = tree_map(lambda x: tuple(x.shape), self.data)
        sharded = f", mesh={self.mesh}" if self.mesh is not None else ""
        return f"Dataset(array, n={self.n}, shapes={shapes}{sharded})"


def _map_shards(fn: Callable[[Any], Any], data: Any) -> Any:
    """``fn`` run on each shard of a sharded payload (each leaf a
    :class:`ShardedRows` with the same shard count); its outputs, one a
    shard, collected leaf by leaf into :class:`ShardedRows`."""
    leaves = [leaf for leaf in tree_leaves(data) if isinstance(leaf, ShardedRows)]
    first = leaves[0]
    outs = [
        fn(tree_map(lambda leaf, i=i: leaf.shards[i] if isinstance(leaf, ShardedRows) else leaf,
                    data))
        for i in range(first.num_shards)
    ]
    return _collect_shards(outs, first.mesh, first.axis)


def _collect_shards(outs: List[Any], mesh, axis) -> Any:
    head = outs[0]
    if isinstance(head, tuple):
        return tuple(_collect_shards([o[j] for o in outs], mesh, axis) for j in range(len(head)))
    if isinstance(head, dict):
        return {key: _collect_shards([o[key] for o in outs], mesh, axis) for key in head}
    return ShardedRows(outs, mesh, axis)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, ShardedRows):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def one_hot_pm1(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Integer class labels -> the ±1 one-hot regression targets every LS
    pipeline here fits against (the host-side twin of
    ``ClassLabelIndicatorsFromIntLabels``)."""
    return (
        2.0 * np.eye(num_classes, dtype=np.float32)[
            np.asarray(labels, dtype=np.int64).reshape(-1)
        ] - 1.0
    )


class LabeledData:
    """A (data, labels) pair of aligned Datasets (loaders/LabeledData.scala:12-15)."""

    def __init__(self, data: Any, labels: Any):
        self.data = Dataset.of(data)
        self.labels = Dataset.of(labels)
        if self.data.n != self.labels.n:
            raise ValueError(
                f"data ({self.data.n}) and labels ({self.labels.n}) must align"
            )

    def to_disk_shards(
        self,
        path: str,
        shard_rows: int,
        tiles_per_segment: int = 4,
        num_classes: Optional[int] = None,
    ) -> "LabeledData":
        """Spill this (data, labels) pair to pre-tiled disk shards and
        return a shard-backed LabeledData over the files: the loaders'
        materialize-to-disk-instead-of-RAM path. Integer class labels
        become ±1 one-hot regression targets when ``num_classes`` is given
        (the convention every LS pipeline here uses); otherwise labels are
        stored as they are, reshaped to (n, k)."""
        from .shards import DiskDenseShards

        X = _to_numpy(self.data.array)[: self.data.n]
        Y = _to_numpy(self.labels.array)[: self.labels.n]
        if num_classes is not None:
            Y = one_hot_pm1(Y, num_classes)
        elif Y.ndim == 1:
            Y = Y[:, None]
        shards = DiskDenseShards.write(
            path, X, Y.astype(np.float32, copy=False),
            tile_rows=int(shard_rows), tiles_per_segment=tiles_per_segment,
        )
        return shards.as_labeled_data()
