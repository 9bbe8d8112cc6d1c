"""Device meshes for the radiation pipeline.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX annotates
arrays with a ``NamedSharding`` and lets XLA's partitioner place them and
insert the collectives.  PyTorch has no partitioner, so the port places by
hand, with the same two axes:

* **columns** (``"cols"``) are embarrassingly parallel: mesh position
  (c, g) holds the c-th contiguous slab of every column-leading field;
* **g-points** (``"gpt"``) split the spectrum: position (c, g) holds the
  g-th contiguous g-slice of each k-distribution
  (:meth:`KDist.slice_gpt`; band indices stay global), and the broadband
  sums are added over the ``gpt`` axis afterwards
  (``parallel/sharded.py``).

A :class:`Mesh` is an ndarray of ``torch.device`` with axis names.  The
same device may appear more than once: a mesh that lists one card four
times runs four shards on it, the counterpart of JAX's virtual host
devices (``--xla_force_host_platform_device_count``).  A tree placed on a
mesh is a :class:`Placed`: ``parts[c, g]`` is the tree at cols index c and
gpt index g (0 on an absent axis), on that position's device; in a mesh
over several processes (``parallel/distributed.py``) the positions of the
other processes hold None.  A placed tensor on a device it already lives on
is the same tensor or a view of it; on another device, a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config

AXES = ("cols", "gpt")


@dataclasses.dataclass(eq=False)
class Mesh:
    """Devices on named axes.  ``ranks`` (same shape) names the process
    that owns each position, None where this process owns all of them;
    ``groups`` maps an axis to the ``torch.distributed`` group of this
    process's line along it (only axes that cross processes).  ``copies``
    caches the tables placed by :func:`replicate` and :func:`shard_kdist`,
    so a second solve on the mesh copies nothing."""

    devices: np.ndarray
    axis_names: tuple
    ranks: Optional[np.ndarray] = None
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    copies: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        names = tuple(self.axis_names)
        if (len(names) != self.devices.ndim or len(set(names)) != len(names)
                or not set(names) <= set(AXES)):
            raise ValueError(f"a {self.devices.shape} mesh needs as many "
                             f"distinct axis names from {AXES}, got {names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The mesh's extent along ``axis`` (1 where it has no such axis)."""
        return self.shape.get(axis, 1)

    def grid(self, arr: Optional[np.ndarray] = None) -> np.ndarray:
        """``arr`` (default: the devices) as a (cols, gpt) array."""
        arr = self.devices if arr is None else arr
        order = [self.axis_names.index(a) for a in AXES
                 if a in self.axis_names]
        return np.transpose(arr, order).reshape(self.size("cols"),
                                                self.size("gpt"))

    def local_positions(self):
        """[((c, g), device)] of the positions this process owns, cols
        index first."""
        devs = self.grid()
        ranks = None if self.ranks is None else self.grid(self.ranks)
        return [((c, g), devs[c, g]) for c in range(devs.shape[0])
                for g in range(devs.shape[1])
                if ranks is None or ranks[c, g] == self.rank]

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first position: where the outputs
        of a sharded call are gathered."""
        return self.local_positions()[0][1]


@dataclasses.dataclass(frozen=True)
class Placed:
    """A tree placed on ``mesh``: ``parts[c, g]`` (a (cols, gpt) object
    array) is the tree at that position, on its device, or None at a
    position of another process."""

    mesh: Mesh
    parts: np.ndarray

    def local(self):
        """[((c, g), tree)] of this process's positions."""
        return [(pos, self.parts[pos]) for pos, _ in
                self.mesh.local_positions()]


def tree_map(fn, tree):
    """``fn`` applied to every tensor and ndarray leaf of a tree of lists,
    tuples, dicts and dataclasses; other leaves are kept."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = AXES, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device; raises where
    there is no card, as ``config.resolve_device`` does).  ``shape=None``
    puts all devices on the ``cols`` axis (the zero-communication axis);
    ``shape=(a, b)`` takes the first a*b devices onto ("cols", "gpt"); a
    shorter shape takes the leading axis names.  A device may be listed
    more than once (``devices=["cuda:0"] * 4``, or ``["cpu"] * 8`` on the
    CPU): each listing is one shard."""
    if devices is None:
        config.resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = d
    return Mesh(arr.reshape(shape), tuple(axis_names)[:len(shape)])


def column_spec(mesh: Mesh, ndim: int) -> tuple:
    """The placement of an (ncol, ...) array: its leading axis on
    ``cols``, the others whole (JAX's ``P("cols", None, ...)``)."""
    if "cols" not in mesh.axis_names:
        raise ValueError("the mesh has no 'cols' axis")
    return ("cols",) + (None,) * (ndim - 1)


def _placed(mesh: Mesh, make) -> Placed:
    parts = np.empty((mesh.size("cols"), mesh.size("gpt")), dtype=object)
    for pos, dev in mesh.local_positions():
        parts[pos] = make(pos, dev)
    return Placed(mesh, parts)


def _cached(mesh: Mesh, obj, tag, device, make):
    """``make()`` once per (object, tag, device) on ``mesh``; the source
    object is kept alive with its copy, so its id is never reused."""
    key = (id(obj), tag, device)
    hit = mesh.copies.get(key)
    if hit is None:
        hit = mesh.copies[key] = (obj, make())
    return hit[1]


def replicate(mesh: Mesh, tree) -> Placed:
    """``tree`` whole at every position, one copy a device (cached on the
    mesh: placing the same tables again copies nothing)."""
    return _placed(mesh, lambda pos, dev: tree_map(lambda a: _cached(
        mesh, a, None, dev, lambda: torch.as_tensor(a).to(dev)), tree))


def shard_atmosphere(mesh: Mesh, tree) -> Placed:
    """Every array of ``tree`` split on its leading (column) axis into
    ``cols`` contiguous slabs; position (c, g) holds slab c on its device
    (on the device the array is on: a view, no copy)."""
    n = mesh.size("cols")

    def slab(a, c, dev):
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(
                f"ncol={a.shape[0]} must divide over the {n}-way cols mesh "
                "axis (pad the columns or choose a different mesh)")
        w = a.shape[0] // n
        return a[c * w:(c + 1) * w].to(dev)

    return _placed(mesh, lambda pos, dev: tree_map(
        lambda a: slab(a, pos[0], dev), tree))


def gpt_bounds(ngpt: int, n: int, g: int):
    """[g0, g1) of the g-th of ``n`` contiguous g-slices of ``ngpt``
    g-points: the first ``ngpt % n`` slices take one g-point more."""
    if not 0 < n <= ngpt:
        raise ValueError(f"cannot split {ngpt} g-points {n} ways")
    q, r = divmod(ngpt, n)
    g0 = g * q + min(g, r)
    return g0, g0 + q + (g < r)


def shard_kdist(kd, mesh: Mesh) -> Placed:
    """A k-distribution on the mesh: position (c, g) holds
    ``kd.slice_gpt(g0, g1)``, the g-th contiguous g-slice (band indices
    stay global), on its device.  With no ``gpt`` axis, or one of size 1,
    it only replicates."""
    n = mesh.size("gpt")
    if n == 1:
        return replicate(mesh, kd)

    def part(pos, dev):
        g0, g1 = gpt_bounds(kd.ngpt, n, pos[1])
        return _cached(mesh, kd, (g0, g1), dev, lambda: tree_map(
            lambda a: a.to(dev), kd.slice_gpt(g0, g1)))
    return _placed(mesh, part)
