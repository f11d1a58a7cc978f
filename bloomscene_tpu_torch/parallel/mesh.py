"""The ('data', 'tile') mesh over ``torch.distributed`` ranks, and its
collectives.

The port of ``bloomscene_tpu/parallel/mesh.py``. Under JAX one process
drives many devices and the shardings say where each array lives; here
each rank is one process with one device, every rank holds its own
tensors, and the layers above call the collectives explicitly:

- ``data``: data parallelism over cameras. Each data rank renders its
  share of a batch of views of the replicated scene, and the parameter
  gradients are summed with ``all_reduce`` (``train/loop.py``).
- ``tile``: the blend's tile positions are cut into one strip a rank; the
  strips' planes and per-entry gradients are put together with
  ``all_gather`` (``ops/cuda/wrapper.py``).

Ranks are laid out data-major: rank = d * tile + t, so the ranks of one
data replica are consecutive (``make_host_mesh`` puts the hosts on the
data axis, as JAX's puts processes there). The axes are plain
``new_group``s, not a ``DeviceMesh``: a mesh must also exist with no
process group at all (one process, world size 1), where every collective
is the identity, and a ``DeviceMesh`` cannot.

Backends. The default follows the device: ``nccl`` for ``cuda``, ``gloo``
for ``cpu``. Gloo takes CUDA tensors only for ``all_reduce`` and
``broadcast``; its ``all_gather``, ``send`` and ``recv`` take CPU tensors
only. So on gloo with CUDA tensors, and only for those three ops, the
tensor is copied to the host, exchanged, and copied back to the card; the
compute stays on the card. That is how several ranks share one card
(NCCL refuses two ranks on one device). Any other pair of backend and
device that cannot run an op raises; nothing falls back silently.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device="cuda") -> None:
    """Join the process group (idempotent; a no-op at world size 1, as
    JAX's ``init_distributed``, mesh.py:30-48). Nothing tells a program of
    a cluster here: pass ``init_method`` (``tcp://host:port`` or
    ``file://path``), ``world_size`` and ``rank``; ``backend`` defaults to
    ``default_backend(device)``."""
    if world_size is not None and world_size <= 1:
        return
    if dist.is_initialized():
        return
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method, world_size=world_size,
                            rank=rank)


class AxisGroup:
    """One axis of the mesh as this rank sees it: its ``size``, this rank's
    ``index`` along it and the process group of the ranks that share the
    other axis' index (None without a process group: size 1, and every
    collective is the identity). The collectives keep the group's rank
    order, which is the index order."""

    def __init__(self, name: str, size: int, index: int, group):
        self.name, self.size, self.index, self.group = name, size, index, group

    def __repr__(self) -> str:
        return f"AxisGroup({self.name!r}, size={self.size}, index={self.index})"

    def _backend(self, t: torch.Tensor, op: str) -> str:
        backend = dist.get_backend(self.group)
        if backend == "gloo" or (backend == "nccl" and t.is_cuda):
            return backend
        raise RuntimeError(f"{op}: the {backend} backend cannot take "
                           f"{t.device.type} tensors")

    def _host(self, t: torch.Tensor, op: str) -> bool:
        """Whether ``op`` stages ``t`` through the host: gloo with a CUDA
        tensor, for the ops gloo runs on CPU tensors only."""
        return self._backend(t, op) == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, in place (gloo and NCCL take CUDA
        tensors). Every rank gets the same bits."""
        if self.group is not None:
            self._backend(t, "all_reduce")
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on all), in index
        order, on ``t``'s device."""
        if self.group is None:
            return [t]
        host = self._host(t, "all_gather")
        x = t.detach().cpu() if host else t.detach().contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return [o.to(t.device) for o in out] if host else out

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``t`` to index + ``step`` and return what index - ``step``
        sent (cyclic): ``lax.ppermute`` over the ring."""
        if self.group is None or self.size == 1:
            return t
        host = self._host(t, "shift")
        x = t.detach().cpu() if host else t.detach().contiguous()
        out = torch.empty_like(x)
        ranks = dist.get_process_group_ranks(self.group)
        ops = [dist.P2POp(dist.isend, x, ranks[(self.index + step)
                                              % self.size], self.group),
               dist.P2POp(dist.irecv, out, ranks[(self.index - step)
                                                 % self.size], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(t.device) if host else out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Index ``src``'s ``t`` on every rank, in place (gloo and NCCL take
        CUDA tensors)."""
        if self.group is not None:
            self._backend(t, "broadcast")
            # a bool tensor travels as its bytes
            x = t.view(torch.uint8) if t.dtype == torch.bool else t
            dist.broadcast(x, dist.get_process_group_ranks(self.group)[src],
                           group=self.group)
        return t


class Mesh:
    """('data', 'tile') over the ranks, data-major. ``shape`` maps each axis
    to its size (as ``jax.sharding.Mesh.shape``); ``axis(name)`` is this
    rank's ``AxisGroup`` along it, ``world`` the group of every rank."""

    def __init__(self, data: int, tile: int):
        initialized = dist.is_initialized()
        n = dist.get_world_size() if initialized else 1
        rank = dist.get_rank() if initialized else 0
        if data < 1 or tile < 1 or data * tile != n:
            raise ValueError(f"a ({data}, {tile}) mesh needs {data * tile} "
                             f"ranks; the world has {n}")
        self.shape = {"data": data, "tile": tile}
        self.rank = rank
        d, t = divmod(rank, tile)
        groups = {"data": None, "tile": None}
        world = None
        if initialized:
            world = dist.group.WORLD
            # every rank creates every group, in the same order
            for i in range(data):
                g = dist.new_group([i * tile + j for j in range(tile)])
                if i == d:
                    groups["tile"] = g
            for j in range(tile):
                g = dist.new_group([i * tile + j for i in range(data)])
                if j == t:
                    groups["data"] = g
        self._axes = {"data": AxisGroup("data", data, d, groups["data"]),
                      "tile": AxisGroup("tile", tile, t, groups["tile"])}
        self.world = AxisGroup("world", n, rank, world)

    def axis(self, name: str) -> AxisGroup:
        return self._axes[name]


def make_mesh(data: int | None = None, tile: int | None = None) -> Mesh:
    """A ('data', 'tile') mesh over every rank (mesh.py:84-99): ``data``
    defaults to 2 when the rank count is even and above 1, else 1, and
    ``tile`` to the rest."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = 2 if (n % 2 == 0 and n > 1) else 1
    if tile is None:
        tile = n // data
    return Mesh(data, tile)


def make_host_mesh(data: int | None = None) -> Mesh:
    """A mesh with the hosts on the data axis (mesh.py:51-66): ``data``
    defaults to the number of hosts, so each host holds one data replica
    and its ranks form the tile axis. The ranks of a host must be
    consecutive (as a launcher numbers them)."""
    hosts = [socket.gethostname()]
    if dist.is_initialized():
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
    runs = [h for i, h in enumerate(hosts) if i == 0 or h != hosts[i - 1]]
    if len(runs) != len(set(hosts)):
        raise ValueError(f"the ranks of a host are not consecutive: {hosts}")
    return make_mesh(data or len(runs))


def broadcast_tree(tensors, mesh: Mesh, src: int = 0):
    """Every rank's tensors set to rank ``src``'s, in place: the
    counterpart of ``make_global_tree`` (mesh.py:69-81), which builds a
    replicated array from a value that every process holds."""
    with torch.no_grad():
        for t in tensors:
            mesh.world.broadcast(t, src)
    return tensors


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous share of a batch along its leading axis, the
    data axis' block of ``P('data')`` (mesh.py:116-118)."""
    D, d = mesh.shape["data"], mesh.axis("data").index
    B = len(batch)
    if B % D:
        raise ValueError(f"a batch of {B} does not divide the data axis "
                         f"size {D}")
    b = B // D
    return batch[d * b:(d + 1) * b]
