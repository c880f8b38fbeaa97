"""Device mesh, sharding policy and data parallelism over
`torch.distributed` (the port's counterpart of the JAX package's
`parallel/mesh.py`).

JAX drives every device of a mesh from one process; PyTorch runs one
process per rank. So a mesh here is a small object of named axes over the
ranks of the world, with one process group (`dist.new_group`) per axis:
the ranks that share every other coordinate. The names are JAX's, so each
counterpart can be found. With no mesh, or a world of one rank, every path
of the port is the one-device path.

Data parallelism is exact, as JAX's `data_parallel_jit` is (one global
program over the global batch): every rank collates the same global batch,
takes its contiguous rows (`shard_batch`), and the steps divide every loss
term by its denominator over the GLOBAL batch (an all-reduce of the masks'
sums), so that each rank's loss is its share of the global loss; the
gradients are then summed over the ranks before the clip and AdamW
(`all_reduce_grads`). A mean of per-rank means would differ whenever the
ranks' lengths differ.

Collectives on the gloo backend are staged through host memory when the
tensor lies on a card: gloo runs on the CPU, and one card shared by
several ranks (NCCL refuses two ranks on one GPU) takes gloo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


class Mesh:
    """Named axes over ranks: `devices` holds the ranks of the world in
    row-major order (the last axis the fast one), `shape` maps each axis
    name to its size. Every rank of the world must build the same meshes
    in the same order (creating a process group is collective); a rank
    outside `devices` builds it and takes no part in it."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D ranks for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        self.coords = (None if len(where) == 0 else
                       dict(zip(self.axis_names, map(int, where[0]))))
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(
                -1, self.devices.shape[ax])
            for ranks in lines.tolist():
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = (group, ranks)
        ranks = self.devices.reshape(-1).tolist()
        group = dist.new_group(ranks)
        self._groups[None] = (group, ranks)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks {self.devices.tolist()})"

    def group(self, axis: Optional[str] = None):
        """The process group of this rank's line along `axis` (None: the
        whole mesh)."""
        return self._groups[axis][0]

    def ranks(self, axis: Optional[str] = None) -> list:
        """The global ranks of this rank's line along `axis`, in order."""
        return self._groups[axis][1]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (JAX `lax.axis_index`)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return int(self.shape[axis])

    def backend(self, axis: Optional[str] = None) -> str:
        return str(dist.get_backend(self.group(axis)))


# --- set-up ------------------------------------------------------------------

def init_multiprocess(init_method: str, world_size: int, rank: int,
                      backend: str, timeout: Optional[float] = None) -> None:
    """Join the process group (call once per process, before any mesh).
    `backend` is explicit: "nccl" for one card a rank, "gloo" on the CPU or
    for several ranks on one card. `init_method`: "env://" under torchrun,
    "tcp://localhost:<port>", or "file://<path>" (a FileStore).
    `timeout`: seconds a collective waits for the other ranks (torch's
    default when None)."""
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


def torchrun_mesh(device: Optional[str], backend: Optional[str],
                  enabled: bool = True):
    """The training apps' mesh and device: (mesh, torch.device).

    Outside torchrun (WORLD_SIZE unset or 1), or with `enabled` False
    (`--no-mesh`): no mesh, and `device` ("cuda" when None). Under
    torchrun: this rank's device is `device`, or cuda:LOCAL_RANK (one card
    a rank) when None; the process group is joined through torchrun's
    environment (`env://`) with `backend`, or NCCL on a card and gloo on
    the CPU when None, unless it is joined already; the mesh is
    `make_mesh()` over the world. Several ranks on one card need both
    given: e.g. `--device cuda:0 --dist-backend gloo` (NCCL refuses two
    ranks on one GPU)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or not enabled:
        return None, resolve_device(device or "cuda")
    dev = resolve_device(device or
                         f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        init_multiprocess("env://", world, int(os.environ["RANK"]),
                          backend or ("nccl" if dev.type == "cuda"
                                      else "gloo"))
    return make_mesh(), dev


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over ranks 0 .. n_devices - 1 of the world
    (all of them by default). torch has only the multi-process form, so
    this and `make_multiprocess_mesh` coincide."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh(n_devices={n}) in a world of {world}")
    return Mesh(np.arange(n), (DATA_AXIS,))


def make_multiprocess_mesh() -> Mesh:
    """The global 1-D data-parallel mesh over every rank of the world
    (needs `init_multiprocess` first): `make_mesh()`."""
    return make_mesh()


def make_mesh_2d(n_data: int, n_seq: int) -> Mesh:
    """2-D (data x seq) mesh: batch rows over `data`, and within each
    row-group one utterance's time axis over `seq` (`sp.sp_vocode(...,
    axis=SEQ_AXIS, batch_axis=DATA_AXIS)`); `seq` is the fast axis, so a
    row-group is consecutive ranks."""
    return _grid(n_data, n_seq, (DATA_AXIS, SEQ_AXIS), "make_mesh_2d")


def _grid(n0: int, n1: int, names, what: str) -> Mesh:
    world = dist.get_world_size()
    if world < n0 * n1:
        raise ValueError(f"{what}({n0}, {n1}) needs {n0 * n1} devices, "
                         f"got {world}")
    return Mesh(np.arange(n0 * n1).reshape(n0, n1), names)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """`with mesh_context(mesh) as m:`, as JAX's `with mesh:`; the port
    passes meshes explicitly, so this only yields it."""
    yield mesh


# --- collectives ---------------------------------------------------------------

def _staged(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """x as the axis's backend takes it: a host copy for gloo when x lies
    on a card."""
    if x.device.type != "cpu" and "gloo" in mesh.backend(axis):
        return x.detach().cpu()
    return x.detach().clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = DATA_AXIS,
               op: str = "sum") -> torch.Tensor:
    """x reduced over the ranks of `axis` (None: the whole mesh), as a new
    tensor on x's device; no gradient."""
    buf = _staged(x, mesh, axis)
    dist.all_reduce(buf, _OPS[op], group=mesh.group(axis))
    return buf.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the axis, on every rank. The gradient of the
    global loss (the sum of every rank's) with respect to this rank's x is
    the sum of every rank's gradient with respect to y."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """The sum of x over the ranks of `axis`, differentiable (BatchNorm's
    statistics over the global batch)."""
    return _AllReduceSum.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = DATA_AXIS,
               dim: int = 0) -> torch.Tensor:
    """Every rank's x along `axis`, concatenated along `dim` in the axis's
    order (equal shapes on every rank), on x's device; no gradient."""
    # as raw bytes: gloo does not take every dtype (int16 waves)
    buf = _staged(x, mesh, axis).contiguous()
    raw = buf.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in mesh.ranks(axis)]
    dist.all_gather(parts, raw, group=mesh.group(axis))
    parts = [q.view(buf.dtype).view(buf.shape) for q in parts]
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce_grads(params, mesh: Mesh,
                     axis: Optional[str] = DATA_AXIS) -> None:
    """Sum the gradients of `params` over the ranks of `axis`, in place.
    A parameter that has a gradient on some rank gets one on every rank
    (zeros where its rank's batch did not reach it, e.g. a critic that
    scored no chunk there); one without a gradient anywhere keeps None, as
    on one device (AdamW skips it)."""
    params = list(params)
    if not params:
        return
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.int32)
    has = all_reduce(has, mesh, axis, op="max").bool().tolist()
    for p, h in zip(params, has):
        if h and p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p, h in zip(params, has) if h]
    if not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def global_total(mesh: Optional[Mesh],
                 axis: str = DATA_AXIS) -> Callable:
    """A function from a local loss denominator (a sum of mask values) to
    its value over the global batch: an all-reduce on a mesh, the identity
    without one."""
    if mesh is None:
        return lambda x: x
    return functools.partial(all_reduce, mesh=mesh, axis=axis)


# --- sharding policy -----------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree, mesh: Mesh):
    """Make `tree` the same on every rank of the mesh: a module's
    parameters and buffers, a tensor, or a dict/list of them, broadcast in
    place from the mesh's first rank. Returns `tree`."""
    src = int(mesh.devices.reshape(-1)[0])

    def bcast(t):
        if isinstance(t, torch.nn.Module):
            for v in list(t.parameters()) + list(t.buffers()):
                bcast(v)
        elif isinstance(t, torch.Tensor):
            buf = _staged(t, mesh, None)
            dist.broadcast(buf, src, group=mesh.group(None))
            with torch.no_grad():
                t.copy_(buf)
        return t

    _tree_map(bcast, tree)
    return tree


def process_local_rows(global_batch: int, mesh: Mesh) -> slice:
    """The rows of a global batch that this rank holds: its contiguous
    share along the data axis (one process is one rank here, so JAX's
    process rows and device rows are the same)."""
    n = mesh.axis_size(DATA_AXIS)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"mesh[{DATA_AXIS!r}]={n}")
    per = global_batch // n
    i = mesh.axis_index(DATA_AXIS)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch: a dict (or list) of [B, ...]
    arrays or tensors, each cut along its leading axis."""
    rows = None

    def take(x):
        nonlocal rows
        if rows is None:
            rows = process_local_rows(len(x), mesh)
        return x[rows]

    return _tree_map(take, batch)


def shard_batch_from_process_local(local_batch, mesh: Mesh):
    """Each rank passes only its own rows, which already are its shard of
    the global batch: returned as they are (JAX assembles a global array
    from them). The mesh is checked to hold this rank."""
    mesh.axis_index(DATA_AXIS)
    return local_batch


def replicated(mesh: Mesh) -> Callable:
    """The replicated placement: a function that replicates a tree."""
    return functools.partial(replicate, mesh=mesh)


def batch_sharded(mesh: Mesh) -> Callable:
    """The batch-sharded placement: a function that takes this rank's
    rows of a global batch."""
    return functools.partial(shard_batch, mesh=mesh)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.size
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh size {n}")
    return global_batch // n


def pad_batch_to_devices(batch, mesh: Mesh):
    """Pad the leading axis of every array so that it divides the mesh
    size (a ragged final batch at inference); zeros fill the new rows."""
    n = mesh.size

    def pad(x):
        rem = (-len(x)) % n
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))

    return _tree_map(pad, batch)


def data_parallel_jit(step_fn: Callable, mesh: Mesh) -> Callable:
    """The data-parallel form of a train or eval step (JAX's
    `data_parallel_jit`; nothing is compiled here): the returned
    `step(state, batch, *args)` takes the GLOBAL batch, passes this rank's
    rows to `step_fn`, and gives a `state` with a `mesh` field (the
    port's `TrainState`) this mesh, from which the step's losses take their
    global denominators and its optimizers the summed gradients. The
    parameters must be replicated (`replicate`) beforehand."""

    def step(state, batch, *args, **kw):
        if dataclasses.is_dataclass(state) and hasattr(state, "mesh"):
            state.mesh = mesh
        return step_fn(state, shard_batch(batch, mesh), *args, **kw)

    return step
