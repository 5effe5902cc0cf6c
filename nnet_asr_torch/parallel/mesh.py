"""The (data, model) device mesh over torch.distributed (port of
nnet_asr_tpu/parallel/mesh.py).

JAX drives a whole mesh from one process with ``shard_map``; here a rank is
a process and holds one device: ``cuda:(LOCAL_RANK % device_count)``, or
the CPU when the caller names it. Ranks are launched by ``torchrun
--nproc-per-node=D*M`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``); a 1x1 mesh with no
launcher forms a one-rank group itself. Rank ``r`` sits at data index
``r // M`` and model index ``r % M``, the layout of
``init_device_mesh((D, M), mesh_dim_names=("data", "model"))``; the two
axis groups are made with ``new_group``, which both backends carry.

Backend: ``nccl`` when every rank of the node has a card of its own,
``gloo`` on the CPU and when ranks share a card (NCCL refuses two ranks on
one GPU). The choice is made from the rank and device counts before the
group forms; an NCCL failure is never caught to switch backends.

The collectives the port uses are ``all_reduce`` (SUM, MAX, MIN),
``all_gather``, ``broadcast`` and ``barrier``, all on one axis group; a
collective over an axis of size 1 is skipped, so a 1x1 mesh computes
exactly what one device does.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

DEFAULT_TIMEOUT = timedelta(minutes=5)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# one Mesh per (data, model, device) in a process: new_group is collective
# and the process group is process-wide state already
_MESHES: Dict[Tuple[int, int, str], "Mesh"] = {}


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` by default
    (raising without CUDA, as ``resolve_device`` does), else ``device``."""
    if device is not None:
        return resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return resolve_device(local_rank % max(torch.cuda.device_count(), 1))


def choose_backend(device: torch.device, world: int) -> str:
    """``nccl`` when every rank on this node has a card of its own, else
    ``gloo`` (with a line on stderr when ranks share a card)."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local <= torch.cuda.device_count():
        return "nccl"
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        shared = "cuda:0" if torch.cuda.device_count() == 1 else \
            f"{torch.cuda.device_count()} cards"
        print(f"[mesh] {local} ranks share {shared}: collectives over gloo",
              file=sys.stderr, flush=True)
    return "gloo"


def init_process_group(device: torch.device, init_method: Optional[str] = None,
                       timeout: timedelta = DEFAULT_TIMEOUT) -> str:
    """Form the world group from the launcher's ``RANK``/``WORLD_SIZE``
    (``init_method`` defaults to ``env://``; the tests pass ``file://``);
    one rank with no launcher gets a group of its own. Returns the backend.
    ``timeout`` bounds every collective, so a lost rank raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    backend = choose_backend(device, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world == 1 and init_method is None and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, timeout=timeout)
    return backend


class Mesh:
    """This rank's view of a (data, model) mesh: ``shape["data"/"model"]``,
    its coordinates, its device and the collectives over each axis
    (``"data"``, ``"model"`` or ``"world"``, JAX's ``("data", "model")``)."""

    def __init__(self, data: int, model: int, device: torch.device):
        self.shape = {"data": data, "model": model}
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, model)
        self.device = device
        self.backend = dist.get_backend()
        # every rank makes every group, in one order: new_group is collective
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        self._groups = {"data": data_groups[self.model_index],
                        "model": model_groups[self.data_index],
                        "world": dist.group.WORLD}
        self._sizes = {"data": data, "model": model, "world": data * model}

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints and writes files."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self._sizes[axis]

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows sharded over ``data`` (JAX ``P("data")``)."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"{n} rows not divisible by the data axis {d}")
        b = n // d
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def all_reduce(self, t: torch.Tensor, axis: str = "data", op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` in place (``psum``/``pmax``/``pmin``)."""
        if self._sizes[axis] > 1:
            dist.all_reduce(t, _OPS[op], group=self._groups[axis])
        return t

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """Sums of ``tensors`` (one dtype) over ``axis`` through one
        all_reduce of their concatenation."""
        if self._sizes[axis] == 1 or not tensors:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=self._groups[axis])
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The axis' blocks of ``t`` (equal shapes) concatenated along
        ``dim`` in rank order (``all_gather(tiled=True)``)."""
        n = self._sizes[axis]
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from world rank ``src``, in place."""
        if self._sizes["world"] > 1:
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self._sizes["world"] > 1:
            dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")


def make_mesh(data: Optional[int] = None, model: int = 1, device: DeviceLike = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's (data, model) mesh; ``data=None`` takes every rank.
    Forms the process group first if none exists (``init_process_group``).
    The world size must equal ``data * model``."""
    n = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} needs WORLD_SIZE {data * model}, "
                         f"the launcher started {n} ranks")
    dev = rank_device(device)
    key = (data, model, str(dev))
    if key not in _MESHES:
        if not dist.is_initialized():
            init_process_group(dev, timeout=timeout)
        _MESHES[key] = Mesh(data, model, dev)
    return _MESHES[key]


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` (or ``"D"``) of ``--MESH`` as (data, model)."""
    d, _, m = spec.lower().partition("x")
    return int(d), int(m) if m else 1


def quiet_unless_rank0() -> None:
    """Send a non-zero rank's standard output to /dev/null (a launcher's
    ``RANK``), so a tool's log lines come from rank 0 alone."""
    if int(os.environ.get("RANK", "0")) != 0:
        sys.stdout = open(os.devnull, "w")
