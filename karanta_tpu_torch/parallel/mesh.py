"""Process mesh over ``torch.distributed`` (port of
``karanta_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with named
axes and lets XLA insert the collectives. Here every rank is one process;
``create_mesh`` gives each rank its coordinates on the same named axes and
one process group per axis in use, and the model code calls the collectives
itself (``parallel/sharding.py``).

Axis conventions (the JAX package's):
  "data"  - batch / decode-slot sharding (DP). Replicated params.
  "fsdp"  - parameter and optimizer sharding (ZeRO-like). Training only.
  "seq"   - sequence/context parallelism for training activations.
  "pipe"  - pipeline-parallel stage axis.
  "model" - tensor-parallel axis (Megatron-style qkv/mlp sharding).

Rank order is (data, pipe, fsdp, seq, model), row-major: "model" is the
innermost axis, so a tensor-parallel group is a run of consecutive ranks
(the JAX layout puts it on neighbouring chips for the same reason: it
carries the chattiest collectives).

Backend: ``nccl`` when every rank has a card of its own, ``gloo`` when
ranks share a card or run on the CPU. NCCL refuses two ranks on one device;
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` by staging them
through the host, so the same code runs on one card, at the cost of a host
round trip per collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import math
from typing import Optional

import torch
import torch.distributed as dist

from karanta_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXIS_NAMES = (DATA_AXIS, PIPE_AXIS, FSDP_AXIS, SEQ_AXIS, MODEL_AXIS)

# a rank that waits longer than this for its peers raises instead of hanging
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 in exactly one field means "absorb the rest".

    Field order keeps (data, fsdp, model) positional compatibility; the rank
    layout is always (data, pipe, fsdp, seq, model)."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        dims = [self.data, self.pipe, self.fsdp, self.seq, self.model]
        free = [i for i, d in enumerate(dims) if d == -1]
        if len(free) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {dims}")
        fixed = math.prod(d for d in dims if d != -1)
        if free:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            dims[free[0]] = n_devices // fixed
        if math.prod(dims) != n_devices:
            raise ValueError(
                f"Mesh {tuple(dims)} does not cover {n_devices} devices"
            )
        return tuple(dims)  # type: ignore[return-value]

    @property
    def layout_dims(self) -> tuple[int, int, int, int, int]:
        return (self.data, self.pipe, self.fsdp, self.seq, self.model)


@dataclasses.dataclass
class Mesh:
    """This rank's place on the mesh: its world rank, its coordinate on each
    axis, the process group of each axis of size > 1 (None where the axis
    has size 1: a collective over it is the identity), the world group, a
    gloo group over the world for host objects, the backend and the device."""

    rank: int
    dims: dict                       # axis -> size
    coords: dict                     # axis -> this rank's index
    groups: dict                     # axis -> ProcessGroup or None
    world_group: Optional[object]    # None for a one-rank mesh
    cpu_group: Optional[object]      # gloo, for broadcast_objects
    backend: Optional[str]
    device: torch.device

    @property
    def world(self) -> int:
        return math.prod(self.dims.values())

    def size(self, axis: str) -> int:
        return self.dims[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def rank_of(self, **coords) -> int:
        """World rank at the given coordinates (missing axes at 0)."""
        rank = 0
        for axis in AXIS_NAMES:
            rank = rank * self.dims[axis] + coords.get(axis, 0)
        return rank


def choose_backend(world: int, device_type: str) -> str:
    """nccl when each of `world` ranks has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """Rank r's device: cuda:(r % cards), or the CPU when the caller asks."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: DeviceLike = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> Optional[str]:
    """Join the process group (no-op for one process). `coordinator_address`
    is host:port (``tcp://`` is prepended) or a full init URL such as
    ``file:///path``. The backend defaults to ``choose_backend``; the
    choice is logged and returned."""
    if num_processes is None or num_processes <= 1:
        return None
    if backend is None:
        dev_type = torch.device(device).type if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
        backend = choose_backend(num_processes, dev_type)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("rank %d of %d joined over %s (%s)", process_id,
                num_processes, backend, url)
    return backend


def create_mesh(config: Optional[MeshConfig] = None,
                device: DeviceLike = None) -> Mesh:
    """This rank's mesh over the initialised process group (or a one-rank
    mesh when there is none). Every rank must call it, in the same order
    relative to its other group creations: it creates one group per line of
    every axis of size > 1."""
    config = config or MeshConfig()
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    sizes = config.resolve(world)
    dims = dict(zip(AXIS_NAMES, sizes))
    coords, rest = {}, rank
    for axis, n in reversed(list(zip(AXIS_NAMES, sizes))):
        coords[axis] = rest % n
        rest //= n
    coords = {axis: coords[axis] for axis in AXIS_NAMES}
    groups = {axis: None for axis in AXIS_NAMES}
    world_group = cpu_group = backend = None
    if initialised and world > 1:
        backend = dist.get_backend()
        world_group = dist.group.WORLD
        cpu_group = (world_group if backend == "gloo"
                     else dist.new_group(backend="gloo"))
        for k, axis in enumerate(AXIS_NAMES):
            if sizes[k] == 1:
                continue
            others = [range(n) if j != k else range(1)
                      for j, n in enumerate(sizes)]
            for base in itertools.product(*others):
                ranks = []
                for i in range(sizes[k]):
                    c = list(base)
                    c[k] = i
                    r = 0
                    for j, n in enumerate(sizes):
                        r = r * n + c[j]
                    ranks.append(r)
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's collectives run on this card
    return Mesh(rank=rank, dims=dims, coords=coords, groups=groups,
                world_group=world_group, cpu_group=cpu_group,
                backend=backend, device=dev)
