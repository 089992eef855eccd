"""Particle meshes: a 1-D `particles` axis over devices.

Counterpart of bayesian_optimization_tpu/parallel/mesh.py. There a
population axis (acquisition restarts, CMA/SMC chains) sharded over a jax
Mesh makes XLA partition the program and insert the collectives. Here the
engines (optim/argmax.py) run each mesh entry's rows themselves, on that
entry's device, and call the mesh's `gather` where the JAX program has its
collective; `gathers` counts those calls.

A mesh may list a device more than once (`["cpu"] * 8`, `["cuda:0"] * 2`):
the split and the gather then run as on distinct devices, with one card or
none. Under `torch.distributed` (parallel/distributed.py) the mesh spans
every process's devices; each process runs the entries it owns and `gather`
is an `all_gather`, so every process ends with the whole population.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .._device import require_cuda

PARTICLE_AXIS = "particles"


def put(tree, device: torch.device):
    """`tree` (a tensor, or a NamedTuple, tuple, list or dict of them; other
    leaves pass unchanged) with every tensor on `device`."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(put(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(put(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: put(v, device) for k, v in tree.items()}
    return tree


class ParticleMesh:
    """A 1-D mesh: `devices` (one per entry, repeats allowed) along the
    axis `PARTICLE_AXIS`; `owners[i]` is the process rank that runs entry i
    (all 0 outside torch.distributed), and `rank` this process's."""

    def __init__(self, devices: Sequence, owners: Optional[Sequence[int]] = None, rank: int = 0):
        # "cuda" names the first card, as torch.device("cuda", 0)
        self.devices = tuple(torch.device(d.type, d.index or 0) if d.type == "cuda" else d
                             for d in map(torch.device, devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.owners = tuple(int(r) for r in owners) if owners is not None else (0,) * len(self.devices)
        if len(self.owners) != len(self.devices) or list(self.owners) != sorted(self.owners):
            raise ValueError("owners must name one rank per device, in rank order")
        self.rank = int(rank)
        self.local = tuple(i for i, r in enumerate(self.owners) if r == self.rank)
        if not self.local:
            raise ValueError(f"rank {self.rank} owns no entry of the mesh")
        self.axis_names = (PARTICLE_AXIS,)
        self.gathers = 0  # calls of `gather`: the collectives of the JAX program

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's first device: where gathered tensors land."""
        return self.devices[self.local[0]]

    @property
    def distributed(self) -> bool:
        return len(set(self.owners)) > 1

    def __repr__(self) -> str:
        return f"ParticleMesh({[str(d) for d in self.devices]}, axis={PARTICLE_AXIS!r})"

    def split(self, x: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, ...]:
        """This process's chunks of x along `dim` (a multiple of the mesh
        size), each on its entry's device."""
        if x.shape[dim] % self.size:
            raise ValueError(f"axis of {x.shape[dim]} rows is not a multiple of the mesh size {self.size}")
        chunks = torch.chunk(x, self.size, dim=dim)
        return tuple(chunks[i].to(self.devices[i]) for i in self.local)

    def per_entry(self, value) -> list:
        """One item per local entry: a list or tuple as given, anything
        else (an objective, a bound) repeated."""
        if isinstance(value, (list, tuple)):
            if len(value) != len(self.local):
                raise ValueError(f"{len(value)} items for {len(self.local)} local mesh entries")
            return list(value)
        return [value] * len(self.local)

    def map(self, fn: Callable, *per_entry) -> list:
        """[fn(*args_i) for each local entry i, in turn], args_i the i-th
        item of each sequence in per_entry, with the entry's card current.
        The entries run one after another from this thread: their launches
        are asynchronous, so two cards' work overlaps only while fn does
        not wait on the host (an L-BFGS lane does, every trip)."""
        out = []
        for i, args in zip(self.local, zip(*per_entry)):
            dev = self.devices[i]
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                out.append(fn(*args))
        return out

    def gather(self, *fields):
        """The whole population of each field, on `device`: each field a
        sequence of this process's chunks (rows leading, in mesh order). One
        call is one collective, whatever the number of fields (they are
        packed into one buffer across processes, so they share a dtype)."""
        self.gathers += 1
        local = [torch.cat([c.to(self.device) for c in chunks]) for chunks in fields]
        if not self.distributed:
            return local
        import torch.distributed as dist

        flat = [t.reshape(t.shape[0], -1) for t in local]
        buf = torch.cat(flat, dim=1)
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, buf)
        full = torch.cat(parts)
        out, col = [], 0
        for t, f in zip(local, flat):
            out.append(full[:, col:col + f.shape[1]].reshape((-1,) + t.shape[1:]))
            col += f.shape[1]
        return out


class Sharding(NamedTuple):
    """How a value lies on a mesh: `spec` ("particles",) splits its leading
    axis over the entries, () copies it whole to each entry's device."""

    mesh: ParticleMesh
    spec: tuple

    def put(self, tree) -> tuple:
        """One value per local entry: the entry's rows, or a copy of tree."""
        if self.spec == (PARTICLE_AXIS,):
            return self.mesh.split(tree)
        copies = {}
        for i in self.mesh.local:
            dev = self.mesh.devices[i]
            if dev not in copies:
                copies[dev] = put(tree, dev)
        return tuple(copies[self.mesh.devices[i]] for i in self.mesh.local)


class ShardedPopulation(NamedTuple):
    """A population padded to a multiple of the mesh size: `shape` is the
    padded global shape, `chunks` this process's rows, one per local entry,
    each on its entry's device."""

    chunks: tuple
    shape: tuple
    spec: tuple
    mesh: ParticleMesh


def make_particle_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> ParticleMesh:
    """1-D mesh over every CUDA device (or the first n), or over `devices`,
    which may repeat one; without `devices` a missing GPU raises."""
    if devices is None:
        require_cuda()
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return ParticleMesh(devs)


def particle_sharding(mesh: ParticleMesh) -> Sharding:
    """Split the leading (population) axis across the mesh."""
    return Sharding(mesh, (PARTICLE_AXIS,))


def replicated(mesh: ParticleMesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, k: int) -> int:
    return int(-(-n // k) * k)


def as_population(x) -> ShardedPopulation:
    """x itself if sharded, else the (P, d) tensor x as the population of
    the one-entry mesh on its device: the engines' unsharded run."""
    if isinstance(x, ShardedPopulation):
        return x
    return shard_population(x, ParticleMesh([x.device]))


def shard_population(x: torch.Tensor, mesh: ParticleMesh) -> ShardedPopulation:
    """x with its leading axis padded with zeros to a multiple of the mesh
    size, as the JAX function pads it (the padded rows are lanes of their
    own: an argmax runs them from the origin), then split over the mesh."""
    x = torch.as_tensor(x)
    n_pad = pad_to_multiple(x.shape[0], mesh.size)
    if n_pad != x.shape[0]:
        x = torch.cat([x, x.new_zeros((n_pad - x.shape[0],) + tuple(x.shape[1:]))])
    return ShardedPopulation(particle_sharding(mesh).put(x), tuple(x.shape), (PARTICLE_AXIS,), mesh)
