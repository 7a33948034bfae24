"""A named grid of ranks over ``torch.distributed``: the port's counterpart
of the ``jax.sharding.Mesh`` that every function of the JAX package's
``parallel/`` takes.

One process is one rank and one device. A ``Mesh`` lays the ranks of the
default process group out row-major over named axes, for example
``("dp", "sp")`` of shape (2, 2): rank = i_dp * 2 + i_sp. For every axis
it makes one process group per line of ranks along that axis
(``torch.distributed.new_group``), so ``mesh.group("sp")`` is this rank's
sp group, ``mesh.index(axis)`` its position on the axis (JAX's
``lax.axis_index``) and ``mesh.size(axis)`` the axis length.

The collectives below run on the backend of the default group:

- NCCL takes the device tensors as they are, and its collectives can be
  recorded inside a CUDA graph;
- gloo works on host memory: a CUDA tensor is copied to the host, reduced
  or sent there, and copied back. That synchronises with the host, so a
  step that issues a gloo collective cannot be recorded. On gloo a group
  of one rank issues nothing (the collective is the identity), which
  keeps a step over a one-rank axis recordable.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of the default process group, and this
    rank's ``device``. Every rank must build the same mesh, in the same
    order as any other groups it makes."""

    def __init__(self, shape, axis_names, device):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} do not match")
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "parallel.distributed.initialize first")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{world}")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        coords = []
        r = self.rank
        for s in reversed(shape):
            coords.append(r % s)
            r //= s
        self._coords = dict(zip(axis_names, reversed(coords)))
        strides = [math.prod(shape[a + 1:]) for a in range(len(shape))]
        self._ranks, self._groups = {}, {}
        for a, name in enumerate(axis_names):
            # every line of ranks along axis a, in one order on every rank
            others = [n for n in range(len(shape)) if n != a]
            for flat in range(world // shape[a]):
                base, rest = 0, flat
                for n in reversed(others):
                    base += (rest % shape[n]) * strides[n]
                    rest //= shape[n]
                ranks = [base + i * strides[a] for i in range(shape[a])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._ranks[name], self._groups[name] = ranks, group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self._coords[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def ranks(self, axis: str) -> list:
        """The global ranks of this rank's group along ``axis``, by index."""
        return self._ranks[axis]

    @property
    def host_staged(self) -> bool:
        """Whether collectives go through host memory (gloo)."""
        return self.backend != "nccl"

    def _skip(self, axis):
        return self.host_staged and self.size(axis) == 1

    def _wire(self, t):
        return t.cpu() if self.host_staged else t

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over the ranks of ``axis``, in place."""
        if self._skip(axis):
            return t
        w = self._wire(t)
        dist.all_reduce(w, group=self.group(axis))
        if w is not t:
            t.copy_(w)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` (one shape on every rank) concatenated along
        dim 0 in axis order, on ``t``'s device."""
        if self._skip(axis):
            return t
        w = self._wire(t.contiguous())
        parts = [torch.empty_like(w) for _ in range(self.size(axis))]
        dist.all_gather(parts, w, group=self.group(axis))
        return torch.cat(parts).to(t.device)

    def exchange(self, sends: dict, recvs: dict, axis: str) -> dict:
        """Point-to-point along ``axis``: ``sends`` maps a peer's index to
        the tensor sent to it, ``recvs`` a peer's index to an empty tensor
        of the shape, dtype and device it sends. Returns ``recvs`` filled.
        Every pair of ranks must post matching sends and receives."""
        ranks = self.ranks(axis)
        wires = {i: self._wire(t.contiguous()) for i, t in sends.items()}
        inbox = {i: self._wire(t) for i, t in recvs.items()}
        ops = ([dist.P2POp(dist.isend, w, ranks[i])
                for i, w in sorted(wires.items())]
               + [dist.P2POp(dist.irecv, w, ranks[i])
                  for i, w in sorted(inbox.items())])
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for i, t in recvs.items():
            if inbox[i] is not t:
                t.copy_(inbox[i])
        return recvs

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, backend="
                f"{self.backend}, device={self.device})")
