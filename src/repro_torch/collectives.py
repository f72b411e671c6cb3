"""Collectives over ``torch.distributed`` process groups, for the pipeline
engine on ranks (``pipeline/pipeline_step.py`` with a
``launch/mesh.RankMesh``) and the tensor-parallel blocks (``models/tp.py``).

The JAX engine runs one SPMD body per device under ``shard_map`` and
communicates with ``psum``, ``pmax``, ``all_gather(tiled=True)`` and
``ppermute``. Here each mesh position is a process, and these functions
are the same operations over the process group of a mesh axis (or of
several axes, ``RankMesh.group``). A group of one rank, or ``None``, makes
every operation the identity: no call is made, so a one-rank mesh
computes bit for bit what the folded engine computes.

Every result is a new tensor; no collective writes a tensor passed in
(``dist.all_reduce`` works in place, JAX's ``psum`` returns a new array,
and the engine's params and stash share tensors).

**Gradients.** ``psum`` and ``all_gather`` are ``torch.autograd.Function``s
whose backward is the exact adjoint of the forward over all ranks: a
``psum`` of the cotangents, and a ``psum`` followed by the rank's own
slice. That is the transpose JAX gives ``psum`` inside ``shard_map`` with
replication unchecked, where the engine's bodies run. It differentiates
the SUM over ranks of what each rank computes, so a value every rank holds
a copy of would count once per copy; the engine therefore seeds each
rank's backward with 1 / (number of ranks), as ``shard_map``'s transpose
divides a replicated output's cotangent by the size of the axes it is
replicated over, and sums a replicated leaf's gradient over the ranks that
hold it (``pipeline/pipeline_step.py``). The tests hold the gradients to
the JAX engine's (``tests/test_torch_ranks.py``).

**Host staging.** gloo takes only CPU tensors for point-to-point
``send``/``recv``. Where the group's backend is gloo and the tensor lies
on CUDA, those two are staged through a host copy on purpose, and
``HOST_STAGED`` counts the calls and bytes by operation, so a caller can
say what went through the host. Nothing else is staged, and nothing falls
back: NCCL gets the CUDA tensors, gloo the CPU ones.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# operation -> [calls, bytes] staged through the host (gloo + CUDA)
HOST_STAGED: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])


def reset_host_staged():
    HOST_STAGED.clear()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(op: str, t: torch.Tensor):
    rec = HOST_STAGED[op]
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over ``group``, as a new tensor; no
    gradient."""
    if group_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum`` over ``group``; its backward is a ``psum`` of the
    cotangents."""
    if group_size(group) == 1:
        return x
    return _PSum.apply(x.contiguous(), group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.pmax`` of a value that carries no gradient."""
    return all_reduce(x.detach(), group, op="max")


def _gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis, ctx.n = group, axis, x.shape[axis]
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group)
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, i * ctx.n, ctx.n).contiguous(), None, None


def all_gather(x: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis=axis, tiled=True)`` over ``group``: the
    ranks' blocks concatenated along ``axis`` in group order. Its backward
    sums the cotangents over the group and keeps the rank's block."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, axis % x.ndim)


def gather(x: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """``all_gather`` without a gradient."""
    if group_size(group) == 1:
        return x
    return _gather(x.detach(), group, axis % x.ndim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """A new tensor holding global rank ``src``'s ``x`` on every rank of
    ``group`` (``x`` gives the shape and dtype elsewhere); no gradient."""
    if group_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.broadcast(out, src=src, group=group)
    return out


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        return broadcast(x, src, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group)
        return (g if dist.get_rank() == ctx.src else None), None, None


def broadcast_grad(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``broadcast`` whose backward sums the cotangents over the group
    into ``src``'s ``x`` (the adjoint of the copy). Every rank passes an
    ``x`` that requires grad, so every rank takes part in the backward."""
    if group_size(group) == 1:
        return x
    return _Broadcast.apply(x, src, group)


def send(x: torch.Tensor, dst: int, group=None) -> list:
    """Start sending ``x`` to global rank ``dst``; returns what the
    caller keeps until ``wait_all``: the work handle and the buffer."""
    buf = x.detach().contiguous()
    if _staged(buf, group):
        _count("send", buf)
        buf = buf.cpu()
    return [dist.isend(buf, dst, group=group), buf]


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A new tensor of ``like``'s shape, dtype and device, received from
    global rank ``src``."""
    out = torch.empty_like(like)
    if _staged(out, group):
        _count("recv", out)
        host = torch.empty_like(out, device="cpu")
        dist.recv(host, src, group=group)
        return out.copy_(host)
    dist.recv(out, src, group=group)
    return out


def wait_all(pending: list):
    for work, _ in pending:
        work.wait()
    pending.clear()
