"""Collective communication (port of
``paddle_tpu.distributed.communication``, as far as the trainer needs
it), over ``torch.distributed``.

The Paddle-style API: ``all_reduce`` (in place), ``all_gather``,
``reduce_scatter``, ``broadcast``, ``send``, ``recv``,
``batch_isend_irecv`` with ``P2POp``, and ``barrier``.
``group`` is a ``ProcessGroup`` (``Mesh.group``) or None for the whole
world; peers (``src``, ``dst``) are global ranks. Outside an initialised
world every collective is the identity, as in the JAX package's
single-process world. ``ReduceOp.AVG`` is a sum divided by the group's
size on every backend.

The explicit tensor parallelism of the GPT and LLaMA cores and ZeRO-3
need collectives that autograd can see, Megatron's pair and the ZeRO
gather (``group`` None there is a group of one rank: the identity):

- :func:`copy_to`: identity forward, all-reduce backward;
- :func:`reduce_from`: all-reduce forward, identity backward;
- :func:`gather_dim`: all-gather along a dim forward, reduce-scatter
  (sum) backward.

Every collective and point-to-point batch runs inside
``collective_runtime.collective_span`` (its op's calls and bytes
counters, a ``collective:<op>`` host span, a flight-recorder record), as
the JAX package's do; the autograd forms count as the collective they
run (``all_reduce``, ``all_gather``, ``reduce_scatter``).

Host staging: gloo runs all-reduce, broadcast, all-gather and
reduce-scatter on CUDA tensors, but a send or receive of one aborts the
process. The point-to-point calls (``send``, ``recv``,
``batch_isend_irecv``, ``ring_shift``) therefore take
``host_staged``, which the caller sets from ``Mesh.host_staged`` (gloo
ranks on a CUDA device): with it, a CUDA operand is copied into pinned
host memory, sent or received there, and copied back; without it, a
CUDA send or receive over gloo raises rather than pick the copy
silently.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from ..collective_runtime import collective_span

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "barrier", "send", "recv", "P2POp",
           "batch_isend_irecv", "copy_to", "reduce_from",
           "gather_dim", "scatter_dim", "all_gather_dim", "ring_shift"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(tensor, group, host_staged: bool) -> bool:
    """Whether a send or receive of ``tensor`` over ``group`` goes
    through pinned host buffers: gloo with a CUDA tensor, which the
    caller must have allowed (``host_staged``), else it raises."""
    if not tensor.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if not host_staged:
        raise RuntimeError(
            "send/recv: gloo has no CUDA send or receive; pass "
            "host_staged=True (Mesh.host_staged) to copy through pinned "
            "host buffers")
    return True


def _to_host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over ``group`` in place; returns it."""
    if not _live():
        return tensor
    with collective_span("all_reduce", tensor):
        dist.all_reduce(tensor, op=_TORCH_OPS[op], group=group)
    if op == ReduceOp.AVG:
        tensor.div_(_size(group))
    return tensor


def _gather0(tensor, group):
    """The group's tensors stacked along a new leading dim."""
    n = _size(group)
    src = tensor.contiguous()[None]        # concatenated along dim 0
    out = torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with collective_span("all_gather", src):
        dist.all_gather_into_tensor(out, src, group=group)
    return out


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``: appended to ``tensor_list`` when it is a
    list (returned), else stacked along a new leading dim."""
    out = _gather0(tensor, group) if _live() else tensor[None]
    if isinstance(tensor_list, list):
        tensor_list.extend(out.unbind(0))
        return tensor_list
    return out


def _reduce_scatter0(stacked, group):
    """``stacked`` ``(n, ...)`` summed over the group; this rank's row."""
    src = stacked.contiguous()
    out = torch.empty((1,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with collective_span("reduce_scatter", src):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out[0]


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` := the sum over the group of each rank's
    ``tensor_list[my index]``; returns it."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"reduce_scatter op {op}")
    if not _live():
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    out = _reduce_scatter0(torch.stack(list(tensor_list)), group)
    if op == ReduceOp.AVG:
        out = out / _size(group)
    tensor.copy_(out)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` := global rank ``src``'s, in place."""
    if _live():
        with collective_span("broadcast", tensor):
            dist.broadcast(tensor, src=src, group=group)
    return tensor


def barrier(group=None):
    if _live():
        with collective_span("barrier"):
            dist.barrier(group=group)


class _Staged:
    """A send from or a receive into pinned host memory, which it keeps
    alive; ``wait`` copies a received tensor home."""

    def __init__(self, work, host, dest=None):
        self.work, self.host, self.dest = work, host, dest

    def wait(self):
        self.work.wait()
        if self.dest is not None:
            self.dest.copy_(self.host)
        return True


def _p2p(kind: str, tensor, peer, group, tag=0, host_staged=False):
    """One asynchronous send or receive; returns its work handle."""
    if _staged(tensor, group, host_staged):
        if kind == "send":
            host = _to_host(tensor)
            return _Staged(dist.isend(host, dst=peer, group=group, tag=tag),
                           host)
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        return _Staged(dist.irecv(host, src=peer, group=group, tag=tag),
                       host, tensor)
    if kind == "send":
        return dist.isend(tensor, dst=peer, group=group, tag=tag)
    return dist.irecv(tensor, src=peer, group=group, tag=tag)


def send(tensor, dst=0, group=None, sync_op=True, host_staged=False):
    if _live():
        with collective_span("send", tensor):
            _p2p("send", tensor, dst, group,
                 host_staged=host_staged).wait()
    return tensor


def recv(tensor, src=0, group=None, sync_op=True, host_staged=False):
    if _live():
        with collective_span("recv"):
            _p2p("recv", tensor, src, group,
                 host_staged=host_staged).wait()
    return tensor


class P2POp:
    """One operation of :func:`batch_isend_irecv`: ``op`` is ``send`` or
    ``recv`` (or ``"send"``/``"recv"``); a send matches the peer's
    receive of the same ``tag`` (gloo)."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        self.tag = tag


def _kind(op) -> str:
    if op in (send, "send"):
        return "send"
    if op in (recv, "recv"):
        return "recv"
    raise ValueError(f"unknown P2P op {op!r}")


def batch_isend_irecv(p2p_op_list: List[P2POp], host_staged=False):
    """Post every send and receive of the list, then wait for all of them
    (receives are complete on return). Returns ``[]``."""
    if not _live():
        return []
    # the volume is the sends' (the receives' would count every byte
    # twice)
    with collective_span("batch_isend_irecv",
                         [op.tensor for op in p2p_op_list
                          if _kind(op.op) == "send"]):
        _batch(p2p_op_list, host_staged)
    return []


def _batch(p2p_op_list, host_staged):
    works = []
    plain = []
    for op in p2p_op_list:
        kind = _kind(op.op)
        if _staged(op.tensor, op.group, host_staged):
            works.append(_p2p(kind, op.tensor, op.peer, op.group, op.tag,
                              host_staged))
        else:
            plain.append(dist.P2POp(dist.isend if kind == "send"
                                    else dist.irecv, op.tensor, op.peer,
                                    op.group, tag=op.tag))
    if plain:
        works += dist.batch_isend_irecv(plain)
    for w in works:
        w.wait()


def ring_shift(tensors, group, nxt: int, prv: int,
               host_staged=False) -> list:
    """Send each tensor to global rank ``nxt`` and receive its
    counterpart from ``prv`` (one hop around a ring): returns the
    received tensors. Every rank of the ring must call it, with its
    tensors in the same order."""
    got = [torch.empty_like(t) for t in tensors]
    ops = [P2POp("send", t.contiguous(), nxt, group, tag=i)
           for i, t in enumerate(tensors)]
    ops += [P2POp("recv", g, prv, group, tag=i) for i, g in enumerate(got)]
    batch_isend_irecv(ops, host_staged)
    return got


# -- collectives autograd can see ---------------------------------------------

def all_gather_dim(x, dim: int, group):
    """The group's tensors concatenated along ``dim`` (no autograd)."""
    if group is None:
        return x
    n = _size(group)
    g = _gather0(x.movedim(dim, 0), group)             # (n, x_dim0, ...)
    g = g.reshape((n * g.shape[1],) + tuple(g.shape[2:]))
    return g.movedim(0, dim)


def scatter_dim(x, dim: int, group):
    """The sum over the group of ``x``, this rank's slice along ``dim``
    (a reduce-scatter; no autograd)."""
    if group is None:
        return x
    n = _size(group)
    xm = x.movedim(dim, 0)
    stacked = xm.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    return _reduce_scatter0(stacked, group).movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with collective_span("all_reduce", g):
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        with collective_span("all_reduce", out):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    """Identity forward, all-reduce (sum) of the gradient over ``group``
    backward: the input of a column-parallel product."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce (sum) over ``group`` forward, identity backward: the
    output of a row-parallel product, or a replicated scalar's parts."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_dim(x, dim: int, group):
    """All-gather along ``dim`` forward, reduce-scatter (sum) of the
    gradient backward: ZeRO-3's per-layer parameter gather."""
    return x if group is None else _GatherDim.apply(x, dim, group)
