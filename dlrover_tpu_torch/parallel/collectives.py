"""Differentiable collectives over one mesh axis's process group.

The reference gets these from JAX: ``lax.ppermute`` and ``lax.all_to_all``
inside ``shard_map`` transpose to their mirror images, and the whole SPMD
program is differentiated at once. Torch differentiates each rank's graph
alone, so each collective here is a ``torch.autograd.Function`` whose
backward runs the adjoint collective, and two rules keep the ranks paired:

- every rank must run the backward of every collective it ran forward, in
  the same order as its peers. A rank whose result does not depend on a
  received tensor (the ring's future chunks, pipeline stage 0's hop) would
  prune that node from its graph and never post the receive its
  neighbour's backward sends: :func:`tie` (the ring) and ``torch.where``
  (the pipeline) keep such tensors in the graph;
- two collectives that autograd could run in either order must not share
  a pair of ranks: the ring moves K and V in one :func:`shift`.

A region whose ranks each compute a share of one result on the same rows
(the ``ep`` experts of the MoE FFN, ``models/moe.py``; the ``tp`` heads,
columns and vocab rows of ``models/llama.py``) takes a conjugate pair,
Megatron's *f* and *g*: :func:`to_region` enters it (identity forward,
all-reduce backward) and :func:`from_region` leaves it (all-reduce
forward, identity backward), the adjoint of the reference's sharded
einsums. :func:`gather_from_region` leaves it along a split dim instead
(an all-gather; the backward keeps the rank's block).
:func:`gather_shard` gathers a param's ``fsdp`` blocks for ranks that
run different rows: its backward reduce-scatters the grad. :func:`psum`
sums over a group both ways, for a value every rank's loss reads.

Point-to-point ops take global ranks (``dist.get_global_rank``). A failed
send, receive, all-to-all or all-reduce raises; nothing is caught.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _peer(r: int, offset: int, n: int, wrap: bool) -> Optional[int]:
    p = r + offset
    if wrap:
        return p % n
    return p if 0 <= p < n else None


def _shift(tensors: Sequence[torch.Tensor], group, offset: int,
           wrap: bool):
    """Send ``tensors`` to group rank ``r + offset`` and receive the same
    shapes from ``r - offset`` (modulo the group size when ``wrap``; a
    rank with no such peer sends nothing or receives zeros)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    to = _peer(r, offset, n, wrap)
    frm = _peer(r, -offset, n, wrap)
    ops, out = [], []
    for t in tensors:
        if to is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  dist.get_global_rank(group, to), group))
        if frm is None:
            out.append(torch.zeros_like(t))
        else:
            out.append(torch.empty_like(
                t, memory_format=torch.contiguous_format))
            ops.append(dist.P2POp(dist.irecv, out[-1],
                                  dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, wrap, *tensors):
        ctx.group, ctx.offset, ctx.wrap = group, offset, wrap
        return tuple(_shift([t.detach() for t in tensors], group, offset,
                            wrap))

    @staticmethod
    def backward(ctx, *grads):
        back = _shift(grads, ctx.group, -ctx.offset, ctx.wrap)
        return (None, None, None, *back)


def shift(tensors: Sequence[torch.Tensor], group, offset: int = 1,
          wrap: bool = True):
    """One hop of ``tensors`` along ``group``: rank ``r`` sends to
    ``r + offset`` and receives from ``r - offset``, all tensors in one
    ``batch_isend_irecv``. ``wrap`` closes the ring (the reference's
    ``[(j, (j + 1) % n)]`` permutation); without it the last rank sends
    nothing and the first receives zeros (``[(i, i + 1) for i < n - 1]``).
    Its backward is the reverse hop."""
    return _Shift.apply(group, offset, wrap, *tensors)


class _All2All(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.group, ctx.dims = group, (scatter_dim, gather_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return _all_to_all(g, ctx.group, gather_dim, scatter_dim), None, \
            None, None


def _all_to_all(x, group, scatter_dim: int, gather_dim: int):
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=scatter_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


def all_to_all(x, group, scatter_dim: int, gather_dim: int):
    """``lax.all_to_all(tiled=True)`` over ``group``: ``x`` split in
    ``n`` equal blocks along ``scatter_dim``, block ``j`` sent to group
    rank ``j``, and the ``n`` blocks received concatenated along
    ``gather_dim`` in group-rank order. Its backward is the mirror
    all-to-all (``gather_dim`` scattered, ``scatter_dim`` gathered)."""
    if x.shape[scatter_dim] % dist.get_world_size(group):
        raise ValueError(
            f"dim {scatter_dim} of {tuple(x.shape)} does not split over "
            f"{dist.get_world_size(group)} ranks")
    return _All2All.apply(x, group, scatter_dim, gather_dim)


class _FromRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        out = x.detach().contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # the sum of the group's cotangents lands on src; the others' input
        # was not read. Summed in f32, so pp equal bf16 cotangents add
        # exactly
        total = g.float().contiguous()
        dist.reduce(total, dist.get_global_rank(ctx.group, ctx.src),
                    group=ctx.group)
        if dist.get_rank(ctx.group) != ctx.src:
            return torch.zeros_like(g), None, None
        return total.to(g.dtype), None, None


def from_rank(x, group, src: int):
    """Group rank ``src``'s ``x`` on every rank of ``group`` (a
    broadcast); every rank passes a tensor of the same shape. Its backward
    is the adjoint: the cotangents of all ranks summed onto ``src``, and
    zeros elsewhere."""
    return _FromRank.apply(x, group, src)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *others):
        ctx.others = [(t.shape, t.dtype, t.device) for t in others]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.others))


def tie(out, *others):
    """``out`` itself, with ``others`` made inputs of it that get zero
    gradients: each rank's backward then reaches the collectives that
    produced ``others`` even where its result does not read them."""
    return _Tie.apply(out, *others)


def _sum_f32(t, group):
    """The sum of ``t`` over ``group``, taken in f32 and cast back to
    ``t``'s dtype."""
    total = t.float().contiguous()
    if total.data_ptr() == t.data_ptr():
        total = total.clone()
    dist.all_reduce(total, group=group)
    return total.to(t.dtype)


class _ToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(_sum_f32(g, ctx.group) for g in grads))


def to_region(tensors: Sequence[torch.Tensor], group):
    """Enter a region of ``group`` (*f*): ``tensors`` (replicated over
    ``group``) unchanged. Each rank's cotangents then hold only its own
    share (its experts', heads' or columns'), so the backward sums them
    over ``group`` (in f32, one all-reduce a tensor in the given order),
    and every rank leaves with the whole gradient."""
    return _ToRegion.apply(group, *tensors)


class _FromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def from_region(x, group):
    """Leave a region of ``group`` (*g*): the sum over ``group`` of the
    ranks' partial results ``x`` (in f32, cast back). Every rank's loss
    reads the same sum, so a rank's partial takes that loss's cotangent
    as it is: the backward is the identity."""
    return _FromRegion.apply(x, group)


def _all_gather(x, group, dim: int):
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in
    group-rank order. NCCL gathers along dim 0; another dim is a strided
    copy of the gathered stack."""
    n = dist.get_world_size(group)
    x = x.detach().contiguous()
    parts = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(parts, x, group=group)
    if dim == 0:
        return parts
    shape = list(x.shape)
    shape[dim] *= n
    return parts.unflatten(0, (n, x.shape[0])).movedim(0, dim).reshape(shape)


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        dim = ctx.dim
        block = list(g.shape)
        block[dim] //= n
        # (n, *block): block j of the cotangent along dim for group rank j
        chunks = g.float().unflatten(dim, (n, block[dim])).movedim(dim, 0)
        chunks = chunks.contiguous()
        piece = chunks.new_empty(block)
        dist.reduce_scatter_tensor(
            piece, chunks.reshape(n * block[0], *block[1:]),
            group=ctx.group)
        return piece.to(g.dtype), None, None


def gather_shard(x, group, dim: int):
    """The whole of a param from each rank's block ``x`` along ``dim``
    over ``group`` (an all-gather). The ranks of ``group`` run different
    rows (``fsdp`` is a data axis), so each rank's cotangent is its rows'
    share of the whole's gradient: the backward reduce-scatters it along
    ``dim``, summed in f32, and each rank's block takes the sum of every
    rank's share."""
    return _GatherShard.apply(x, group, dim)


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def gather_from_region(x, group, dim: int):
    """Leave a region of ``group`` along ``dim``: each rank's block ``x``
    (its vocab columns of the logits) gathered whole on every rank. Every
    rank's loss reads the same whole tensor, so the backward keeps the
    rank's own block of the cotangent."""
    return _GatherFromRegion.apply(x, group, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_f32(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


def psum(x, group):
    """The sum of ``x`` over ``group`` on every rank. Its backward is the
    adjoint for the sum of the ranks' losses (the trainer averages the
    ranks' gradients over the data axes and ``sp``): every rank's input
    takes the sum of the group's cotangents."""
    return _PSum.apply(x, group)


def gather(x, group) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` of ``group`` in group-rank
    order (an all-gather; no gradient)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)
