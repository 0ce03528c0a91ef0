"""The port's one door to ``torch.distributed``: every collective the
multi-GPU paths make goes through a function here, which adds one to its
op's entry of :data:`COLLECTIVES` — the collective census, counted the
way ``kernels._build.LAUNCHES`` counts kernel launches (it replaces the
reference's census of the compiled HLO).

Each call also adds its result's bytes to its op's entry of
:data:`COLLECTIVE_BYTES` (the reference's convention: a gather counts
the whole gathered result; a send / receive pair counts once, at the
receive) and to one span of :data:`COLLECTIVE_SPANS`, from the ranks of
its group: ``intra_host`` where they all sit on one host of
:data:`CARDS_PER_HOST` cards, else ``inter_host``, and ``inter_pod`` as
well where they span pods of :data:`POD_RANKS` ranks (set by the mesh
builders of ``launch.mesh``; 0: one pod).

Ops and their census names: ``all_to_all`` (``all_to_all_single``,
also the backward's of :func:`fsdp_gather`), ``all_reduce``,
``all_gather`` (also the one gather of :func:`ordered_sum`,
:func:`gather_blocks` and :func:`fsdp_gather`, and the backward's of
:func:`sum_grad`), ``send`` / ``recv`` (one each a point-to-point op of
:func:`exchange`) and ``barrier``.

The forms the sharded model differentiates through (Megatron's f and g,
and the FSDP gather), none with a float atomic or a backend reduction
order:

* :func:`ordered_sum` (g): the sum of every rank's partial; its backward
  hands the gradient to this rank's partial as it is, since every rank
  of the group computes the same values downstream;
* :func:`sum_grad` (f): the identity, where a value every rank holds
  enters rank-specific work (a product with this rank's block of a
  weight, or a slice); its backward adds the ranks' gradients in rank
  order;
* :func:`gather_blocks`: the ranks' blocks of a dim, concatenated; its
  backward keeps this rank's slice of the gradient;
* :func:`fsdp_gather`: the same concatenation of a parameter cut over
  "data"; its backward takes every rank's gradient of this rank's block
  (one all-to-all) and adds them in rank order (a reduce-scatter, the
  data-parallel sum of that leaf's gradient).

NCCL and gloo both take the card's tensors in the collectives (gloo
copies them through host memory itself; ``chip_smoke.py`` phase 15
passes them so).  Gloo's point-to-point ops are handed host memory: on
a gloo group :func:`exchange` copies CUDA tensors through pinned host
buffers, chosen by the group's backend name, never as a fallback.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()
COLLECTIVE_SPANS: collections.Counter = collections.Counter()

# Cards a host (NVIDIA's DGX H100: 8 cards on NVLink), and ranks a pod
# (0: the job is one pod).
CARDS_PER_HOST = 8
POD_RANKS = 0


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()
    COLLECTIVE_SPANS.clear()


def set_pod_ranks(ranks: int) -> None:
    """Ranks a pod for the census's ``inter_pod`` span (0: one pod)."""
    global POD_RANKS
    POD_RANKS = int(ranks)


def _count(op: str, nbytes: int, ranks) -> None:
    """The census of one call: its op, its result bytes and their span
    over the global ``ranks`` it joins."""
    COLLECTIVES[op] += 1
    if not nbytes:
        return
    COLLECTIVE_BYTES[op] += nbytes
    lo, hi = min(ranks), max(ranks)
    host = lo // CARDS_PER_HOST != hi // CARDS_PER_HOST
    COLLECTIVE_SPANS["inter_host" if host else "intra_host"] += nbytes
    if POD_RANKS and lo // POD_RANKS != hi // POD_RANKS:
        COLLECTIVE_SPANS["inter_pod"] += nbytes


def _ranks(group) -> list:
    return dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_to_all_single(output: torch.Tensor, input: torch.Tensor,
                      group=None) -> torch.Tensor:
    """``output`` ← the equal dim-0 blocks of every rank's ``input``
    destined for this rank, in group-rank order."""
    _count("all_to_all", _nbytes(output), _ranks(group))
    dist.all_to_all_single(output, input, group=group)
    return output


def all_reduce(tensor: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """In-place all-reduce of ``tensor``."""
    _count("all_reduce", _nbytes(tensor), _ranks(group))
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group=None) -> list:
    """Every rank's ``tensor`` (equal shapes), in group-rank order."""
    tensor = tensor.contiguous()
    ranks = _ranks(group)
    _count("all_gather", len(ranks) * _nbytes(tensor), ranks)
    outs = [torch.empty_like(tensor) for _ in ranks]
    dist.all_gather(outs, tensor, group=group)
    return outs


def ordered_sum(tensor: torch.Tensor, group=None,
                acc_dtype: torch.dtype = None) -> torch.Tensor:
    """The sum of every rank's ``tensor`` over ``group``: one
    :func:`all_gather` of the partials, then ``parts[0] + parts[1] + ...``
    in group-rank order, accumulated in ``acc_dtype`` (the tensor's own
    dtype when None) and returned in the tensor's dtype.  Every rank adds
    the same tensors in the same order, so all hold the same bits, and no
    bit depends on the backend's reduction order (an ``all_reduce`` may
    add in any).  Backward: the gradient, to this rank's partial as it
    is (module docstring)."""
    return _OrderedSum.apply(tensor, group, acc_dtype)


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, acc_dtype):
        return sum_in_order(all_gather(tensor, group),
                            acc_dtype).to(tensor.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_grad(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` itself; under autograd, its gradient is the float32 sum
    of every rank's in group-rank order (:func:`ordered_sum`), in the
    tensor's dtype.  A tensor that takes no gradient is returned as it
    is."""
    if not (torch.is_grad_enabled() and tensor.requires_grad):
        return tensor
    return _SumGrad.apply(tensor, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return ordered_sum(grad, ctx.group, torch.float32), None


def gather_blocks(tensor: torch.Tensor, group=None,
                  dim: int = -1) -> torch.Tensor:
    """Every rank's block of dim ``dim``, concatenated in group-rank
    order (one :func:`all_gather`).  Backward: this rank's slice of the
    gradient."""
    return _GatherBlocks.apply(tensor, group, dim)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim):
        ctx.dim, ctx.n = dim, tensor.shape[dim]
        ctx.rank = dist.get_rank(group)
        return torch.cat(all_gather(tensor, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def fsdp_gather(tensor: torch.Tensor, group=None,
                dim: int = 0) -> torch.Tensor:
    """A parameter's blocks of dim ``dim`` (cut over "data"), concatenated
    in group-rank order (one :func:`all_gather`).  Backward: each rank's
    gradient cut into the ranks' blocks, block r sent to rank r (one
    :func:`all_to_all_single`), and the blocks received added in rank
    order in float32: this rank's block of the ranks' summed gradient (a
    deterministic reduce-scatter)."""
    return _FsdpGather.apply(tensor, group, dim)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, tensor.shape[dim]
        ctx.rank = dist.get_rank(group)
        return torch.cat(all_gather(tensor, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        blocks = grad.movedim(ctx.dim, 0).contiguous()
        mine = all_to_all_single(torch.empty_like(blocks), blocks, ctx.group)
        total = sum_in_order(list(mine.split(ctx.n)), torch.float32)
        return (total.to(grad.dtype).movedim(0, ctx.dim).contiguous(), None,
                None)


def sum_in_order(parts: list, acc_dtype: torch.dtype = None
                 ) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` (equal shapes) in list order,
    accumulated and returned in ``acc_dtype`` (the first part's dtype
    when None): the same bits wherever the same list is added."""
    acc = parts[0] if acc_dtype is None else parts[0].to(acc_dtype)
    for p in parts[1:]:
        acc = acc + p
    return acc


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as gloo's point-to-point ops take it: a pinned host copy of
    a CUDA tensor on a gloo group, else ``t``."""
    if not t.is_cuda or dist.get_backend(group) != dist.Backend.GLOO:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def exchange(sends: list, recvs: list, group=None) -> None:
    """Point-to-point round: ``sends`` / ``recvs`` are ``(tensor, peer)``
    pairs (``peer`` a global rank), posted together with
    ``dist.batch_isend_irecv`` and waited on; each received tensor is
    written in place."""
    me = dist.get_rank()
    for _, peer in sends:
        _count("send", 0, (me, peer))
    for t, peer in recvs:
        _count("recv", _nbytes(t), (me, peer))
    s_buf = [_host(t, group) for t, _ in sends]
    r_buf = [_host(t, group) for t, _ in recvs]
    ops = ([dist.P2POp(dist.isend, b, peer, group)
            for b, (_, peer) in zip(s_buf, sends)]
           + [dist.P2POp(dist.irecv, b, peer, group)
              for b, (_, peer) in zip(r_buf, recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for b, (t, _) in zip(r_buf, recvs):
        if b is not t:
            t.copy_(b)


def barrier(group=None) -> None:
    _count("barrier", 0, ())
    dist.barrier(group=group)
