"""The collectives that combine partial sums across ranks, counted.

Each call goes through `torch.distributed` on the group it is given, over
that group's own backend, and adds to `COLLECTIVES` under its site and
kind ("moe all_reduce", "flash_decode all_reduce", ...): the calls, the
bytes the call moves (an all-reduce its tensor's, an all-gather its
gathered output's) and, inside `timed`, the host seconds around the call,
the card synchronised first so that earlier kernels are not charged to it.
Counting alone reads no clock.

`all_reduce` and `all_gather` carry no gradient. The combines of a
partial-sum computation carry one, through the `torch.autograd.Function`s
below (Megatron's tensor-parallel regions in explicit SPMD), each a forward
collective counted under its site and a backward one, where it has one,
counted under ``"<site>/grad"``. Without a gradient (serving's
``inference_mode``) they make the same collectives and give the same
values bit for bit, and record nothing for a backward:

  * `combine_active`: the all-reduce of a rank's partial sums, in place
    (the partial is marked dirty); its backward hands the partial the
    gradient of the replicated sum as it is.
  * `combine_passive`: every rank's partial gathered and added here; its
    backward is the same (a reduce-scatter of the gathered gradient would
    multiply it by the group's size).
  * `copy_to_group`: the identity into a rank's block of a partial-sum
    computation; its backward all-reduces the blocks' gradients over the
    group (Megatron's "copy to the tp region").
  * `gather_rows`: every rank's rows stacked in rank order; its backward
    takes this rank's rows of the gradient.
  * `group_mean`: the mean over the group; its backward hands this rank's
    term its share, the gradient over the group's size, with no collective
    (each rank's loss counts the mean once).

`exchange` is the point-to-point hop between neighbours a pipeline makes,
counted under ``"<site> send_recv"``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist

from repro_torch.obs.trace import Stopwatch
from repro_torch.plan.units import nbytes

#: "<site> <kind>" -> {"calls": n, "bytes": n, "s": seconds}
COLLECTIVES: dict[str, dict[str, float]] = {}
_TIMED = [False]


def reset() -> None:
    COLLECTIVES.clear()


@contextlib.contextmanager
def timed() -> Iterator[None]:
    """Collectives in the body also add their host seconds."""
    _TIMED[0] = True
    try:
        yield
    finally:
        _TIMED[0] = False


def _record(site: str, kind: str, t: torch.Tensor, fn) -> None:
    entry = COLLECTIVES.setdefault(f"{site} {kind}",
                                   {"calls": 0, "bytes": 0, "s": 0.0})
    entry["calls"] += 1
    entry["bytes"] += nbytes(t.numel(), t.element_size())
    if not _TIMED[0]:
        fn()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    with Stopwatch() as sw:
        fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
    entry["s"] += sw.s


def all_reduce(t: torch.Tensor, group, *, op=None, site: str) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (SUM unless ``op``)."""
    op = dist.ReduceOp.SUM if op is None else op
    _record(site, "all_reduce", t,
            lambda: dist.all_reduce(t, op=op, group=group))
    return t


def all_gather(t: torch.Tensor, group, size: int, *, site: str
               ) -> torch.Tensor:
    """Every rank's ``t`` over ``group`` of ``size`` ranks, stacked in rank
    order: (size, *t.shape). Gathered into one flat buffer along dim 0, the
    layout every backend takes."""
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    src = t.contiguous()
    _record(site, "all_gather", out,
            lambda: dist.all_gather_into_tensor(out, src, group=group))
    return out.view(size, *t.shape)


def exchange(t: torch.Tensor, group, send_to: int, recv_from: int, *,
             site: str) -> torch.Tensor:
    """Send ``t`` to global rank ``send_to`` and receive a tensor like it
    from global rank ``recv_from``, at once (`dist.batch_isend_irecv`);
    counted as the bytes sent. gloo moves host memory, so there a CUDA
    tensor is staged through the host."""
    via_host = t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    out = torch.empty_like(t, device="cpu" if via_host else t.device)
    src = t.cpu() if via_host else t.contiguous()

    def run():
        ops = [dist.P2POp(dist.isend, src, send_to, group),
               dist.P2POp(dist.irecv, out, recv_from, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _record(site, "send_recv", t, run)
    return out.to(t.device) if via_host else out


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, group, size, site, active):
        if active:
            ctx.mark_dirty(part)
            return all_reduce(part, group, site=site)
        return all_gather(part, group, size, site=site).sum(0)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None, None


def combine_active(part: torch.Tensor, group, *, site: str) -> torch.Tensor:
    """The sum of every rank's ``part`` over ``group``, an all-reduce into
    ``part`` itself."""
    return _Combine.apply(part, group, 1, site, True)


def combine_passive(part: torch.Tensor, group, size: int, *, site: str
                    ) -> torch.Tensor:
    """The sum of every rank's ``part`` over ``group`` of ``size`` ranks:
    all of them gathered and added on this rank."""
    return _Combine.apply(part, group, size, site, False)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, site):
        ctx.group, ctx.site = group, site
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return (all_reduce(grad.contiguous().clone(), ctx.group,
                           site=f"{ctx.site}/grad"), None, None)


def copy_to_group(t: torch.Tensor, group, *, site: str) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``group``."""
    return _CopyToGroup.apply(t, group, site)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size, rank, site):
        ctx.rows, ctx.rank = t.shape[0], rank
        return all_gather(t, group, size, site=site).reshape(
            size * t.shape[0], *t.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None, None


def gather_rows(t: torch.Tensor, group, size: int, rank: int, *, site: str
                ) -> torch.Tensor:
    """Every rank's ``t`` over ``group`` of ``size`` ranks, stacked along
    dim 0 in rank order; ``rank`` is this rank's index in the group."""
    return _GatherRows.apply(t, group, size, rank, site)


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, size, site):
        ctx.size = size
        return all_reduce(t.clone(), group, site=site) / size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None, None, None


def group_mean(t: torch.Tensor, group, size: int, *, site: str
               ) -> torch.Tensor:
    """The mean of every rank's ``t`` over ``group`` of ``size`` ranks."""
    return _GroupMean.apply(t, group, size, site)
