"""The collectives that combine partial sums across ranks, counted.

Each call goes through `torch.distributed` on the group it is given, over
that group's own backend, and adds to `COLLECTIVES` under its site and
kind ("moe all_reduce", "flash_decode all_reduce", ...): the calls, the
bytes the call moves (an all-reduce its tensor's, an all-gather its
gathered output's) and, inside `timed`, the host seconds around the call,
the card synchronised first so that earlier kernels are not charged to it.
Counting alone reads no clock.
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
