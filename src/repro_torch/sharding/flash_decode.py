"""Flash decoding over the sequence-sharded KV cache.

The paper's technique applied to decode. Each rank of the tensor-parallel
axis holds one block of the cache's sequence, ``[lo, lo + s_loc)`` with
``lo = tp_rank * s_loc``, and

  1. writes the new token's key and value into its own block when the
     position falls in it: the write happens at the memory that owns the
     data, with no collective (the active memory controller, verbatim);
  2. computes its block's partial softmax sums, per query row an fp32
     running max m, sum l and weighted-value accumulator acc, over the keys
     ``lo + j <= pos``;
  3. combines the blocks' partials across the axis: an all-reduce (MAX) of
     m, then one all-reduce (SUM) of l * w and acc * w together, with w =
     exp(m - m_glob), and divides by max(l, 1e-30).

Bytes moved a layer drop from O(cache) to O(B x heads x head_dim): at
Qwen1.5-MoE-A2.7B's decode (B 4, 16 heads of 128) 33 KiB of fp32 a layer.

On the card the block's partials are split_kv's pass 1, handed back
unnormalised (`flash_attention(..., partials=True)`): the combine kernel
does not run, and the rank's splits are folded in PyTorch with the weights
split_kv's combine uses. The rank's local position and valid length,
``pos - lo`` and ``clamp(pos - lo + 1, 0, s_loc)``, reach pass 1 as the two
int32 it reads from device memory, so nothing is read on the host. A rank
whose whole block lies past ``pos`` sees no key: its m stays NEG_INF, its l
is 0, and its weight in the combine is exp(NEG_INF - m_glob) = 0. On the
CPU the partials are the plain version's (`flash_plain`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import flash_attention as _flash
from repro_torch.sharding import collectives
from repro_torch.sharding.api import check_parallel

SITE = "flash_decode"


def flash_decode_attention(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, k1: torch.Tensor,
                           v1: torch.Tensor, pos: torch.Tensor, parallel
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode attention with a local cache update.

    q:  (B, Hq, 1, hd) new query (rope applied), head-major
    ck, cv: (B, Hkv, s_loc, hd) this rank's block of the head-major cache,
        positions [tp_rank * s_loc, (tp_rank + 1) * s_loc); written in place
    k1, v1: (B, Hkv, 1, hd) new key and value (rope applied)
    pos: 0-d int32 on the device, the write and attend position.
    Returns (out (B, Hq, 1, hd) in q's dtype, ck, cv).
    """
    parallel = check_parallel(parallel, "flash_decode_attention")
    b, hq, s, hd = q.shape
    _, hkv, s_loc, _ = ck.shape
    if s != 1 or tuple(k1.shape) != (b, hkv, 1, hd):
        raise ValueError(f"flash_decode_attention: one query token and its "
                         f"key, got q {tuple(q.shape)}, k1 {tuple(k1.shape)}")
    idx = pos.reshape(()).to(torch.int64) - parallel.tp_rank * s_loc
    in_range = (idx >= 0) & (idx < s_loc)
    at = idx.clamp(0, s_loc - 1).reshape(1)
    for cache, new in ((ck, k1), (cv, v1)):
        cache.index_copy_(2, at, torch.where(in_range, new,
                                             cache.index_select(2, at)))
    local = torch.stack([idx, (idx + 1).clamp(0, s_loc)]).to(torch.int32)
    m, l, acc = _flash.flash_attention(
        q.reshape(b * hq, 1, hd), ck.reshape(b * hkv, s_loc, hd),
        cv.reshape(b * hkv, s_loc, hd), causal=True, q_offset=local[0],
        kv_valid_len=local[1], partials=True)
    group = parallel.tp_group
    m_glob = collectives.all_reduce(m.clone(), group, op=dist.ReduceOp.MAX,
                                    site=SITE)
    w = torch.exp(m - m_glob)
    sums = collectives.all_reduce(torch.cat([l * w, acc * w], dim=-1), group,
                                  site=SITE)
    out = sums[..., 1:] / torch.clamp_min(sums[..., :1], 1e-30)
    return out.reshape(b, hq, 1, hd).to(q.dtype), ck, cv
