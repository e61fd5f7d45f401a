"""Plain PyTorch oracles for every kernel in this package (library calls;
for references and tests only, never on the kernels' path).

On a CUDA card float32 convolutions default to TF32; a caller comparing
against these oracles there turns it off
(``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.psum_matmul import ACTIVATIONS


def matmul_ref(x: torch.Tensor, w: torch.Tensor, act: str = "none",
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    out = ACTIVATIONS[act](x.float() @ w.float())
    return out.to(out_dtype or x.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               act: str = "none") -> torch.Tensor:
    """x: (Cin, Hp, Wp) pre-padded, w: (Cout, Cin, K, K) -> (Cout, Ho, Wo)."""
    out = F.conv2d(x[None].float(), w.float(), stride=stride)[0]
    return ACTIVATIONS[act](out).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Skv, D)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / (q.shape[-1] ** 0.5)
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)
