"""The modality-frontend stubs of the vlm and audio archs: the counterpart
of ``make_extra_inputs`` in the reference's ``repro/data/pipeline.py``."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.launch import resolve_device


def make_extra_inputs(cfg, batch_size: int, seq_len: int, rng=None, *,
                      device="cuda") -> dict[str, torch.Tensor]:
    """The batch's extra inputs: an encoder arch's ``frames`` (B, seq_len,
    frontend_dim), the precomputed frame embeddings, then a vlm's
    ``vision_ctx`` (B, n_vision_tokens, d_model), the precomputed patch
    embeddings; none for the other archs. Each is drawn from ``rng`` (a
    numpy Generator; seed 0 when None) as the reference draws it, standard
    normal in float32 in the same order, and rounded to the config's dtype
    on ``device``: the same bits as the reference's arrays."""
    rng = rng or np.random.default_rng(0)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def draw(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(device, dtype)

    extras = {}
    if cfg.encoder is not None:
        extras["frames"] = draw((batch_size, seq_len, cfg.encoder.frontend_dim))
    if cfg.n_vision_tokens:
        extras["vision_ctx"] = draw((batch_size, cfg.n_vision_tokens, cfg.d_model))
    return extras
