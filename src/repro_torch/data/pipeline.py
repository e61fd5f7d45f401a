"""The port's data: the deterministic synthetic LM stream (``DataConfig``,
``SyntheticLM``) and the modality-frontend stubs of the vlm and audio archs
(``make_extra_inputs``), the counterparts of the reference's
``repro/data/pipeline.py``.

The stream is a copy of the reference's numpy generator: each host
materializes only its slice of the global batch (``host_batch =
global_batch / n_hosts``), and a batch is a pure function of (seed, step,
host), so a restart never replays or skips data and both packages draw the
same tokens. Tokens follow a Zipfian distribution with a learnable bigram
shift, so the LM loss has signal to fit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.launch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Iterator-style pipeline. `batch(step)` is pure in (cfg, step, host)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by {n_hosts} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.host_batch = cfg.global_batch // n_hosts
        # Zipf-ish unigram table + a deterministic bigram shift: makes
        # next-token prediction learnable (p(next|cur) concentrated).
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = (probs / probs.sum()).astype(np.float32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """{"tokens", "labels"}: (host_batch, seq_len) int32 each, the
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_index]))
        base = rng.choice(cfg.vocab, size=(self.host_batch, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # Markov structure: with p=0.5 the next token is a fixed function of
        # the current one (learnable bigram), else the sampled one.
        follow = rng.random((self.host_batch, cfg.seq_len)) < 0.5
        nxt = (base[:, :-1] * 31 + 7) % cfg.vocab
        seq = base.copy()
        seq[:, 1:] = np.where(follow, nxt, base[:, 1:])
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def torch_batch(self, step: int, device="cuda") -> dict[str, torch.Tensor]:
        """`batch` as int32 tensors on ``device``."""
        device = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch(step).items()}


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
