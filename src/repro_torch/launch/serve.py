"""Batched serving launcher: prefill + greedy decode steps over batches of
seeded prompts, with a latency/throughput report.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu --requests 8 --batch 4 --prompt-len 64 --gen-len 8

Runs on the card unless ``--device cpu`` is given. Prefill and decode are
compiled as the reference's ``serve.py`` jits them (`graph.compile_prefill`,
`graph.compile_decode`): on the card each runs as one captured CUDA graph,
replayed per call, and a request's first batch pays for the capture. Every
attention layer of prefill and decode goes through the flash kernel
(`ops.gqa_flash_attention`). An MoE arch (``--arch qwen2-moe-a2.7b``) serves
through its capacity dispatch, the config's default. A vlm or enc-dec arch
(``--arch llama-3.2-vision-90b``, ``--arch seamless-m4t-large-v2``) takes
its stubbed vision tokens or audio frames from
`repro_torch.data.make_extra_inputs`, drawn once before the first prompt
and passed with every batch, as the reference's ``serve.py`` does; its
prefill runs the encoder (seamless) and fills the cross caches, and its
decode steps read them. The card is synchronised before each clock read;
each interval is a `repro_torch.obs.Stopwatch`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import make_extra_inputs
from repro_torch.kernels.launch import resolve_device
from repro_torch.launch import graph
from repro_torch.models import steps as ST
from repro_torch.models.transformer import init_lm
from repro_torch.obs.trace import Stopwatch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, record: dict | None = None) -> dict:
    """Serve ``--requests`` prompts in batches and return the report. Given a
    dict as ``record``, it also receives the config, the weights, the
    extras (vision tokens or frames; empty for the other archs) and, per
    batch, the prompts, the generated tokens and the logits of every step
    (prefill first), so a caller can check what was served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    n_batches = (args.requests + args.batch - 1) // args.batch
    lat_first, lat_total, toks = [], [], 0
    with torch.inference_mode():
        params = init_lm(cfg, seed=args.seed, device=device)
        max_len = args.prompt_len + args.gen_len
        prefill = graph.compile_prefill(ST.make_prefill_step(cfg, max_len))
        decode = graph.compile_decode(ST.make_decode_step(cfg))
        extras = make_extra_inputs(cfg, args.batch, args.prompt_len, rng,
                                   device=device)
        _sync(device)
        with Stopwatch() as run:
            for bi in range(n_batches):
                prompts = torch.from_numpy(rng.integers(
                    0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
                _sync(device)
                with Stopwatch() as total:
                    with Stopwatch() as first:
                        logits, caches = prefill(params, {"tokens": prompts,
                                                          **extras})
                        tok = torch.argmax(logits, -1)[:, None]
                        _sync(device)
                    step_logits, out = [logits], [tok]
                    for _ in range(args.gen_len - 1):
                        logits, caches = decode(params, caches, tok)
                        tok = torch.argmax(logits, -1)[:, None]
                        if record is not None:
                            step_logits.append(logits)
                            out.append(tok)
                    _sync(device)
                lat_first.append(first.s)
                lat_total.append(total.s)
                toks += args.batch * args.gen_len
                print(f"batch {bi}: ttft={lat_first[-1]*1e3:.0f}ms "
                      f"total={lat_total[-1]*1e3:.0f}ms", flush=True)
                if record is not None:
                    record.setdefault("batches", []).append({
                        "prompts": prompts, "tokens": torch.cat(out, 1),
                        "logits": torch.stack(step_logits, 1)})
                del caches
        wall = run.s
    if record is not None:
        record.update(cfg=cfg, params=params, extras=extras)
    report = {
        "requests": n_batches * args.batch,
        "tokens": toks,
        "tokens_per_s": toks / wall,
        "ttft_ms_mean": float(np.mean(lat_first) * 1e3),
        "batch_latency_ms_mean": float(np.mean(lat_total) * 1e3),
    }
    print(report)
    return report


if __name__ == "__main__":
    main()
