"""The port's serving path on the CPU: `serve.main` at smoke size for every
arch (the dense ones, the MoE decoder, DeepSeek-V2-Lite, Mamba2, Jamba, and
Llama-3.2-Vision and SeamlessM4T with their stubbed vision tokens and
frames), its served tokens against the port's greedy loop and the
reference's, and entry points that refuse the card where there is none."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch.configs import get_smoke
from repro_torch.launch import serve
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

REPORT_KEYS = {"requests", "tokens", "tokens_per_s", "ttft_ms_mean",
               "batch_latency_ms_mean"}
ARGS = ["--smoke", "--device", "cpu", "--requests", "6", "--batch", "4",
        "--prompt-len", "16", "--gen-len", "4"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma-2b", "granite-8b",
                                  "stablelm-12b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_serve_reports_the_reference_keys(arch):
    report = serve.main(["--arch", arch, *ARGS])
    assert set(report) == REPORT_KEYS
    assert report["requests"] == 8                 # two batches of 4
    assert report["tokens"] == 8 * 4
    assert report["tokens_per_s"] > 0
    assert 0 < report["ttft_ms_mean"] <= report["batch_latency_ms_mean"]


def test_served_tokens_are_the_greedy_loop():
    """What `serve.main` records for each batch is the port's greedy loop
    on the same prompts and weights, and its logits are finite."""
    record: dict = {}
    serve.main(["--arch", "qwen2-1.5b", *ARGS], record=record)
    assert len(record["batches"]) == 2
    cfg = record["cfg"]
    for batch in record["batches"]:
        assert batch["tokens"].shape == (4, 4)
        assert batch["logits"].shape == (4, 4, cfg.padded_vocab)
        assert torch.isfinite(batch["logits"].float()).all()
        with torch.inference_mode():
            want = tsteps.greedy_generate(cfg, record["params"],
                                          batch["prompts"], 4, 20)
        assert torch.equal(batch["tokens"], want)


def test_greedy_generate_matches_jax():
    """fp32 at smoke size: the port's greedy tokens equal the reference's
    on the reference's weights."""
    jcfg = dataclasses.replace(jget_smoke("qwen2-1.5b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("qwen2-1.5b"), dtype="float32")
    jparams = jtf.init_lm(jax.random.PRNGKey(2), jcfg)
    tparams = ttf.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        device="cpu")
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10))
    want = jsteps.greedy_generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32),
                                  6, 16)
    with torch.inference_mode():
        got = tsteps.greedy_generate(tcfg, tparams, torch.from_numpy(prompt),
                                     6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_steps_shapes():
    cfg = get_smoke("gemma-2b")
    params = ttf.init_lm(cfg, seed=1, device="cpu")
    tokens = torch.zeros(3, 7, dtype=torch.long)
    with torch.inference_mode():
        logits, caches = tsteps.make_prefill_step(cfg, 9)(params,
                                                          {"tokens": tokens})
        assert logits.shape == (3, cfg.padded_vocab) and caches["pos"] == 7
        logits, caches = tsteps.make_decode_step(cfg)(params, caches,
                                                      tokens[:, :1])
    assert logits.shape == (3, cfg.padded_vocab) and caches["pos"] == 8
    # head-major: (B, Hkv, max_len, hd)
    assert caches["layers"][0]["k"].shape == (3, cfg.n_kv_heads, 9, cfg.hd)


def test_seeded_weights_are_reproducible():
    cfg = get_smoke("granite-8b")
    a = ttf.init_lm(cfg, seed=4, device="cpu")
    b = ttf.init_lm(cfg, seed=4, device="cpu")
    c = ttf.init_lm(cfg, seed=5, device="cpu")
    assert torch.equal(a["layers"][1]["attn"]["wq"]["w"],
                       b["layers"][1]["attn"]["wq"]["w"])
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    w = a["layers"][0]["mlp"]["wi"]["w"].float()
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1) < 0.05   # fan-in scale


def test_cuda_without_a_gpu_raises():
    """Asking for the card where there is none raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke("qwen2-1.5b")
    for call in (lambda: serve.main(["--arch", "qwen2-1.5b", "--smoke",
                                     "--requests", "1", "--batch", "1"]),
                 lambda: ttf.init_lm(cfg, device="cuda"),
                 lambda: ttf.init_caches(cfg, 1, 4, device="cuda"),
                 lambda: ttf.params_from_jax({}, cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
