"""Architecture registry of the port + smoke reduction.

``ARCHS`` lists every arch the reference registers: the dense
decoder-only ones, the MoE decoder (qwen2-moe), DeepSeek-V2-Lite (MLA, a
leading dense layer, MoE), Mamba2 (attention-free), Jamba (mamba and
attention sublayers, dense and MoE FFNs), Llama-3.2-Vision (self-attention
periods with a cross-attention layer over stubbed vision tokens) and
SeamlessM4T (an encoder over stubbed audio frames, decoder layers with
self- and cross-attention).
"""

from __future__ import annotations

import dataclasses
import importlib

ARCHS: tuple[str, ...] = (
    "qwen2-1.5b",
    "stablelm-12b",
    "granite-8b",
    "gemma-2b",
    "qwen2-moe-a2.7b",
    "deepseek-v2-lite-16b",
    "mamba2-1.3b",
    "jamba-v0.1-52b",
    "llama-3.2-vision-90b",
    "seamless-m4t-large-v2",
)

_MODULES = {
    "qwen2-1.5b": "qwen2_1p5b",
    "stablelm-12b": "stablelm_12b",
    "granite-8b": "granite_8b",
    "gemma-2b": "gemma_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-1.3b": "mamba2_1p3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def list_archs() -> tuple[str, ...]:
    return ARCHS


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke(name: str):
    """Reduced config of the same family: small widths/depths/experts, every
    structural feature preserved (GQA ratio, MoE shared+routed, MLA, SSD,
    interleave pattern, enc-dec, cross-attn). The reference's rules."""
    from repro_torch.configs.base import EncoderCfg, MlaCfg, MoeCfg, SsmCfg
    cfg = get_config(name)
    kv = max(1, round(4 * cfg.n_kv_heads / cfg.n_heads))
    repl: dict = dict(
        d_model=128, n_heads=4, n_kv_heads=min(4, kv),
        head_dim=64 if (cfg.head_dim and cfg.head_dim > cfg.d_model // cfg.n_heads)
        else None,
        d_ff=0 if cfg.d_ff == 0 else 288,
        vocab=512,
        n_periods=min(2, cfg.n_periods),
    )
    if cfg.moe:
        repl["moe"] = MoeCfg(
            n_routed=8, top_k=min(cfg.moe.top_k, 2), expert_ff=64,
            n_shared=cfg.moe.n_shared, shared_ff=96 if cfg.moe.shared_ff else 0,
            shared_gate=cfg.moe.shared_gate, norm_topk=cfg.moe.norm_topk)
    if cfg.mla:
        repl["mla"] = MlaCfg(kv_lora=64, qk_nope=32, qk_rope=16, v_head=32)
    if cfg.ssm:
        repl["ssm"] = SsmCfg(d_state=16, d_conv=4, expand=2, head_dim=16,
                             n_groups=cfg.ssm.n_groups, chunk=32)
    if cfg.encoder:
        repl["encoder"] = EncoderCfg(n_layers=2, frontend_dim=48)
    if cfg.n_vision_tokens:
        repl["n_vision_tokens"] = 16
    if cfg.first_dense_layers:
        repl["first_dense_ff"] = 320
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **repl)
