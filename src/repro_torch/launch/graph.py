"""The compiled serving steps: the counterpart of the reference's
``jax.jit(make_prefill_step(...))`` and ``jax.jit(make_decode_step(...),
donate_argnums=(1,))`` (``repro/launch/serve.py``).

On the card each step runs as one captured CUDA graph, replayed per call,
so the host launches one graph where it launched some 30 kernels a layer.
At the first call for an input shape the wrapper

  1. runs the step once on a side stream (the warm-up: it builds and loads
     the kernels' libraries and sets each kernel's shared-memory limit
     outside the capture; its launches are not counted),
  2. captures the step with ``torch.cuda.graph`` over static input, output
     and cache buffers, and keeps the launches the capture counted
     (`launch.recording`): each replay adds them to `launch.LAUNCHES` again,
     so the counts still say which kernels the card ran;

and every call copies its inputs into the static ones and replays.

Inputs. The prefill's static inputs are the tokens and, for a vlm or
enc-dec arch, the batch's ``vision_ctx`` or ``frames`` (`EXTRAS`): each
call copies all of them in, so a request with other frames or vision
tokens is served with its own, not the captured ones.

Caches. The compiled prefill owns one static cache per batch size and
memory length, which each call zeroes and fills inside the graph and
returns; a compiled decode keeps a graph per token shape and memory length,
each captured on that cache, which serves every later request of the batch
size and memory length, since its attention reads the position from device
memory (the split_kv decode, or MLA's absorbed `chunked_attention`).
A layer's cache is a head-major (k, v) pair, an MLA latent buffer, a mamba
layer's conv window and SSM state or a cross layer's memory keys and
values, each written in place; `_cache_buffers` lists any of them. A call on
buffers (cache or weights) other than the ones a graph was captured on
raises: the graph would read the old ones. As with ``donate_argnums``, a
returned cache is the caller's until the next call for the same batch size
and memory length.
The position is mirrored on the host under ``caches[HOST_POS]``, so that a
decode past the capacity of the first attention layer's cache raises
`ValueError` before the replay: on the card it would write past the cache.
A stack with no attention layer (Mamba2) has no capacity to check.

The decode's warm-up runs the step for real. It writes the same keys and
values a replay writes again, but it advances a mamba layer's state and
shifts its conv window: the capture puts back the position and every
mamba buffer, or the first replay would apply its token twice.

Logits are returned as fresh tensors (clones of the graph's output), so a
caller that keeps them does not hold a buffer the next replay overwrites.

On the CPU each call runs the step eagerly, with the same host checks: that
is the device the caller asked for. A capture that fails raises; nothing
falls back to eager execution on the card. A step whose config reads a
tensor value on the host (MoE's ragged dispatch) is refused when it is
compiled, on either device (`moe.check_capturable`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels import launch
from repro_torch.models.layers import CROSS_K
from repro_torch.models.moe import check_capturable
from repro_torch.models.ssm import STATE
from repro_torch.models.transformer import cache_capacity

#: the caches' position as a host int, kept by the compiled steps
HOST_POS = "host_pos"
#: the batch entries besides the tokens that a prefill takes: a vlm's
#: stubbed vision embeddings, an enc-dec arch's stubbed frames
EXTRAS = ("vision_ctx", "frames")


def _captures(device: torch.device) -> bool:
    """Whether a step on ``device`` is captured: on the card; on the CPU it
    runs eagerly."""
    return device.type == "cuda"


def _warm_up(fn: Callable[[], Any], device: torch.device) -> None:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


def _capture(fn: Callable[[], Any], device: torch.device):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        out = fn()
    return graph, out


class CapturedStep:
    """``fn`` (no arguments, static buffers only) warmed up, captured as one
    CUDA graph, and the kernel launches its capture counted."""

    def __init__(self, fn: Callable[[], Any], device: torch.device):
        with launch.recording():
            _warm_up(fn, device)
        with launch.recording() as self.launches:
            self.graph, self.out = _capture(fn, device)

    def replay(self) -> None:
        self.graph.replay()
        launch.add_launches(self.launches)


def _cache_buffers(caches) -> list[torch.Tensor]:
    """``pos`` and every tensor of each layer's cache, whatever its layout
    ((k, v), an MLA latent buffer, a mamba layer's conv and SSM state, a
    cross layer's memory keys and values), layer by layer in name order."""
    return [caches["pos"], *(c[n] for c in caches["layers"] for n in sorted(c))]


def _memory_key(caches) -> tuple[int, ...]:
    """The length of the cross caches' memory, as a 1-tuple, for a cache
    that has cross layers; () for one that has none."""
    return next(((c[CROSS_K].shape[2],) for c in caches["layers"] if CROSS_K in c),
                ())


def _advanced_buffers(caches) -> list[torch.Tensor]:
    """The buffers a decode step advances rather than writes at ``pos``:
    ``pos`` itself and each mamba layer's conv window and SSM state."""
    return [caches["pos"], *(c[n] for c in caches["layers"]
                             if set(c) == set(STATE) for n in STATE)]


def _check_same(step: str, what: str, got: list, captured: list) -> None:
    if len(got) != len(captured) or any(a is not b for a, b in zip(got, captured)):
        raise ValueError(f"compiled {step}: called on {what} other than the "
                         f"ones its graph was captured on")


class CompiledPrefill:
    """``prefill_step(params, batch, caches=None)`` (`steps.make_prefill_step`)
    compiled: see the module's docstring."""

    def __init__(self, step):
        check_capturable(step.cfg)
        self.step = step
        self.caches: dict[tuple, dict] = {}     # (batch, memory) -> static cache
        self.graphs: dict[tuple, dict] = {}     # inputs' shapes -> graph

    def __call__(self, params, batch) -> tuple[torch.Tensor, dict]:
        tokens = batch["tokens"]
        b, s = tokens.shape
        if not _captures(tokens.device):
            logits, caches = self.step(params, batch)
            caches[HOST_POS] = s
            return logits, caches
        inputs = {"tokens": tokens, **{n: batch[n] for n in EXTRAS if n in batch}}
        key = tuple((n, tuple(t.shape), t.dtype) for n, t in inputs.items())
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(params, inputs)
        else:
            _check_same("prefill", "weights", [params], [entry["params"]])
        for name, t in inputs.items():
            entry["inputs"][name].copy_(t)
        entry["graph"].replay()
        caches = self.caches[entry["cache_key"]]
        caches[HOST_POS] = s
        return entry["graph"].out.clone(), caches

    def _capture(self, params, inputs: dict) -> dict:
        static = {name: t.clone() for name, t in inputs.items()}
        # the memory's length is the extras' axis 1 (frames or vision tokens)
        cache_key = (inputs["tokens"].shape[0],
                     *(t.shape[1] for n, t in inputs.items() if n != "tokens"))
        if cache_key not in self.caches:
            # the step's own fresh caches become the static cache of the
            # batch size and memory length: made outside any graph, so no
            # graph's pool holds them
            with launch.recording():
                _, self.caches[cache_key] = self.step(params, static)
        caches = self.caches[cache_key]

        def run():
            for buf in _cache_buffers(caches):
                buf.zero_()
            logits, new = self.step(params, static, caches)
            caches["pos"].copy_(new["pos"])
            return logits

        return {"graph": CapturedStep(run, inputs["tokens"].device),
                "inputs": static, "params": params, "cache_key": cache_key}


class CompiledDecode:
    """``decode_step(params, caches, token)`` (`steps.make_decode_step`)
    compiled: see the module's docstring."""

    def __init__(self, step):
        check_capturable(step.cfg)
        self.step = step
        # (token's shape, dtype, memory length where there is one) -> graph
        self.graphs: dict[tuple, dict] = {}

    def __call__(self, params, caches, token) -> tuple[torch.Tensor, dict]:
        s = token.shape[1]
        host = caches.get(HOST_POS)
        if host is None:            # caches no compiled step made: read once
            host = int(caches["pos"])
        cap = cache_capacity(caches)
        if cap is not None and host + s > cap:
            raise ValueError(f"compiled decode: {s} token(s) at position "
                             f"{host} do not fit a cache of {cap}")
        if not _captures(token.device):
            logits, caches = self.step(params, caches, token)
            caches[HOST_POS] = host + s
            return logits, caches
        key = (tuple(token.shape), token.dtype, *_memory_key(caches))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(params, caches, token)
        else:
            _check_same("decode", "weights", [params], [entry["params"]])
            _check_same("decode", "cache buffers", _cache_buffers(caches),
                        entry["buffers"])
        entry["token"].copy_(token)
        entry["graph"].replay()
        caches[HOST_POS] = host + s
        return entry["graph"].out.clone(), caches

    def _capture(self, params, caches, token: torch.Tensor) -> dict:
        static = token.clone()
        pos = caches["pos"]

        def run():
            logits, new = self.step(params, caches, static)
            pos.copy_(new["pos"])
            return logits

        # the warm-up runs the step for real: it writes this step's keys and
        # values at pos (the replay writes the same ones again) and advances
        # pos and every mamba layer's state, which are put back
        advanced = _advanced_buffers(caches)
        saved = [buf.clone() for buf in advanced]
        graph = CapturedStep(run, token.device)
        for buf, old in zip(advanced, saved):
            buf.copy_(old)
        return {"graph": graph, "token": static, "params": params,
                "buffers": _cache_buffers(caches)}


def compile_prefill(step) -> CompiledPrefill:
    """The compiled counterpart of ``jax.jit(prefill_step)``."""
    return CompiledPrefill(step)


def compile_decode(step) -> CompiledDecode:
    """The compiled counterpart of ``jax.jit(decode_step,
    donate_argnums=(1,))``."""
    return CompiledDecode(step)
