"""Layer tables for the paper's eight CNNs (224x224 inference).

The paper (Table III) matches torchvision-style model definitions evaluated at
224x224 with per-layer (input + output) activation counting: e.g. AlexNet
(torchvision channel widths 64/192/384/256/256) gives 822,784 activations =
the paper's 0.823 M/inference. We therefore reconstruct all eight networks
from their cited papers / torchvision definitions, tracking spatial shapes
programmatically so the layer tables cannot drift from the architectures.

Only convolution layers are emitted (the paper counts conv traffic only);
pooling ops participate in shape tracking but produce no ConvLayer.

Besides the flat layer list, the tracker records the *network graph*: every
feature-map tensor and the op that produced it, preserving real branch
structure (ResNet residual adds, SqueezeNet fire / Inception concats, the
GoogLeNet pool branch, MobileNetV2/MNASNet inverted-residual skips).
``get_cnn_graph_spec`` exposes it; ``repro_torch.plan.graph`` builds the typed
`NetworkGraph` IR from it. The flat ``get_cnn`` list is unchanged — the graph
is extra structure over the same layers, emitted in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolution layer as the paper's bandwidth model sees it."""

    name: str
    cin: int          # M — input feature maps
    cout: int         # N — output feature maps
    k: int            # kernel size (square)
    wi: int           # input spatial width
    hi: int           # input spatial height
    wo: int           # output spatial width
    ho: int           # output spatial height
    stride: int = 1
    groups: int = 1

    @property
    def in_acts(self) -> int:
        return self.wi * self.hi * self.cin

    @property
    def out_acts(self) -> int:
        return self.wo * self.ho * self.cout

    @property
    def macs(self) -> int:
        return (self.wo * self.ho * self.cout * self.cin // self.groups) * self.k * self.k


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Raw network-graph record from the tracker (untyped; see
    ``repro_torch.plan.graph.NetworkGraph`` for the planning IR).

    tensors — (name, channels, spatial_size) per feature-map tensor, in
              creation order
    nodes   — (op, layer_index, input_tensor_names, output_tensor_name) in
              topological order; op is "input" | "conv" | "pool" | "add";
              layer_index points into ``layers`` for conv nodes, else None.
              Concatenation is represented structurally: a consumer that
              reads a concat simply has several input tensors.
    """

    name: str
    layers: tuple[ConvLayer, ...]
    tensors: tuple[tuple[str, int, int], ...]
    nodes: tuple[tuple[str, "int | None", tuple[str, ...], str], ...]


class _Tracker:
    """Tiny sequential shape tracker: conv / pool ops on a square image.

    Alongside the flat layer list it records every feature-map tensor and the
    producing op, so branchy nets keep their real dataflow. Builders express
    branches by capturing ``t.cur`` (the current tensor bundle) and passing it
    back as ``src=``; joins use ``concat``/``add``.
    """

    def __init__(self, net: str, size: int = 224, cin: int = 3):
        self.net = net
        self.size = size
        self.cin = cin
        self.layers: list[ConvLayer] = []
        self._idx = 0
        self._aux_idx = 0
        self.tensors: list[tuple[str, int, int]] = []
        self.nodes: list[tuple[str, int | None, tuple[str, ...], str]] = []
        image = self._tensor("image", cin, size)
        self.nodes.append(("input", None, (), image))
        self.cur: tuple[str, ...] = (image,)

    # ------------------------------------------------------------- tensors
    def _tensor(self, name: str, channels: int, size: int) -> str:
        self.tensors.append((name, channels, size))
        return name

    def _channels(self, name: str) -> int:
        return next(c for n, c, _ in self.tensors if n == name)

    def _spatial(self, name: str) -> int:
        return next(s for n, _, s in self.tensors if n == name)

    # ----------------------------------------------------------------- ops
    def conv(self, cout: int, k: int, stride: int = 1, pad: int | None = None,
             groups: int = 1, name: str | None = None, cin: int | None = None,
             size_in: int | None = None,
             src: tuple[str, ...] | None = None) -> str:
        if pad is None:
            pad = k // 2 if stride == 1 or k > 1 else 0
        cin = self.cin if cin is None else cin
        wi = self.size if size_in is None else size_in
        wo = (wi + 2 * pad - k) // stride + 1
        self._idx += 1
        layer_name = name or f"{self.net}.conv{self._idx}"
        ins = self.cur if src is None else tuple(src)
        assert sum(self._channels(t) for t in ins) == cin, (
            f"{layer_name}: input tensors {ins} carry "
            f"{sum(self._channels(t) for t in ins)} channels, layer needs {cin}")
        out = self._tensor(f"{layer_name}:out", cout, wo)
        self.nodes.append(("conv", len(self.layers), ins, out))
        self.layers.append(ConvLayer(
            name=layer_name, cin=cin, cout=cout,
            k=k, wi=wi, hi=wi, wo=wo, ho=wo, stride=stride, groups=groups))
        if size_in is None:
            self.size = wo
            self.cin = cout
            self.cur = (out,)
        return out

    def pool(self, k: int = 3, stride: int = 2, pad: int = 0, ceil: bool = False) -> None:
        num = self.size + 2 * pad - k
        new = (math.ceil(num / stride) if ceil else num // stride) + 1
        outs = []
        for t in self.cur:
            self._aux_idx += 1
            out = self._tensor(f"{self.net}.pool{self._aux_idx}:out",
                               self._channels(t), new)
            self.nodes.append(("pool", None, (t,), out))
            outs.append(out)
        self.cur = tuple(outs)
        self.size = new

    def pool_branch(self, src: tuple[str, ...]) -> tuple[str, ...]:
        """Same-size pool branch (3x3, stride 1, pad 1 — the Inception pool
        path). Does not advance the main path."""
        outs = []
        for t in src:
            self._aux_idx += 1
            out = self._tensor(f"{self.net}.pool{self._aux_idx}:out",
                               self._channels(t), self._spatial(t))
            self.nodes.append(("pool", None, (t,), out))
            outs.append(out)
        return tuple(outs)

    def concat(self, members: tuple[str, ...]) -> None:
        """Channel concat: no op node — the consumers simply read all member
        tensors (a concat is a layout convention, not data movement)."""
        self.cur = tuple(members)
        self.cin = sum(self._channels(m) for m in members)

    def add(self, a: str, b: str) -> str:
        """Elementwise residual add of two equal-shape tensors."""
        ca, cb = self._channels(a), self._channels(b)
        assert ca == cb, f"add of mismatched channels {a}({ca}) + {b}({cb})"
        self._aux_idx += 1
        out = self._tensor(f"{self.net}.add{self._aux_idx}:out", ca,
                           self._spatial(a))
        self.nodes.append(("add", None, (a, b), out))
        self.cur = (out,)
        self.cin = ca
        return out

    def spec(self) -> GraphSpec:
        return GraphSpec(name=self.net, layers=tuple(self.layers),
                         tensors=tuple(self.tensors), nodes=tuple(self.nodes))


def _alexnet() -> _Tracker:
    # torchvision alexnet (one-column variant; matches paper Table III exactly).
    t = _Tracker("alexnet")
    t.conv(64, 11, stride=4, pad=2)
    t.pool(3, 2)
    t.conv(192, 5, pad=2)
    t.pool(3, 2)
    t.conv(384, 3, pad=1)
    t.conv(256, 3, pad=1)
    t.conv(256, 3, pad=1)
    return t


def _vgg16() -> _Tracker:
    t = _Tracker("vgg16")
    for reps, cout in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(reps):
            t.conv(cout, 3, pad=1)
        t.pool(2, 2)
    return t


def _squeezenet() -> _Tracker:
    # SqueezeNet 1.0 (arXiv:1602.07360, torchvision squeezenet1_0).
    t = _Tracker("squeezenet")
    t.conv(96, 7, stride=2, pad=0)
    t.pool(3, 2, ceil=True)

    def fire(squeeze: int, expand: int) -> None:
        t.conv(squeeze, 1)
        sq, sq_ch, size = t.cur, t.cin, t.size
        e1 = t.conv(expand, 1)
        # 3x3 expand branch runs in parallel from the squeeze output.
        e3 = t.conv(expand, 3, pad=1, cin=sq_ch, size_in=size, src=sq)
        t.concat((e1, e3))  # concat of the two expand branches

    fire(16, 64); fire(16, 64); fire(32, 128)
    t.pool(3, 2, ceil=True)
    fire(32, 128); fire(48, 192); fire(48, 192); fire(64, 256)
    t.pool(3, 2, ceil=True)
    fire(64, 256)
    t.conv(1000, 1)  # classifier conv
    return t


def _googlenet() -> _Tracker:
    # GoogLeNet (arXiv:1409.4842) with the original 5x5 third branch.
    t = _Tracker("googlenet")
    t.conv(64, 7, stride=2, pad=3)
    t.pool(3, 2, ceil=True)
    t.conv(64, 1)
    t.conv(192, 3, pad=1)
    t.pool(3, 2, ceil=True)

    def inception(b1: int, b2r: int, b2: int, b3r: int, b3: int, b4: int) -> None:
        src, cin, size = t.cur, t.cin, t.size
        o1 = t.conv(b1, 1)
        o2r = t.conv(b2r, 1, cin=cin, size_in=size, src=src)
        o2 = t.conv(b2, 3, pad=1, cin=b2r, size_in=size, src=(o2r,))
        o3r = t.conv(b3r, 1, cin=cin, size_in=size, src=src)
        o3 = t.conv(b3, 5, pad=2, cin=b3r, size_in=size, src=(o3r,))
        pooled = t.pool_branch(src)   # 3x3/s1 pool feeding the 1x1 branch
        o4 = t.conv(b4, 1, cin=cin, size_in=size, src=pooled)
        t.concat((o1, o2, o3, o4))

    inception(64, 96, 128, 16, 32, 32)
    inception(128, 128, 192, 32, 96, 64)
    t.pool(3, 2, ceil=True)
    inception(192, 96, 208, 16, 48, 64)
    inception(160, 112, 224, 24, 64, 64)
    inception(128, 128, 256, 24, 64, 64)
    inception(112, 144, 288, 32, 64, 64)
    inception(256, 160, 320, 32, 128, 128)
    t.pool(3, 2, ceil=True)
    inception(256, 160, 320, 32, 128, 128)
    inception(384, 192, 384, 48, 128, 128)
    return t


def _resnet(depth: int) -> _Tracker:
    t = _Tracker(f"resnet{depth}")
    t.conv(64, 7, stride=2, pad=3)
    t.pool(3, 2, pad=1)

    def basic(cout: int, stride: int) -> None:
        src, cin, size = t.cur, t.cin, t.size
        t.conv(cout, 3, stride=stride, pad=1)
        main = t.conv(cout, 3, pad=1)
        if stride != 1 or cin != cout:
            shortcut = t.conv(cout, 1, stride=stride, pad=0, cin=cin,
                              size_in=size, src=src)
        else:
            shortcut = src[0]
        t.add(main, shortcut)

    def bottleneck(width: int, stride: int) -> None:
        src, cin, size = t.cur, t.cin, t.size
        t.conv(width, 1)
        t.conv(width, 3, stride=stride, pad=1)
        main = t.conv(width * 4, 1)
        if stride != 1 or cin != width * 4:
            shortcut = t.conv(width * 4, 1, stride=stride, pad=0, cin=cin,
                              size_in=size, src=src)
        else:
            shortcut = src[0]
        t.add(main, shortcut)

    if depth == 18:
        plan = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
        block: Callable[[int, int], None] = basic
    elif depth == 50:
        plan = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
        block = bottleneck
    else:
        raise ValueError(depth)
    for width, reps, first_stride in plan:
        for i in range(reps):
            block(width, first_stride if i == 0 else 1)
    return t


def _mobilenet_v2() -> _Tracker:
    # MobileNetV2 (arXiv:1801.04381) — the paper's ref [14] is the V2 paper.
    t = _Tracker("mobilenetv2")
    t.conv(32, 3, stride=2, pad=1)

    def inverted(cout: int, stride: int, expand: int) -> None:
        src, cin = t.cur, t.cin
        use_res = stride == 1 and cin == cout   # torchvision use_res_connect
        hidden = cin * expand
        if expand != 1:
            t.conv(hidden, 1)
        t.conv(hidden, 3, stride=stride, pad=1, groups=hidden)  # depthwise
        out = t.conv(cout, 1)
        if use_res:
            t.add(out, src[0])

    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for expand, cout, reps, stride in cfg:
        for i in range(reps):
            inverted(cout, stride if i == 0 else 1, expand)
    t.conv(1280, 1)
    return t


def _mnasnet() -> _Tracker:
    # MNASNet-B1 depth-multiplier 1.0 (arXiv:1807.11626, torchvision mnasnet1_0).
    t = _Tracker("mnasnet")
    t.conv(32, 3, stride=2, pad=1)
    t.conv(32, 3, pad=1, groups=32)   # sepconv depthwise
    t.conv(16, 1)                      # sepconv pointwise

    def mb(k: int, cout: int, stride: int, expand: int) -> None:
        src, cin = t.cur, t.cin
        use_res = stride == 1 and cin == cout   # torchvision _stacks skip
        hidden = cin * expand
        t.conv(hidden, 1)
        t.conv(hidden, k, stride=stride, pad=k // 2, groups=hidden)
        out = t.conv(cout, 1)
        if use_res:
            t.add(out, src[0])

    cfg = [(3, 3, 24, 2, 3), (3, 5, 40, 2, 3), (3, 5, 80, 2, 6),
           (2, 3, 96, 1, 6), (4, 5, 192, 2, 6), (1, 3, 320, 1, 6)]
    for reps, k, cout, stride, expand in cfg:
        for i in range(reps):
            mb(k, cout, stride if i == 0 else 1, expand)
    t.conv(1280, 1)
    return t


def _mobilenet_v1() -> _Tracker:
    # MobileNetV1 (arXiv:1704.04861). The paper cites the V2 paper [14] but its
    # Table III value (10.273M) matches V1 within 0.9% (V2 gives 13.44M), so V1
    # is kept as an auxiliary entry for table validation.
    t = _Tracker("mobilenetv1")
    t.conv(32, 3, stride=2, pad=1)

    def sep(cout: int, stride: int = 1) -> None:
        t.conv(t.cin, 3, stride=stride, pad=1, groups=t.cin)
        t.conv(cout, 1)

    sep(64); sep(128, 2); sep(128); sep(256, 2); sep(256); sep(512, 2)
    for _ in range(5):
        sep(512)
    sep(1024, 2); sep(1024)
    return t


_BUILDERS: dict[str, Callable[[], _Tracker]] = {
    "alexnet": _alexnet,
    "vgg16": _vgg16,
    "squeezenet": _squeezenet,
    "googlenet": _googlenet,
    "resnet18": lambda: _resnet(18),
    "resnet50": lambda: _resnet(50),
    "mobilenet": _mobilenet_v2,
    "mobilenetv1": _mobilenet_v1,   # auxiliary: matches the paper's numbers
    "mnasnet": _mnasnet,
}

PAPER_CNNS: tuple[str, ...] = ("alexnet", "vgg16", "squeezenet", "googlenet",
                               "resnet18", "resnet50", "mobilenet", "mnasnet")

# Table III of the paper, million activations / inference (for validation).
PAPER_TABLE3 = {
    "alexnet": 0.823, "vgg16": 20.095, "squeezenet": 7.304, "googlenet": 7.889,
    "resnet18": 4.666, "resnet50": 28.349, "mobilenet": 10.273, "mnasnet": 11.001,
}


def get_cnn(name: str) -> list[ConvLayer]:
    try:
        return list(_BUILDERS[name]().layers)
    except KeyError:
        raise KeyError(f"unknown CNN {name!r}; known: {sorted(_BUILDERS)}") from None


def get_cnn_graph_spec(name: str) -> GraphSpec:
    """The network *graph* of a zoo CNN: the same conv layers as ``get_cnn``
    (same order, same fields) plus the feature-map tensors and the dataflow
    that connects them (branches, pools, residual adds)."""
    try:
        return _BUILDERS[name]().spec()
    except KeyError:
        raise KeyError(f"unknown CNN {name!r}; known: {sorted(_BUILDERS)}") from None
