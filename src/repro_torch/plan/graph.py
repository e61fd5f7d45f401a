"""Network-graph IR: nodes are `ConvWorkload`s, edges are feature-map tensors.

  `Tensor`        one feature map (channels x h x w)
  `Node`          one op: a conv workload, or a virtual op (input / pool /
                  add) that moves no modelled traffic
  `NetworkGraph`  topologically ordered nodes + tensors, with producer and
                  consumer maps

Concatenation is structural, not an op: a consumer that reads a concat has
several input tensors (its ``cin`` is the channel sum).

``NetworkGraph.from_cnn`` builds a zoo net with its real branch structure;
``shrink()`` gives the structurally identical stride-1, "same"-padded graph
that the kernel runner executes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan.workload import ConvWorkload

VIRTUAL_OPS = ("input", "pool", "add")


@dataclasses.dataclass(frozen=True)
class Tensor:
    """One feature-map tensor flowing along an edge."""

    name: str
    channels: int
    h: int
    w: int
    word_bytes: int = 4

    @property
    def words(self) -> int:
        return self.channels * self.h * self.w


@dataclasses.dataclass(frozen=True)
class Node:
    """One graph op. ``workload`` is set for "conv" ops and None for virtual
    ops."""

    name: str
    op: str                       # "conv" | a VIRTUAL_OPS entry
    ins: tuple[str, ...]          # input tensor names
    out: str                      # output tensor name
    workload: ConvWorkload | None = None


class NetworkGraph:
    """Topologically ordered dataflow graph over feature-map tensors."""

    def __init__(self, name: str, nodes: tuple[Node, ...],
                 tensors: dict[str, Tensor]):
        self.name = name
        self.nodes = tuple(nodes)
        self.tensors = dict(tensors)
        self.producer: dict[str, int] = {}
        self.consumers: dict[str, tuple[int, ...]] = {t: () for t in tensors}
        seen_names = set()
        for i, node in enumerate(self.nodes):
            if node.name in seen_names:
                # schedules are keyed on node names downstream
                raise ValueError(f"duplicate node name {node.name!r}")
            seen_names.add(node.name)
            if node.out in self.producer:
                raise ValueError(f"tensor {node.out!r} produced twice")
            self.producer[node.out] = i
            for t in node.ins:
                self.consumers[t] = self.consumers.get(t, ()) + (i,)
        self.validate()

    @property
    def workload_nodes(self) -> tuple[Node, ...]:
        """The conv nodes, in topological order (for zoo graphs, the order of
        ``get_cnn``'s flat layer list)."""
        return tuple(n for n in self.nodes if n.workload is not None)

    @property
    def workloads(self) -> tuple[ConvWorkload, ...]:
        return tuple(n.workload for n in self.workload_nodes)

    @property
    def inputs(self) -> tuple[str, ...]:
        """Tensors entering from outside (produced by "input" nodes)."""
        return tuple(n.out for n in self.nodes if n.op == "input")

    @property
    def outputs(self) -> tuple[str, ...]:
        """Tensors leaving the network (no consumer)."""
        return tuple(t for t in self.tensors if not self.consumers[t])

    def validate(self) -> None:
        for i, node in enumerate(self.nodes):
            for t in node.ins:
                if t not in self.tensors:
                    raise ValueError(f"{node.name}: unknown tensor {t!r}")
                if self.producer[t] >= i:
                    raise ValueError(f"{node.name}: consumes {t!r} before "
                                     f"production (not topological)")
            wl = node.workload
            if wl is None:
                if node.op not in VIRTUAL_OPS:
                    raise ValueError(f"{node.name}: op {node.op!r} without "
                                     f"workload")
                continue
            in_words = sum(self.tensors[t].words for t in node.ins)
            if in_words != wl.in_acts:
                raise ValueError(
                    f"{node.name}: input tensors carry {in_words} words, "
                    f"workload reads {wl.in_acts}")
            out_words = self.tensors[node.out].words
            if out_words != wl.out_acts:
                raise ValueError(
                    f"{node.name}: output tensor {out_words} words != "
                    f"workload {wl.out_acts}")

    @classmethod
    def from_cnn(cls, name: str, word_bytes: int = 4) -> "NetworkGraph":
        """The real branch structure of a `repro_torch.core.cnn_zoo` net."""
        from repro_torch.core.cnn_zoo import get_cnn_graph_spec
        spec = get_cnn_graph_spec(name)
        tensors = {tn: Tensor(name=tn, channels=c, h=s, w=s,
                              word_bytes=word_bytes)
                   for tn, c, s in spec.tensors}
        nodes = []
        for op, layer_idx, ins, out in spec.nodes:
            if op == "conv":
                layer = spec.layers[layer_idx]
                nodes.append(Node(name=layer.name, op="conv", ins=ins, out=out,
                                  workload=dataclasses.replace(
                                      ConvWorkload.from_layer(layer),
                                      word_bytes=word_bytes)))
            else:
                node_name = out[:-4] if out.endswith(":out") else out
                nodes.append(Node(name=node_name, op=op, ins=ins, out=out))
        return cls(name=name, nodes=tuple(nodes), tensors=tensors)

    def shrink(self, spatial: int = 8, channel_div: int = 1) -> "NetworkGraph":
        """A structurally identical conv graph at reduced scale: every tensor
        becomes ``max(1, channels // channel_div)`` x spatial x spatial and
        every conv runs stride 1 with "same" padding."""
        def sc(c: int) -> int:
            return max(1, c // channel_div)

        tensors = {tn: dataclasses.replace(t, channels=sc(t.channels),
                                           h=spatial, w=spatial)
                   for tn, t in self.tensors.items()}
        nodes = []
        for node in self.nodes:
            wl = node.workload
            if wl is None:
                nodes.append(node)
                continue
            cin = sum(tensors[t].channels for t in node.ins)
            cout = tensors[node.out].channels
            if wl.groups == 1:
                groups = 1
            elif wl.groups == wl.cin:
                groups = cin               # depthwise stays depthwise
            else:
                raise ValueError(f"cannot shrink grouped conv {wl.name}")
            nodes.append(dataclasses.replace(
                node, workload=dataclasses.replace(
                    wl, cin=cin, cout=cout, wi=spatial, hi=spatial,
                    wo=spatial, ho=spatial, stride=1, groups=groups)))
        return NetworkGraph(name=f"{self.name}@{spatial}px/{channel_div}",
                            nodes=tuple(nodes), tensors=tensors)

    def __repr__(self) -> str:
        return (f"NetworkGraph({self.name!r}, "
                f"{len(self.workload_nodes)} workloads, "
                f"{len(self.nodes)} nodes, {len(self.tensors)} tensors)")
