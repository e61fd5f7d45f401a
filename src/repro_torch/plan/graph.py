"""Network-graph IR: nodes are `Workload`s, edges are feature-map tensors.

  `Tensor`        one feature map (channels x h x w) and its bytes
  `Node`          one op: a conv/matmul workload, or a virtual op (input /
                  pool / add / attn / act / route) that moves no modelled
                  traffic
  `NetworkGraph`  topologically ordered nodes + tensors, with producer and
                  consumer maps and live intervals

Concatenation is structural, not an op: a consumer that reads a concat has
several input tensors (its ``cin`` is the channel sum).

Builders: ``NetworkGraph.from_cnn`` (a zoo net with its real branch
structure), ``from_layers`` (any layer list as a linear chain) and
``from_transformer`` (one decoder block + LM head of an ``ArchConfig`` as a
GEMM chain). ``shrink()`` gives the structurally identical stride-1,
"same"-padded conv graph that the kernel runner executes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload

VIRTUAL_OPS = ("input", "pool", "add", "attn", "act", "route")


@dataclasses.dataclass(frozen=True)
class Tensor:
    """One feature-map (or activation) tensor flowing along an edge."""

    name: str
    channels: int
    h: int
    w: int
    word_bytes: int = 4

    @property
    def words(self) -> int:
        return self.channels * self.h * self.w

    @property
    def nbytes(self) -> int:
        return nbytes(self.words, self.word_bytes)


@dataclasses.dataclass(frozen=True)
class Node:
    """One graph op. ``workload`` is set for "conv"/"matmul" ops and None
    for virtual ops."""

    name: str
    op: str                       # "conv" | "matmul" | a VIRTUAL_OPS entry
    ins: tuple[str, ...]          # input tensor names
    out: str                      # output tensor name
    workload: Workload | None = None


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
        """The traffic-carrying nodes (convs/matmuls), in topological order
        (for zoo graphs, the order of ``get_cnn``'s flat layer list)."""
        return tuple(n for n in self.nodes if n.workload is not None)

    @property
    def workloads(self) -> tuple[Workload, ...]:
        return tuple(n.workload for n in self.workload_nodes)

    @property
    def inputs(self) -> tuple[str, ...]:
        """Tensors entering from outside (produced by "input" nodes)."""
        return tuple(n.out for n in self.nodes if n.op == "input")

    @property
    def outputs(self) -> tuple[str, ...]:
        """Tensors leaving the network (no consumer)."""
        return tuple(t for t in self.tensors if not self.consumers[t])

    def live_ranges(self) -> dict[str, tuple[int, int]]:
        """tensor -> (producing step, last consuming step) over node indices.
        A tensor held resident occupies the budget for this whole interval."""
        return {t: (self.producer[t],
                    max(self.consumers[t]) if self.consumers[t]
                    else self.producer[t])
                for t in self.tensors}

    def edge_list(self) -> list[tuple[str, int, tuple[int, ...]]]:
        """(tensor, producer step, consumer steps) for every tensor."""
        return [(t, self.producer[t], self.consumers[t])
                for t in self.tensors]

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
            out_words = self.tensors[node.out].words
            if isinstance(wl, ConvWorkload):
                if in_words != wl.in_acts:
                    raise ValueError(
                        f"{node.name}: input tensors carry {in_words} words, "
                        f"workload reads {wl.in_acts}")
                if out_words != wl.out_acts:
                    raise ValueError(
                        f"{node.name}: output tensor {out_words} words != "
                        f"workload {wl.out_acts}")
            elif isinstance(wl, MatmulWorkload):
                if in_words != wl.m * wl.k:
                    raise ValueError(
                        f"{node.name}: input tensors carry {in_words} words, "
                        f"GEMM reads {wl.m * wl.k}")
                if out_words != wl.m * wl.n:
                    raise ValueError(
                        f"{node.name}: output tensor {out_words} words != "
                        f"GEMM {wl.m * wl.n}")

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

    @classmethod
    def from_layers(cls, layers, name: str | None = None,
                    word_bytes: int = 4) -> "NetworkGraph":
        """Any iterable of ConvLayers / ConvWorkloads as a linear chain.

        Consecutive layers are wired producer->consumer when the shapes agree
        (cout/wo of one == cin/wi of the next); otherwise a fresh external
        input tensor is introduced, so any layer list (repeated layers
        included) builds a valid graph.
        """
        wls = [wl if isinstance(wl, ConvWorkload)
               else dataclasses.replace(ConvWorkload.from_layer(wl),
                                        word_bytes=word_bytes)
               for wl in layers]
        if name is None:
            name = wls[0].name.split(".")[0] if wls else "custom"
        tensors: dict[str, Tensor] = {}
        nodes: list[Node] = []
        seen: dict[str, int] = {}
        prev: Tensor | None = None
        for i, wl in enumerate(wls):
            if (prev is not None and prev.channels == wl.cin
                    and prev.h == wl.hi and prev.w == wl.wi):
                src = prev
            else:
                src = Tensor(name=f"{name}.in{i}", channels=wl.cin, h=wl.hi,
                             w=wl.wi, word_bytes=word_bytes)
                tensors[src.name] = src
                nodes.append(Node(name=f"{name}.input{i}", op="input", ins=(),
                                  out=src.name))
            # Repeated layer names (repeated blocks) get a #i suffix so node
            # names and tensor names stay unique.
            node_name = wl.name
            if node_name in seen:
                node_name = f"{wl.name}#{i}"
            seen[node_name] = i
            out = Tensor(name=f"{node_name}:out", channels=wl.cout, h=wl.ho,
                         w=wl.wo, word_bytes=word_bytes)
            tensors[out.name] = out
            nodes.append(Node(name=node_name, op="conv", ins=(src.name,),
                              out=out.name, workload=wl))
            prev = out
        return cls(name=name, nodes=tuple(nodes), tensors=tensors)

    @classmethod
    def from_transformer(cls, cfg, *, seq_len: int = 4096, batch: int = 1,
                         include_lm_head: bool = True) -> "NetworkGraph":
        """One decoder block (+ optional LM head) of a transformer
        ``ArchConfig`` as a GEMM chain: qkv -> attention -> out-proj ->
        residual add -> FFN up -> activation -> FFN down -> residual add.
        Edges are the token-major activation tensors, their word width the
        workloads' operand width; MoE configs route a top_k-scaled token
        subset through the expert GEMMs."""
        from repro_torch.plan.workload import transformer_matmuls
        gemms = {wl.name.rsplit("/", 1)[1]: wl
                 for wl in transformer_matmuls(cfg, seq_len=seq_len,
                                               batch=batch,
                                               include_lm_head=include_lm_head)}
        t = batch * seq_len
        d = cfg.d_model
        q_out = cfg.n_heads * cfg.hd
        wb = next(iter(gemms.values())).in_dtype.itemsize
        tensors: dict[str, Tensor] = {}
        nodes: list[Node] = []

        def tensor(tn: str, feats: int, toks: int = t) -> str:
            tensors[tn] = Tensor(name=tn, channels=feats, h=1, w=toks,
                                 word_bytes=wb)
            return tn

        def gemm(key: str, src: str, out_name: str, toks: int = t) -> str:
            wl = gemms[key]
            out = tensor(out_name, wl.n, toks)
            nodes.append(Node(name=wl.name, op="matmul", ins=(src,), out=out,
                              workload=wl))
            return out

        def virtual(op: str, vname: str, ins: tuple[str, ...], out_feats: int,
                    toks: int = t) -> str:
            out = tensor(f"{vname}:out", out_feats, toks)
            nodes.append(Node(name=vname, op=op, ins=ins, out=out))
            return out

        embed = tensor("embed", d)
        nodes.insert(0, Node(name="input", op="input", ins=(), out=embed))
        qkv = gemm("qkv", embed, "qkv:out")
        ctx = virtual("attn", f"{cfg.name}/attn", (qkv,), q_out)
        proj = gemm("attn_out", ctx, "attn_proj:out")
        resid1 = virtual("add", f"{cfg.name}/add1", (embed, proj), d)
        if cfg.moe is not None:
            te = gemms["expert_up"].m
            routed = virtual("route", f"{cfg.name}/route", (resid1,), d, te)
            up = gemm("expert_up", routed, "ffn_up:out", te)
            hidden = virtual("act", f"{cfg.name}/act", (up,),
                             cfg.moe.expert_ff, te)
            down = gemm("expert_down", hidden, "ffn_down:out", te)
            back = virtual("route", f"{cfg.name}/unroute", (down,), d)
            resid2 = virtual("add", f"{cfg.name}/add2", (resid1, back), d)
        else:
            up = gemm("ffn_up", resid1, "ffn_up:out")
            hidden = virtual("act", f"{cfg.name}/act", (up,), cfg.d_ff)
            down = gemm("ffn_down", hidden, "ffn_down:out")
            resid2 = virtual("add", f"{cfg.name}/add2", (resid1, down), d)
        if include_lm_head:
            gemm("lm_head", resid2, "logits")
        return cls(name=cfg.name, nodes=tuple(nodes), tensors=tensors)

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
            if not isinstance(wl, ConvWorkload):
                raise TypeError("shrink() supports conv graphs only")
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
