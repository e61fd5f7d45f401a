"""The paper's networks and its controller: the eight CNNs as layer tables
and graphs (`cnn_zoo`), the active memory controller's executable meter
(`amc`) and the per-layer network planner wrapper (`planner`)."""

from repro_torch.core.cnn_zoo import (PAPER_CNNS, ConvLayer, GraphSpec,
                                      get_cnn, get_cnn_graph_spec)

__all__ = ["PAPER_CNNS", "ConvLayer", "GraphSpec", "get_cnn",
           "get_cnn_graph_spec"]
