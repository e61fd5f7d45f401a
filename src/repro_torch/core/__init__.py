"""Network descriptions: the paper's eight CNNs as layer tables and graphs."""

from repro_torch.core.cnn_zoo import (PAPER_CNNS, ConvLayer, GraphSpec,
                                      get_cnn, get_cnn_graph_spec)

__all__ = ["PAPER_CNNS", "ConvLayer", "GraphSpec", "get_cnn",
           "get_cnn_graph_spec"]
