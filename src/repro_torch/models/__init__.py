"""Model substrate of the port: the dense layer library, the mixture of
experts, the decoder-only stack of dense or MoE layers and its serving
steps."""
