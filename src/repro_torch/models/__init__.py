"""Model substrate of the port: the dense layer library, the dense
decoder-only stack and its serving steps."""
