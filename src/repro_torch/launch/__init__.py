"""Launchers of the port: ``serve`` (batched prefill + decode)."""
