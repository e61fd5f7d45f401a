"""Launchers of the port: ``serve`` (batched prefill + decode), ``graph``
(the compiled serving steps) and ``planserve`` (the planner as a service)."""
