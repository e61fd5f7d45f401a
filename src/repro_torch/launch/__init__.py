"""Launchers of the port: ``serve`` (batched prefill + decode), ``graph``
(the compiled serving steps), ``planserve`` (the planner as a service),
``train`` and ``mesh`` (meshes over the standing process group)."""
