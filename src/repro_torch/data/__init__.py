"""Data of the port: the modality-frontend stubs (`make_extra_inputs`).
The synthetic LM stream (``SyntheticLM``) waits for the training slice
(ROADMAP A8)."""

from repro_torch.data.pipeline import make_extra_inputs

__all__ = ["make_extra_inputs"]
