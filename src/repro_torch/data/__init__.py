"""Data of the port: the synthetic LM stream (`DataConfig`, `SyntheticLM`)
and the modality-frontend stubs (`make_extra_inputs`)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_extra_inputs

__all__ = ["DataConfig", "SyntheticLM", "make_extra_inputs"]
