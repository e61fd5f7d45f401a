"""Optimizers of the port: AdamW with fp32 master weights (`adamw`), the
counterpart of the reference's ``repro/optim/adamw.py``. The reference's
int8 error-feedback compression (``optim/compress.py``) belongs to the
distributed layer (ROADMAP A9)."""

from repro_torch.optim import adamw

__all__ = ["adamw"]
