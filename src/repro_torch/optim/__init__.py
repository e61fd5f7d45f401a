"""Optimizers of the port: AdamW with fp32 master weights (`adamw`) and
the int8 error-feedback all-reduce of data-parallel gradients
(`compress`), the counterparts of the reference's ``repro/optim/adamw.py``
and ``optim/compress.py``."""

from repro_torch.optim import adamw, compress

__all__ = ["adamw", "compress"]
