"""The port's training runtime: the fault-tolerant loop
(`trainer.Trainer`), the counterpart of the reference's
``repro/runtime/trainer.py``. The reference's pipeline and elastic runtimes
belong to the distributed layer (ROADMAP A9)."""

from repro_torch.runtime.trainer import (StragglerDetector, Trainer,
                                         TrainLoopConfig)

__all__ = ["StragglerDetector", "Trainer", "TrainLoopConfig"]
