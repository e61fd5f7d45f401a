"""The port's training runtime: the fault-tolerant loop
(`trainer.Trainer`), the GPipe pipeline over the pod axis (`pipeline`) and
the elastic restart on a smaller mesh (`elastic`), the counterparts of the
reference's ``repro/runtime/trainer.py``, ``pipeline.py`` and
``elastic.py``."""

from repro_torch.runtime.trainer import (StragglerDetector, Trainer,
                                         TrainLoopConfig)

__all__ = ["StragglerDetector", "Trainer", "TrainLoopConfig"]
