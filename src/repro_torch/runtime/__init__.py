"""Training runtime of the port, mirroring ``repro.runtime``: the fault
wrappers (``fault``) and the training loop (``trainer``)."""
from .fault import FaultTolerantStep, StragglerDetector, retry_with_backoff
from .trainer import Trainer, TrainerConfig

__all__ = ["FaultTolerantStep", "StragglerDetector", "retry_with_backoff",
           "Trainer", "TrainerConfig"]
