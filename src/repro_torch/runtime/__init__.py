"""The fault-tolerant training runtime of the port (counterpart of the JAX
package's `repro.runtime`)."""

from .trainer import StepWatchdog, Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "StepWatchdog"]
