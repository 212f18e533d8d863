"""Host-side control plane: the loader's work-stealing queue and the
straggler monitor."""
from .straggler import StepTimeMonitor, WorkStealingQueue

__all__ = ["StepTimeMonitor", "WorkStealingQueue"]
