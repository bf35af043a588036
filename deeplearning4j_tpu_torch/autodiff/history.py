"""Training history (reference org.nd4j.autodiff.listeners.records.History).

Counterpart of ``deeplearning4j_tpu/autodiff/history.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class History:
    def __init__(self) -> None:
        self._epoch_losses: List[float] = []
        self._epochs: List[int] = []
        self._evaluations: Dict[str, List[float]] = {}

    def add_epoch(self, epoch: int, loss: float) -> None:
        self._epochs.append(epoch)
        self._epoch_losses.append(loss)

    def add_evaluation(self, name: str, value: float) -> None:
        self._evaluations.setdefault(name, []).append(value)

    def loss_curve(self) -> List[float]:
        return list(self._epoch_losses)

    def final_loss(self) -> Optional[float]:
        return self._epoch_losses[-1] if self._epoch_losses else None

    def __repr__(self) -> str:
        return (f"History(epochs={len(self._epochs)}, "
                f"final_loss={self.final_loss()})")
