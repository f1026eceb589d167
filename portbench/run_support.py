"""Small helpers the run and the system modules share."""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Snapshots:
    """Copies of the program's state that the correctness check reads after
    the window, and the device's peak without them: each copy's bytes are
    taken off the peak of the stretch in which the copy was held, so
    `peak` is what the program itself held at most."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.held = 0
        self.best = 0

    def _mark(self) -> None:
        if self.cuda:
            self.best = max(self.best, torch.cuda.max_memory_allocated() - self.held)

    def hold(self, t: torch.Tensor) -> torch.Tensor:
        self._mark()
        before = torch.cuda.memory_allocated() if self.cuda else 0
        c = t.clone()
        if self.cuda:
            self.held += torch.cuda.memory_allocated() - before
            torch.cuda.reset_peak_memory_stats()
        return c

    def peak(self) -> int:
        self._mark()
        return int(self.best)
