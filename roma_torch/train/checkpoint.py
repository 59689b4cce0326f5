"""Checkpoints: ``torch.save`` of the model, the optimizer, the step
counters and an optional EMA, keeping the newest `keep`, with a latest
pointer that `load` reads. (The reference's auto-resume looks for a file
its save never writes; here `save` writes the pointer `load` reads.)"""

from __future__ import annotations

import os
from pathlib import Path

import torch


class CheckPoint:
    def __init__(self, dir: str, name: str = "model", keep: int = 3):
        self.root = Path(dir).resolve() / name
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.root / f"step_{step:012d}.pth"

    def steps(self) -> list[int]:
        return sorted(int(p.stem[len("step_"):]) for p in self.root.glob("step_*.pth"))

    def save(self, state, step: int | None = None, ema=None) -> int:
        """Write `state` (and `ema`) at `step` (default: state.step), move the
        latest pointer to it, and drop all but the newest `keep`."""
        step = int(step if step is not None else state.step)
        blob = {"step": state.step, "updates": state.updates,
                "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "ema": ema}
        path = self._path(step)
        tmp = path.with_suffix(".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        pointer = self.root / "latest"
        (self.root / "latest.tmp").write_text(path.name)
        os.replace(self.root / "latest.tmp", pointer)
        for old in self.steps()[:-self.keep]:
            self._path(old).unlink()
        return step

    def latest_step(self) -> int | None:
        pointer = self.root / "latest"
        if not pointer.exists():
            return None
        return int(Path(pointer.read_text().strip()).stem[len("step_"):])

    def load(self, state, step: int | None = None, ema=None):
        """Restore into `state` (and the tensors of `ema`, when both were
        saved) from `step`, by default the latest pointer's; returns
        `state` unchanged when there is no checkpoint (a fresh start)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        device = next(state.model.parameters()).device
        blob = torch.load(self._path(step), map_location=device, weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step, state.updates = int(blob["step"]), int(blob["updates"])
        if ema is not None and blob["ema"] is not None:
            for name, t in ema.items():
                t.copy_(blob["ema"][name])
        return state
