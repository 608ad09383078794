"""Metrics sinks: JSONL always, wandb where it is installed and asked for
(port of ``splatpu/obs/metrics.py``).

``log`` keeps tensors as they are; ``flush`` fetches every buffered tensor
in one batched copy to the host (one ``torch.stack(...).cpu()`` per device
and dtype), never one ``.item()`` per value, and writes one JSON row
``{"step", "ts", **metrics}`` per logged step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional

import torch


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[Path] = None, use_wandb: bool = False,
                 wandb_project: Optional[str] = None, flush_every: int = 50):
        self._path = Path(jsonl_path) if jsonl_path else None
        self._file = None
        self._buffer: list[tuple[int, dict[str, Any]]] = []
        self._flush_every = flush_every
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project or "splatpu")
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: dict[str, Any], step: int):
        """Python scalars or tensors; tensors are fetched at the flush."""
        self._buffer.append((step, dict(metrics)))
        if len(self._buffer) >= self._flush_every:
            self.flush()

    def _fetch(self) -> dict[int, float]:
        """id -> float of every buffered tensor, one copy per (device, dtype)."""
        groups: dict[tuple, list[torch.Tensor]] = {}
        for _, metrics in self._buffer:
            for v in metrics.values():
                if isinstance(v, torch.Tensor):
                    groups.setdefault((v.device, v.dtype), []).append(v)
        out = {}
        for tensors in groups.values():
            host = torch.stack([t.detach().reshape(()) for t in tensors]).cpu().double()
            out.update({id(t): float(x) for t, x in zip(tensors, host.tolist())})
        return out

    def flush(self):
        if not self._buffer:
            return
        if self._path and self._file is None:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._file = self._path.open("a")
        fetched = self._fetch()
        for step, metrics in self._buffer:
            concrete = {
                k: fetched[id(v)] if isinstance(v, torch.Tensor)
                else (float(v) if isinstance(v, (int, float)) else v)
                for k, v in metrics.items()
            }
            if self._file:
                self._file.write(json.dumps({"step": step, "ts": time.time(), **concrete}) + "\n")
            if self._wandb:
                self._wandb.log(concrete, step=step)
        self._buffer.clear()
        if self._file:
            self._file.flush()

    def log_video(self, name: str, frames, fps: int = 30, step: Optional[int] = None):
        """A wandb video of (H, W, 3) uint8 frames; nothing without wandb."""
        if self._wandb is None:
            return
        import numpy as np

        arr = np.transpose(np.stack(frames), (0, 3, 1, 2))
        self._wandb.log({name: self._wandb.Video(arr, fps=fps, format="mp4")}, step=step)

    def save_run_files(self, run_dir):
        """Every file under ``run_dir`` saved to the wandb run; nothing
        without wandb."""
        if self._wandb is None:
            return
        run_dir = Path(run_dir)
        for f in sorted(run_dir.rglob("*")):
            if f.is_file():
                self._wandb.save(str(f), base_path=str(run_dir), policy="now")

    def close(self):
        self.flush()
        if self._file:
            self._file.close()
            self._file = None
