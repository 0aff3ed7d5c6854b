"""CSV metrics log (port of ``training/metrics.py``, without wandb).

Rows are appended to ``metrics.csv`` at each flush; the header is written
only when the file is new, so a resumed run keeps the earlier rows. (The
JAX logger rewrites the file in ``'w'`` mode from the rows of the current
process, which drops the history of the run before a resume.) Tensor
values are read to the host only at ``flush``.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path


class MetricsLogger:
    """Append-only CSV logger. The columns are fixed by the first flush into
    a new file (or read from an existing file's header); a later metric not
    among them raises."""

    def __init__(self, output_dir: str | Path):
        self.path = Path(output_dir) / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._rows: list[dict] = []
        self._fieldnames: list[str] | None = None
        if self.path.exists() and self.path.stat().st_size > 0:
            with open(self.path, newline="") as f:
                self._fieldnames = next(csv.reader(f))

    def log(self, metrics: dict, step: int) -> None:
        self._rows.append({"step": step, "time": time.time(), **metrics})

    def flush(self, fieldnames: list[str] | None = None) -> None:
        """Append the pending rows. ``fieldnames`` fixes the columns of a new
        file (default: the keys of the pending rows, in order of appearance)."""
        if not self._rows:
            return
        new = self._fieldnames is None
        if new:
            names = list(fieldnames or [])
            for row in self._rows:
                names += [k for k in row if k not in names]
            self._fieldnames = names
        extra = {k for row in self._rows for k in row} - set(self._fieldnames)
        if extra:
            raise ValueError(f"metrics not among the columns of {self.path}: {sorted(extra)}")
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if new:
                writer.writeheader()
            for row in self._rows:
                writer.writerow({k: float(v) if hasattr(v, "item") else v for k, v in row.items()})
        self._rows = []

    def close(self) -> None:
        self.flush()
