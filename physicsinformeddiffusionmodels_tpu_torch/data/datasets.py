"""Darcy dataset and batch iterators (port of the Darcy part of
``data/datasets.py``).

Arrays are NHWC numpy [N, P, P, 2] (channel 0 pressure, 1 permeability),
the layout ``DarcyResidual`` takes. ``stacked()`` gives the whole set as one
array, which the trainer moves to the device once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class DarcyDataset:
    """In-memory (p, K) field pairs as one [N, P, P, 2] float32 array."""

    def __init__(self, fields: np.ndarray):
        if fields.ndim != 4 or fields.shape[-1] != 2:
            raise ValueError(f"expected [N, P, P, 2] fields, got {fields.shape}")
        self.fields = np.asarray(fields, np.float32)

    def __len__(self) -> int:
        return self.fields.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.fields[i]

    def stacked(self) -> np.ndarray:
        return self.fields


def load_darcy_dataset(root: str | Path) -> DarcyDataset:
    """Load ``p_data.csv`` / ``K_data.csv`` as the Darcy generator writes them
    (one flattened [P*P] sample per row)."""
    root = Path(root)
    p = np.loadtxt(root / "p_data.csv", delimiter=",", ndmin=2)
    K = np.loadtxt(root / "K_data.csv", delimiter=",", ndmin=2)
    if p.shape != K.shape:
        raise ValueError(f"p_data {p.shape} and K_data {K.shape} differ")
    P = int(round(np.sqrt(p.shape[1])))
    if P * P != p.shape[1]:
        raise ValueError(f"non-square samples: {p.shape[1]} values")
    fields = np.stack([p.reshape(-1, P, P), K.reshape(-1, P, P)], axis=-1)
    return DarcyDataset(fields.astype(np.float32))


def iter_batches(dataset, batch_size: int, *, drop_remainder: bool = False):
    """One sequential pass over ``dataset`` in batches."""
    stacked = dataset.stacked()
    for start in range(0, stacked.shape[0], batch_size):
        batch = stacked[start:start + batch_size]
        if drop_remainder and batch.shape[0] < batch_size:
            return
        yield batch


def cycle_batches(dataset, batch_size: int, *, seed: int = 0):
    """Infinite shuffled batch iterator. Reshuffles every epoch; a short
    epoch tail is carried into the next epoch, so every batch has exactly
    ``batch_size`` samples."""
    stacked = dataset.stacked()
    n = stacked.shape[0]
    batch_size = min(batch_size, n)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    while True:
        if pos + batch_size > n:
            order = np.concatenate([order[pos:], rng.permutation(n)])
            pos = 0
        idx = order[pos:pos + batch_size]
        pos += batch_size
        yield stacked[idx]
