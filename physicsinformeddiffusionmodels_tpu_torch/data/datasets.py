"""Datasets, column normalisation and batch iterators (port of
``data/datasets.py``).

Arrays are NHWC numpy: Darcy [N, P, P, 2] (channel 0 pressure, 1
permeability), the layout ``DarcyResidual`` takes; mechanics [N, 65, 65, 10]
(channels vf, strain-energy density, von Mises, disp_x, disp_y, E field,
BC_node_x, BC_node_y, load_x, load_y), one ``<i>.npy`` file a sample.
``stacked()`` gives the whole set as one array, which the trainer moves to
the device once.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def _numeric_key(path: Path):
    """Sort '12.npy' by its number; stems without a number after those, by name."""
    m = re.search(r"(\d+)", path.stem)
    return (0, int(m.group(1)), path.stem) if m else (1, 0, path.stem)


class NpyFieldDataset:
    """A directory of per-sample ``*.npy`` field files in numeric order:
    [nn, nn, 10] NHWC, or [10, nn, nn], which is transposed to NHWC."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.paths = sorted(self.root.glob("*.npy"), key=_numeric_key)
        if not self.paths:
            raise FileNotFoundError(f"no .npy files under {self.root}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        arr = np.load(self.paths[i])
        if arr.ndim == 3 and arr.shape[0] == 10 and arr.shape[-1] != 10:
            arr = np.transpose(arr, (1, 2, 0))
        return np.asarray(arr, np.float32)

    def stacked(self) -> np.ndarray:
        """[N, nn, nn, 10]: the whole set as one array."""
        return np.stack([self[i] for i in range(len(self))])


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


def sample_images_with_squares(no_points: int, pixels_per_dim: int, dim: int,
                               rng: np.random.Generator | None = None) -> np.ndarray:
    """Debug images: one random solid square a quarter of the side wide in
    each sample, the same in every channel; NHWC [N, P, P, dim] float32."""
    rng = rng or np.random.default_rng(0)
    size = pixels_per_dim // 4
    images = np.zeros((no_points, pixels_per_dim, pixels_per_dim, dim), np.float32)
    starts = rng.integers(0, pixels_per_dim - size, (no_points, 2))
    for i, (x0, y0) in enumerate(starts):
        images[i, x0:x0 + size, y0:y0 + size, :] = 1.0
    return images


class SquareImagesDataset:
    """A shape-level smoke-test dataset of random squares, no physics."""

    def __init__(self, no_points: int, pixels_per_dim: int, dim: int, seed: int = 0):
        self.data = sample_images_with_squares(no_points, pixels_per_dim, dim,
                                               np.random.default_rng(seed))

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.data[i]

    def stacked(self) -> np.ndarray:
        return self.data


class Normalization:
    """Column-wise normalisation of [N, C] data with statistics of the
    constructor's data: 'min-max-1' ([0, 1] per column), 'global-min-max-1',
    'min-max-2' ([-1, 1] per column), 'global-min-max-2', 'mean-std'
    (ddof=1) or 'none'. ``normalize`` one-hot encodes the categorical
    columns after the continuous block; ``unnormalize`` passes them through."""

    STRATEGIES = ("min-max-1", "global-min-max-1", "min-max-2", "global-min-max-2",
                  "mean-std", "none")

    def __init__(self, data, data_type: list[str], strategy: str):
        if strategy not in self.STRATEGIES:
            raise ValueError(f"Incorrect normalization strategy: {strategy!r}")
        data = np.asarray(data)
        self.mu = data.mean(axis=0)
        self.std = data.std(axis=0, ddof=1)
        self.min, self.max = data.min(axis=0), data.max(axis=0)
        self.globalmin, self.globalmax = data.min(), data.max()
        self.data_type = list(data_type)
        self.cols = data.shape[1]
        self.strategy = strategy
        if not all(t in ("continuous", "categorical") for t in self.data_type):
            raise ValueError("Data type must be either continuous or categorical")

    def _range(self, i):
        """(low, high) of column ``i`` under the strategy."""
        if self.strategy.startswith("global"):
            return self.globalmin, self.globalmax
        return self.min[i], self.max[i]

    def _scale(self, col, i):
        s = self.strategy
        if s == "mean-std":
            return (col - self.mu[i]) / self.std[i]
        if s == "none":
            return col
        lo, hi = self._range(i)
        return (col - lo) / (hi - lo) if s.endswith("-1") else 2.0 * (col - lo) / (hi - lo) - 1.0

    def _unscale(self, col, i):
        s = self.strategy
        if s == "mean-std":
            return col * self.std[i] + self.mu[i]
        if s == "none":
            return col
        lo, hi = self._range(i)
        unit = col if s.endswith("-1") else 0.5 * col + 0.5
        return unit * (hi - lo) + lo

    def normalize(self, data):
        data = np.asarray(data)
        continuous = [self._scale(data[:, i], i) for i in range(self.cols)
                      if self.data_type[i] == "continuous"]
        one_hots = []
        for i in range(self.cols):
            if self.data_type[i] == "categorical":
                vals = data[:, i].astype(np.int64)
                one_hots.append(np.eye(int(vals.max()) + 1, dtype=data.dtype)[vals])
        cols = [np.stack(continuous, axis=1)] if continuous else []
        return np.concatenate(cols + one_hots, axis=1) if (cols or one_hots) else data

    def unnormalize(self, data):
        data = np.asarray(data)
        out = np.zeros_like(data)
        for i in range(self.cols):
            out[:, i] = (self._unscale(data[:, i], i) if self.data_type[i] == "continuous"
                         else data[:, i])
        return out
