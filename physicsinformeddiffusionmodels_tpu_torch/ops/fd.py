"""Finite-difference derivative operators as banded matrices (port of
``ops/fd.py``).

A derivative along one image axis is one [N, N] banded matrix: interior rows
carry the central stencil, boundary rows (semi-)one-sided stencils of the
same accuracy. Coefficients come from the Fornberg (1988) recurrence on the
host in float64; the operators are float32 tensors applied with einsum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fornberg_weights(x0: float, xs: np.ndarray, m: int) -> np.ndarray:
    """Weights w with f^(m)(x0) ~= sum_k w[k] f(xs[k]) on arbitrary nodes
    ``xs`` (Fornberg 1988, Math. Comp. 51:699-706)."""
    xs = np.asarray(xs, dtype=np.float64)
    n = len(xs)
    if n < m + 1:
        raise ValueError(f"need at least {m + 1} points for derivative order {m}")
    c = np.zeros((n, m + 1))
    c1 = 1.0
    c4 = xs[0] - x0
    c[0, 0] = 1.0
    for i in range(1, n):
        mn = min(i, m)
        c2 = 1.0
        c5 = c4
        c4 = xs[i] - x0
        for j in range(i):
            c3 = xs[i] - xs[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[i, k] = c1 * (k * c[i - 1, k - 1] - c5 * c[i - 1, k]) / c2
                c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
            c[j, 0] = c4 * c[j, 0] / c3
        c1 = c2
    return c[:, m]


def central_stencil(m: int, acc: int) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, weights) of the central stencil for derivative m at
    accuracy acc on a unit grid (findiff's window of
    2*floor((m+1)/2) - 1 + acc points)."""
    num_points = 2 * ((m + 1) // 2) - 1 + acc
    p = num_points // 2
    offsets = np.arange(-p, p + 1)
    return offsets, fornberg_weights(0.0, offsets.astype(np.float64), m)


def onesided_points(m: int, acc: int) -> int:
    """Points in the (semi-)one-sided boundary stencils (findiff: m + acc)."""
    return m + acc


@functools.lru_cache(maxsize=None)
def _derivative_matrix_np(n: int, m: int, acc: int, periodic: bool) -> np.ndarray:
    """Unit-spacing derivative matrix [n, n] (host, float64, cached)."""
    D = np.zeros((n, n))
    offsets, w = central_stencil(m, acc)
    p = (len(offsets) - 1) // 2

    if periodic:
        for i in range(n):
            for o, wk in zip(offsets, w):
                D[i, (i + o) % n] += wk
        return D

    nb = onesided_points(m, acc)
    for i in range(n):
        if p <= i <= n - 1 - p:
            D[i, i + offsets] = w
        elif i < p:
            pts = np.arange(nb, dtype=np.float64)
            D[i, :nb] = fornberg_weights(float(i), pts, m)
        else:
            pts = np.arange(n - nb, n, dtype=np.float64)
            D[i, n - nb:] = fornberg_weights(float(i), pts, m)
    return D


def derivative_matrix(n: int, spacing: float, deriv: int, acc: int = 2,
                      periodic: bool = False, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """[n, n] derivative operator for a uniform grid with ``spacing``
    (possibly negative: the sign enters as spacing**(-deriv))."""
    D = _derivative_matrix_np(n, deriv, acc, periodic)
    return torch.as_tensor(np.asarray(D / spacing**deriv, np.float32), dtype=dtype, device=device)


class StencilGradients:
    """The five image-derivative operators the physics layers use (d_d0,
    d_d1, d_d00, d_d11, d_d01) on [..., H, W] fields:

      d/d0   : D0 f          (contraction over H)
      d/d1   : f D1^T        (contraction over W)
      d/d0d1 : D0 f D1^T

    ``Dc0``/``Dc1`` stack the first- and second-derivative operators of one
    axis ([2N, N]), so one contraction per axis gives both orders
    (``first_second_pair``); ``D0_1``, ``D0_2``, ``D1_1`` and ``D1_2`` are
    views of their halves.
    """

    def __init__(self, h: int, w: int | None = None, d0: float = 1.0, d1: float = 1.0,
                 fd_acc: int = 2, periodic: bool = False, dtype=torch.float32, device=None):
        w = h if w is None else w
        mk = lambda n, sp, m: derivative_matrix(n, sp, m, fd_acc, periodic, dtype, device)
        self.Dc0 = torch.cat([mk(h, d0, 1), mk(h, d0, 2)], dim=0)
        self.Dc1 = torch.cat([mk(w, d1, 1), mk(w, d1, 2)], dim=0)

    @property
    def D0_1(self) -> torch.Tensor:
        return self.Dc0[:self.Dc0.shape[1]]

    @property
    def D0_2(self) -> torch.Tensor:
        return self.Dc0[self.Dc0.shape[1]:]

    @property
    def D1_1(self) -> torch.Tensor:
        return self.Dc1[:self.Dc1.shape[1]]

    @property
    def D1_2(self) -> torch.Tensor:
        return self.Dc1[self.Dc1.shape[1]:]

    @staticmethod
    def _apply_axis0(D: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ij,...jw->...iw", D, f)

    @staticmethod
    def _apply_axis1(D: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ij,...hj->...hi", D, f)

    def d_d0(self, f: torch.Tensor) -> torch.Tensor:
        """The first derivative along H of [..., H, W]."""
        return self._apply_axis0(self.D0_1, f)

    def d_d1(self, f: torch.Tensor) -> torch.Tensor:
        """The first derivative along W of [..., H, W]."""
        return self._apply_axis1(self.D1_1, f)

    def d_d00(self, f: torch.Tensor) -> torch.Tensor:
        """The second derivative along H of [..., H, W]."""
        return self._apply_axis0(self.D0_2, f)

    def d_d11(self, f: torch.Tensor) -> torch.Tensor:
        """The second derivative along W of [..., H, W]."""
        return self._apply_axis1(self.D1_2, f)

    def d_d01(self, f: torch.Tensor) -> torch.Tensor:
        """The mixed derivative, along H then W, of [..., H, W]."""
        return self._apply_axis1(self.D1_1, self._apply_axis0(self.D0_1, f))

    def first_second_pair(self, f: torch.Tensor):
        """(d_d0, d_d1, d_d00, d_d11) of ``f`` in two contractions."""
        n0 = self.Dc0.shape[1]
        n1 = self.Dc1.shape[1]
        a0 = self._apply_axis0(self.Dc0, f)
        a1 = self._apply_axis1(self.Dc1, f)
        return a0[..., :n0, :], a1[..., :n1], a0[..., n0:, :], a1[..., n1:]

    def __call__(self, f: torch.Tensor, mode: str):
        """``mode`` 'all': (d_d0, d_d1, d_d00, d_d11, d_d01); else the
        operator of that name."""
        if mode == "all":
            return self.d_d0(f), self.d_d1(f), self.d_d00(f), self.d_d11(f), self.d_d01(f)
        return getattr(self, mode)(f)
