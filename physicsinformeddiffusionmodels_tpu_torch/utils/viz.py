"""Field CSVs, images, the toy study's scatter panels and denoising GIFs
(port of the writers of ``utils/viz.py``).

matplotlib and imageio are imported inside the functions: the sampling
path never needs them, and a GPU host may have neither.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FRAME_SECONDS = 0.05


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_csv(array: np.ndarray, out_path: str | Path) -> None:
    """A 2-D array as comma-separated text, its directory made first."""
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(out_path, np.asarray(array), delimiter=",")


def save_field_image(field: np.ndarray, out_path: str | Path, title: str | None = None) -> None:
    """Grayscale PNG of a [H, W] field, min-max normalised, with an optional
    green title."""
    plt = _plt()
    lo, hi = field.min(), field.max()
    norm = (field - lo) / (hi - lo) if hi > lo else np.zeros_like(field)
    fig, ax = plt.subplots()
    ax.imshow(np.uint8(norm * 255), cmap="gray", vmin=0, vmax=255)
    ax.axis("off")
    if title:
        plt.title(title, color="green")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def image_history_to_gif(history: np.ndarray, out_path: str | Path) -> None:
    """GIF of a [T, H, W] field trajectory, every frame scaled to 8 bits by
    the range of the last one."""
    import imageio

    history = np.asarray(history)
    lo, hi = history[-1].min(), history[-1].max()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with imageio.get_writer(out_path, mode="I", duration=FRAME_SECONDS) as writer:
        for frame in history:
            writer.append_data(np.uint8(np.clip((frame - lo) / (hi - lo + 1e-12), 0, 1) * 255))


def save_scatter_panels(history: np.ndarray, eval_steps, out_path: str | Path, n_steps: int,
                        extra_histories: dict | None = None, fix_axes: bool = True) -> None:
    """The toy study's panels: a scatter of the [T(+1), N, 2] point cloud at
    each of ``eval_steps``, titled q(x_{n_steps - i}); with ``fix_axes`` every
    panel takes the limits of the first one drawn."""
    plt = _plt()
    k = len(eval_steps)
    fig, axs = plt.subplots(1, k, figsize=(3 * k - 3, 3))
    x_lim = y_lim = None
    series = {"sample": history, **(extra_histories or {})}
    for label, hist in series.items():
        for i_idx, i in enumerate(eval_steps):
            cur = np.asarray(hist[min(i, len(hist) - 1)])
            if fix_axes and x_lim is None:
                x_lim = (cur[:, 0].min(), cur[:, 0].max())
                y_lim = (cur[:, 1].min(), cur[:, 1].max())
            ax = axs[i_idx] if k > 1 else axs
            ax.set_xlim(x_lim)
            ax.set_ylim(y_lim)
            ax.scatter(cur[:, 0], cur[:, 1], s=10, label=label)
            ax.set_title(f"$q(x_{{{n_steps - i}}})$")
            if i_idx == 0:
                ax.legend()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)


def scatter_history_to_gif(history: np.ndarray, out_path: str | Path, x_lim, y_lim,
                           label: str | None = None, duration: float = FRAME_SECONDS) -> None:
    """GIF of a [T, N, 2] point-cloud trajectory, one scatter a frame."""
    import imageio

    plt = _plt()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with imageio.get_writer(out_path, mode="I", duration=duration, loop=1) as writer:
        for step in range(history.shape[0]):
            fig, ax = plt.subplots()
            ax.scatter(history[step, :, 0], history[step, :, 1], s=10)
            ax.set_xlim(x_lim)
            ax.set_ylim(y_lim)
            if label:
                ax.set_title(label)
            fig.canvas.draw()
            writer.append_data(np.asarray(fig.canvas.buffer_rgba())[..., :3])
            plt.close(fig)
