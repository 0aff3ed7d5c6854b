"""Field images and denoising GIFs (port of the image writers of
``utils/viz.py``).

matplotlib and imageio are imported inside the functions: the sampling
path never needs them, and a GPU host may have neither.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FRAME_SECONDS = 0.05


def save_field_image(field: np.ndarray, out_path: str | Path, title: str | None = None) -> None:
    """Grayscale PNG of a [H, W] field, min-max normalised, with an optional
    green title."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
