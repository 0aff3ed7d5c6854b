"""Data: the dataset loaders and the Darcy and mechanics ground-truth generators."""

from physicsinformeddiffusionmodels_tpu_torch.data.datasets import (
    DarcyDataset,
    Normalization,
    NpyFieldDataset,
    SquareImagesDataset,
    cycle_batches,
    iter_batches,
    load_darcy_dataset,
    sample_images_with_squares,
)

__all__ = [
    "DarcyDataset",
    "Normalization",
    "NpyFieldDataset",
    "SquareImagesDataset",
    "cycle_batches",
    "iter_batches",
    "load_darcy_dataset",
    "sample_images_with_squares",
]
