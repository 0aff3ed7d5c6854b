"""Compute ops: finite-difference stencils, reshapes, the fused kernels
(each with its plain version), host-side connected components."""

from physicsinformeddiffusionmodels_tpu_torch.ops.fd import (
    StencilGradients,
    central_stencil,
    derivative_matrix,
    fornberg_weights,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.gradients import (
    hessian_autodiff,
    hessian_numeric,
    image_jacobian,
    jacobian_autodiff,
    jacobian_numeric,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
from physicsinformeddiffusionmodels_tpu_torch.ops.reshape import (
    b_xy_c_to_image,
    image_to_b_xy_c,
    nchw_to_nhwc,
    nhwc_to_nchw,
    resize_bilinear,
    resize_nearest,
)

__all__ = [
    "StencilGradients",
    "central_stencil",
    "derivative_matrix",
    "fornberg_weights",
    "hessian_autodiff",
    "hessian_numeric",
    "image_jacobian",
    "jacobian_autodiff",
    "jacobian_numeric",
    "group_norm_film_silu",
    "b_xy_c_to_image",
    "image_to_b_xy_c",
    "nchw_to_nhwc",
    "nhwc_to_nchw",
    "resize_bilinear",
    "resize_nearest",
]
