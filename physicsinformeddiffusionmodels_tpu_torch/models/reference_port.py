"""Import reference (PyTorch) ``Unet3D`` weights into the port's ``UNet``
(port of the JAX package's ``models/reference_port.py``).

The reference's ``Unet3D`` is a PyTorch model whose parameters are laid out
for its 3-D convolutions over a frame axis. ``reference_key_map`` maps each
of its live parameters onto a path of the Flax ``UNet`` tree, with the
layout change that carries it there (OIHW -> HWIO convolutions, transposed
linears, spatially flipped transposed-conv kernels, squeezed frame axes):
the same map as JAX's, keyed by the same path tuples, with transforms of
the same names. ``import_reference_state_dict`` fills the port's ``UNet``
through that tree: the model's own parameters in the Flax layout
(``training.checkpoint.flax_params_from_torch``) are the template, each
leaf is replaced by its transformed reference tensor, and
``models.convert.torch_state_dict_from_flax`` carries the tree back. Every
step is a transpose or a flip, so the weights arrive bit for bit.

Build the target with ``UNet(..., frame_attention=False)``: the reference
constructs ``init_temporal_attn`` / ``mid_temporal_attn`` but its forward
never calls them, so a reference checkpoint holds no live frame-attention
weights.

Reference parameters with no counterpart here are dead code in the
reference itself for the supported studies, and are returned in
``unused``:

* ``init_temporal_attn`` / ``mid_temporal_attn`` / ``time_rel_pos_bias``,
  constructed but never invoked in the forward;
* ``sign_emb_CNN``, the 1-D signal embedding, constructed but used only for
  1-D conditioning signals that neither study feeds;
* per-attention ``to_q/to_k/to_v``, the cross-attention projections of the
  same unused conditioning path;
* ``rotary_emb.inv_freq``, a deterministic buffer, not a parameter.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import flax_params_from_torch

# ---- layout transforms (reference -> Flax) ----------------------------------


def _linear(w):
    """torch Linear [out, in] -> Flax Dense kernel [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv3d(w):
    """torch Conv3d [O, I, 1, kh, kw] (single frame) -> HWIO [kh, kw, I, O]."""
    w = np.asarray(w)
    return np.ascontiguousarray(w[:, :, 0].transpose(2, 3, 1, 0))


def _conv2d(w):
    """torch Conv2d [O, I, kh, kw] -> HWIO [kh, kw, I, O]."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _pointwise3d(w):
    """torch Conv3d 1x1x1 [O, I, 1, 1, 1] -> matmul kernel [I, O]."""
    return np.ascontiguousarray(np.asarray(w)[:, :, 0, 0, 0].T)


def _pointwise2d(w):
    """torch Conv2d 1x1 [O, I, 1, 1] -> matmul kernel [I, O]."""
    return np.ascontiguousarray(np.asarray(w)[:, :, 0, 0].T)


def _conv_transpose3d(w):
    """torch ConvTranspose3d [I, O, 1, kh, kw] -> Flax ConvTranspose kernel
    [kh, kw, I, O]; torch's transposed conv correlates with the spatially
    flipped kernel relative to Flax's."""
    w = np.asarray(w)
    return np.ascontiguousarray(w[:, :, 0, ::-1, ::-1].transpose(2, 3, 0, 1))


def _gamma(w):
    """Reference LayerNorm gamma [1, C, 1, 1, 1] -> [C]."""
    return np.ascontiguousarray(np.asarray(w).reshape(-1))


def _copy(w):
    return np.ascontiguousarray(np.asarray(w))


# ---- key map ----------------------------------------------------------------


def _resnet_entries(flax_name: str, tp: str, *, has_res: bool, has_mlp: bool) -> dict:
    """A reference ResnetBlock -> ``models.unet.ResnetBlock``."""
    out = {}
    for blk, tblk in (("Block_0", "block1"), ("Block_1", "block2")):
        out[(flax_name, blk, "kernel")] = (f"{tp}.{tblk}.proj.weight", _conv3d)
        out[(flax_name, blk, "bias")] = (f"{tp}.{tblk}.proj.bias", _copy)
        out[(flax_name, blk, "gn_scale")] = (f"{tp}.{tblk}.norm.weight", _copy)
        out[(flax_name, blk, "gn_bias")] = (f"{tp}.{tblk}.norm.bias", _copy)
    if has_mlp:
        out[(flax_name, "Dense_0", "kernel")] = (f"{tp}.mlp.1.weight", _linear)
        out[(flax_name, "Dense_0", "bias")] = (f"{tp}.mlp.1.bias", _copy)
    if has_res:
        out[(flax_name, "res_kernel")] = (f"{tp}.res_conv.weight", _pointwise3d)
        out[(flax_name, "res_bias")] = (f"{tp}.res_conv.bias", _copy)
    return out


def _lab_entries(flax_name: str, tp: str) -> dict:
    """A reference PreNorm(SpatialLinearAttention) residual ->
    ``models.unet.LinearAttentionBlock``."""
    return {
        (flax_name, "w_qkv"): (f"{tp}.fn.fn.to_qkv.weight", _pointwise2d),
        (flax_name, "w_out"): (f"{tp}.fn.fn.to_out.weight", _pointwise2d),
        (flax_name, "b_out"): (f"{tp}.fn.fn.to_out.bias", _copy),
        (flax_name, "ln_gamma"): (f"{tp}.fn.norm.gamma", _gamma),
    }


def reference_key_map(dim: int, dim_mults=(1, 2, 4, 8), init_dim: int | None = None, *,
                      use_sparse_linear_attn: bool = True, cond_path: bool = True) -> dict:
    """{Flax param path tuple: (reference state-dict key, transform)} for a
    reference ``Unet3D`` and a ``UNet`` built with the same options."""
    m: dict = {}
    init_dim = init_dim or dim
    n_levels = len(dim_mults)
    dims = [init_dim] + [dim * mu for mu in dim_mults]
    in_out = list(zip(dims[:-1], dims[1:]))

    m[("init_conv", "Conv_0", "kernel")] = ("init_conv.weight", _conv3d)
    m[("init_conv", "Conv_0", "bias")] = ("init_conv.bias", _copy)

    m[("time_mlp_0", "kernel")] = ("time_mlp.1.weight", _linear)
    m[("time_mlp_0", "bias")] = ("time_mlp.1.bias", _copy)
    m[("time_mlp_1", "kernel")] = ("time_mlp.3.weight", _linear)
    m[("time_mlp_1", "bias")] = ("time_mlp.3.bias", _copy)

    if cond_path:
        m[("emb_conv_0", "kernel")] = ("emb_conv.0.weight", _conv2d)
        m[("emb_conv_0", "bias")] = ("emb_conv.0.bias", _copy)
        m[("emb_conv_1", "Conv_0", "kernel")] = ("emb_conv.2.weight", _conv2d)
        m[("emb_conv_1", "Conv_0", "bias")] = ("emb_conv.2.bias", _copy)
        m[("combine_conv", "kernel")] = ("combine_conv.weight", _conv2d)
        m[("combine_conv", "bias")] = ("combine_conv.bias", _copy)

    rb = lab = 0
    for lvl, (dim_in, dim_out) in enumerate(in_out):  # encoder
        m.update(_resnet_entries(f"ResnetBlock_{rb}", f"downs.{lvl}.0",
                                 has_res=dim_in != dim_out, has_mlp=True))
        m.update(_resnet_entries(f"ResnetBlock_{rb + 1}", f"downs.{lvl}.1",
                                 has_res=False, has_mlp=True))
        rb += 2
        if use_sparse_linear_attn:
            m.update(_lab_entries(f"LinearAttentionBlock_{lab}", f"downs.{lvl}.2"))
            lab += 1
        if lvl < n_levels - 1:
            m[(f"Downsample_{lvl}", "Conv2dPadded_0", "Conv_0", "kernel")] = (
                f"downs.{lvl}.3.weight", _conv3d)
            m[(f"Downsample_{lvl}", "Conv2dPadded_0", "Conv_0", "bias")] = (
                f"downs.{lvl}.3.bias", _copy)

    m.update(_resnet_entries("mid_block1", "mid_block1", has_res=False, has_mlp=True))
    m[("mid_spatial_attn", "ChannelLayerNorm_0", "gamma")] = (
        "mid_spatial_attn.fn.norm.gamma", _gamma)
    m[("Attention_0", "Dense_0", "kernel")] = (
        "mid_spatial_attn.fn.fn.fn.to_qkv.weight", _linear)
    m[("Attention_0", "Dense_1", "kernel")] = (
        "mid_spatial_attn.fn.fn.fn.to_out.weight", _linear)
    m.update(_resnet_entries("mid_block2", "mid_block2", has_res=False, has_mlp=True))

    for lvl, (dim_in, dim_out) in enumerate(reversed(in_out)):  # decoder; skips double dim_in
        m.update(_resnet_entries(f"ResnetBlock_{rb}", f"ups.{lvl}.0",
                                 has_res=True, has_mlp=True))
        m.update(_resnet_entries(f"ResnetBlock_{rb + 1}", f"ups.{lvl}.1",
                                 has_res=False, has_mlp=True))
        rb += 2
        if use_sparse_linear_attn:
            m.update(_lab_entries(f"LinearAttentionBlock_{lab}", f"ups.{lvl}.2"))
            lab += 1
        if lvl < n_levels - 1:
            m[(f"Upsample_{lvl}", "ConvTranspose_0", "kernel")] = (
                f"ups.{lvl}.3.weight", _conv_transpose3d)
            m[(f"Upsample_{lvl}", "ConvTranspose_0", "bias")] = (
                f"ups.{lvl}.3.bias", _copy)

    m.update(_resnet_entries("final_block", "final_conv.0", has_res=True, has_mlp=False))
    m[("final_conv", "kernel")] = ("final_conv.1.weight", _conv3d)
    m[("final_conv", "bias")] = ("final_conv.1.bias", _copy)
    return m


def _leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) of a nested dict, keys sorted at every level (the order
    in which JAX's tree functions visit a dict)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def import_reference_state_dict(state_dict: dict, model: torch.nn.Module,
                                key_map: dict) -> tuple[dict, list]:
    """Fill the port's ``model`` (a ``UNet``) with a reference state dict
    (values as torch tensors, numpy arrays or anything ``np.asarray``
    takes), by ``key_map``.

    Returns ``(state_dict_for_model, unused)``: the model's state dict as
    loaded (``load_state_dict(strict=True)``), and the reference keys not
    consumed, sorted (the reference's dead modules; module docstring).
    Raises ``KeyError`` for a model parameter with no mapping (with a hint
    for the frame attention) or a reference key that is missing, and
    ``ValueError`` for a shape mismatch.
    """
    template = flax_params_from_torch(model.state_dict())["params"]
    used, tree = set(), {}
    for keys, leaf in _leaves(template):
        if keys not in key_map:
            hint = ""
            if any("FrameAttention" in k or "frame_attn" in k for k in keys):
                hint = (" — reference checkpoints have no live frame-attention weights; "
                        "build the target with UNet(frame_attention=False) (see module "
                        "docstring)")
            raise KeyError(f"no reference mapping for param {keys}{hint}")
        tkey, transform = key_map[keys]
        if tkey not in state_dict:
            raise KeyError(f"reference state dict missing {tkey} (for {keys})")
        value = state_dict[tkey]
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        w = transform(value).astype(leaf.dtype)
        if w.shape != leaf.shape:
            raise ValueError(f"shape mismatch for {keys}: reference {tkey} -> {w.shape}, "
                             f"model expects {leaf.shape}")
        used.add(tkey)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = w
    sd = torch_state_dict_from_flax(tree)
    model.load_state_dict(sd, strict=True)
    return sd, sorted(k for k in state_dict if k not in used)


def state_dict_from_torch_file(path) -> dict:
    """A reference ``checkpoint_<step>.pt`` as a numpy state dict. The
    reference wraps the state dict as ``{'model': state_dict}``; a bare
    state dict is accepted too."""
    with open(path, "rb") as f:
        obj = torch.load(f, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k: v.numpy() for k, v in sd.items()}
