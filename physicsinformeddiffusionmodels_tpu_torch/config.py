"""Run configuration, field for field the JAX package's ``RunConfig``.

The field names match ``physicsinformeddiffusionmodels_tpu/config.py`` so
that every ``results/*/portable/config.json`` loads unchanged, and a
reference-format ``model.yaml`` configures a run (``from_model_yaml``).
``use_double`` is carried only so that such files load: True is refused.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    # --- model.yaml keys ---
    c_data: float = 1.0
    c_residual: float = 1e-3
    c_ineq: float = 0.0
    lambda_opt: float = 0.0
    diff_steps: int = 100
    x0_estimation: str = "mean"  # 'mean' | 'sample'
    ddim_steps: int = 0
    residual_grad_guidance: bool = False
    correction_mode: str = "none"  # 'x0' | 'xt' | 'none'
    M_correction: int = 0
    N_correction: int = 0
    gov_eqs: str = "darcy"  # 'darcy' | 'mechanics'
    fd_acc: int = 2  # must match the training data

    # --- study constants ---
    name: str = "run_1"
    pixels_per_dim: int = 64
    pixels_at_boundary: bool = True
    domain_length: float = 1.0
    reverse_d1: bool = True
    bcs: str = "none"  # 'none' | 'periodic'
    train_iterations: int = 300_000
    train_batch_size: Optional[int] = None
    lr: float = 1e-4
    lr_schedule: str = "constant"  # 'constant' | 'cosine'
    lr_final_frac: float = 0.1
    grad_clip: float = 1.0
    ema_decay: float = 0.99
    ema_start: int = 1000
    test_eval_freq: int = 500
    sample_freq: int = 20_000
    log_freq: int = 20
    chunk_steps: int = 1
    no_samples: int = 8
    seed: int = 0
    # Kept only so that existing config files load: nothing in either
    # package reads it, so True is refused rather than silently ignored.
    use_double: bool = False
    use_dynamic_threshold: bool = False
    self_condition: bool = False
    topopt_eval: bool = True
    guidance_scale: float = 3.0
    null_cond_prob: float = 0.1
    resume: bool = False

    # --- model dims ---
    unet_dim: Optional[int] = None  # darcy 32, mechanics 128
    frame_attention: bool = True
    # --- data paths ---
    data_dir: str = "./data/darcy/train"
    valid_data_dir: str = "./data/darcy/valid"
    output_dir: str = "./trained_models"
    # --- parallelism ---
    mesh_dp: Optional[int] = None
    mesh_tp: int = 1
    mesh_slices: int = 1
    tp_shard_activations: bool = False
    seq_parallel_attn: bool = False
    # --- compute dtype ('float32' | 'bfloat16' for model compute) ---
    compute_dtype: str = "bfloat16"
    # with bfloat16 compute: the final block and 1x1 conv run in fp32
    fp32_head: bool = False

    def __post_init__(self):
        if self.use_double:
            raise ValueError(
                "use_double=True is not supported: no code path reads it "
                "(float64 training was never wired up)"
            )
        if self.residual_grad_guidance and self.gov_eqs != "darcy":
            raise ValueError(
                "residual_grad_guidance is currently only implemented for "
                f"gov_eqs='darcy' (got gov_eqs='{self.gov_eqs}')."
            )
        use_ddim = self.x0_estimation == "sample"
        if self.train_batch_size is None:
            if self.gov_eqs == "darcy":
                self.train_batch_size = 16 if use_ddim else 64
            else:
                self.train_batch_size = 4 if use_ddim else 6
        if self.unet_dim is None:
            self.unet_dim = 32 if self.gov_eqs == "darcy" else 128

    def validate_chunking(self) -> None:
        """With chunk_steps > 1, every periodic event must land on a chunk
        end, or the training loop would skip it mid-chunk."""
        if self.chunk_steps <= 1:
            return
        for name in ("log_freq", "test_eval_freq", "sample_freq"):
            v = getattr(self, name)
            if v % self.chunk_steps != 0:
                raise ValueError(
                    f"{name}={v} must be a multiple of chunk_steps={self.chunk_steps}")

    @property
    def use_ddim_x0(self) -> bool:
        return self.x0_estimation == "sample"

    @property
    def output_channels(self) -> int:
        return 2 if self.gov_eqs == "darcy" else 3

    @property
    def model_channels(self) -> int:
        # mechanics model sees 3 noisy fields + 3 conditioning + 4 BC/load
        return 2 if self.gov_eqs == "darcy" else 10

    @property
    def sigmoid_last_channel(self) -> bool:
        return self.gov_eqs == "mechanics"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        return cls(**json.loads(text))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "RunConfig":
        return cls.from_json(Path(path).read_text())

    @classmethod
    def from_model_yaml(cls, path, **overrides) -> "RunConfig":
        """A run configured by a reference-format ``model.yaml``: its keys
        are field names here (an unknown key raises), ``overrides`` win.
        Needs PyYAML, imported here only."""
        import yaml

        raw = yaml.safe_load(Path(path).read_text())
        unknown = set(raw) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown model.yaml keys: {sorted(unknown)}")
        if raw.get("correction_mode") is not None:
            raw["correction_mode"] = str(raw["correction_mode"])
        return cls(**{**raw, **overrides})
