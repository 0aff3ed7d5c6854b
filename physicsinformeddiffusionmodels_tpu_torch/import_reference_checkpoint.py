"""Convert a reference (PyTorch ``Unet3D``) run into the port's run layout
(port of ``scripts/import_reference_checkpoint.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.import_reference_checkpoint \\
        --checkpoint ref_run/model/checkpoint_300000.pt \\
        [--model-yaml ref_run/model/model.yaml] [--gov-eqs {darcy,mechanics}] \\
        --out trained_models/ref_darcy

Takes the reference's ``checkpoint_<step>.pt`` (``{'model': state_dict}``
or a bare state dict) and, optionally, its ``model.yaml`` (PyYAML is
imported only then), and writes ``out/config.json``,
``out/model/config.json`` and ``out/model/checkpoint_<step>.msgpack``, which
``sample_eval --model-dir out``, ``train --resume`` and the JAX package
read. The reference saves EMA weights into its checkpoints, so the imported
tree fills both ``params`` and ``ema_params``; there is no optimizer state.
The imported model is ``UNet(frame_attention=False)`` (the reference never
calls its temporal attention; ``models/reference_port.py``), and the
written config records that. Runs on the CPU: nothing here needs the card.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.models.reference_port import (
    import_reference_state_dict,
    reference_key_map,
    state_dict_from_torch_file,
)
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import save_checkpoint


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True, help="reference checkpoint_<step>.pt")
    ap.add_argument("--model-yaml", default=None,
                    help="reference model.yaml saved next to the checkpoint")
    ap.add_argument("--gov-eqs", default=None, choices=["darcy", "mechanics"],
                    help="study (defaults to the yaml's gov_eqs, else darcy)")
    ap.add_argument("--out", required=True, help="output run directory")
    args = ap.parse_args(argv)

    overrides = {"frame_attention": False}
    if args.gov_eqs:
        overrides["gov_eqs"] = args.gov_eqs
    cfg = (RunConfig.from_model_yaml(args.model_yaml, **overrides) if args.model_yaml
           else RunConfig(**overrides))

    m = re.search(r"checkpoint_(\d+)", Path(args.checkpoint).name)
    step = int(m.group(1)) if m else 0

    model = UNet(dim=cfg.unet_dim, channels=cfg.model_channels, out_dim=cfg.output_channels,
                 sigmoid_last_channel=cfg.sigmoid_last_channel, frame_attention=False)
    sd = state_dict_from_torch_file(args.checkpoint)
    _, unused = import_reference_state_dict(sd, model, reference_key_map(dim=cfg.unet_dim))
    print(f"imported {len(sd) - len(unused)}/{len(sd)} reference tensors "
          f"({len(unused)} dead-module tensors skipped)")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg.save(out / "config.json")
    # the reference checkpoint holds EMA weights: both slots get them
    path = save_checkpoint(out / "model", step, model=model, ema=model)
    (out / "model" / "config.json").write_text(cfg.to_json())
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
