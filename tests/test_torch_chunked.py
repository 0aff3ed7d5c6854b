"""The port's chunked training loop (``chunk_steps > 1``) on the CPU, where a
chunk is a plain loop of eager steps: the same metrics and weights as the
per-step loop at every chunk end, a resumed chunked run the same as an
uninterrupted one, and ``validate_chunking`` as the JAX package's; and the
parts of the card's graphed step that run on the CPU (the warm-up's
restore, the CPU optimizer)."""

import copy
import csv

import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator import generate_dataset
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training import trainer
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    GraphedTrainStep,
    create_train_state,
    make_optimizer,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, DIM = 16, 8


@pytest.mark.parametrize("field", ["log_freq", "test_eval_freq", "sample_freq"])
def test_validate_chunking_raises_on_a_misaligned_frequency(field):
    aligned = dict(chunk_steps=4, log_freq=8, test_eval_freq=4, sample_freq=12)
    RunConfig(**aligned).validate_chunking()
    bad = {**aligned, field: 6}
    with pytest.raises(ValueError, match=f"{field}=6 must be a multiple of chunk_steps=4"):
        RunConfig(**bad).validate_chunking()
    with pytest.raises(ValueError, match=f"{field}=6"):  # as the JAX package's
        JaxRunConfig(**bad).validate_chunking()
    RunConfig(**{**bad, "chunk_steps": 1}).validate_chunking()  # no chunks: no rule
    with pytest.raises(ValueError, match="chunk_steps"):
        train.run_darcy(RunConfig(**bad), "cpu")


@pytest.fixture(scope="module")
def darcy_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("darcy")
    for split, n, seed in (("train", 4, 1), ("valid", 2, 100)):
        generate_dataset(n, pixels_per_dim=P, q=16, base_seed=seed, out_dir=root / split)
    return root


def _run(root, out, name, iterations, chunk, resume=False, **kw):
    cfg = RunConfig(name=name, train_iterations=iterations, chunk_steps=chunk, log_freq=2,
                    test_eval_freq=2, sample_freq=4, train_batch_size=2, no_samples=2,
                    pixels_per_dim=P, unet_dim=DIM, diff_steps=4, compute_dtype="float32",
                    data_dir=str(root / "train"), valid_data_dir=str(root / "valid"),
                    output_dir=str(out), resume=resume, **kw)
    return train.run_darcy(cfg, "cpu")


def _rows(out, name):
    with open(out / name / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def _values(rows, key):
    return {int(r["step"]): r[key] for r in rows if r[key]}


@pytest.mark.parametrize("kw", [{}, {"residual_grad_guidance": True}], ids=["mean", "guided"])
def test_chunked_loop_equals_the_per_step_loop_at_every_chunk_end(darcy_dirs, tmp_path, kw):
    per_step = _run(darcy_dirs, tmp_path, "per_step", 6, 1, **kw)
    chunked = _run(darcy_dirs, tmp_path, "chunked", 6, 2, **kw)
    assert per_step.step == chunked.step == 7
    a, b = _rows(tmp_path, "per_step"), _rows(tmp_path, "chunked")
    for key in ("loss", "loss_data", "residual_mean_abs", "loss_test",
                "residual_mean_abs_samples"):
        va, vb = _values(a, key), _values(b, key)
        assert va == vb and va, key
    assert sorted(_values(b, "loss")) == [0, 2, 4, 6]  # step 0 alone, then chunk ends
    assert sorted(_values(b, "residual_mean_abs_samples")) == [4, 6]
    for x, y in zip(per_step.model.parameters(), chunked.model.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(per_step.ema.parameters(), chunked.ema.parameters()):
        assert torch.equal(x, y)
    for name in ("checkpoint_4.msgpack", "checkpoint_6.msgpack"):
        ra = load_checkpoint(tmp_path / "per_step" / "model" / name)
        rb = load_checkpoint(tmp_path / "chunked" / "model" / name)
        for k in ("params", "ema_params"):
            flat_a, flat_b = _flat(ra[k]), _flat(rb[k])
            assert flat_a.keys() == flat_b.keys()
            assert all(np.array_equal(flat_a[n], flat_b[n]) for n in flat_a), (name, k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_resumed_chunked_run_equals_an_uninterrupted_one(darcy_dirs, tmp_path):
    """Stopped at step 4 (its final checkpoint keeps Adam), resumed to 8: the
    chunks restart at step 5 and end on the same steps."""
    whole = _run(darcy_dirs, tmp_path, "whole", 8, 2)
    _run(darcy_dirs, tmp_path, "parts", 4, 2)
    resumed = _run(darcy_dirs, tmp_path, "parts", 8, 2, resume=True)
    assert whole.step == resumed.step == 9
    a, b = _rows(tmp_path, "whole"), _rows(tmp_path, "parts")
    assert _values(a, "loss") == _values(b, "loss")
    assert sorted(_values(b, "loss")) == [0, 2, 4, 6, 8]
    for x, y in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(whole.ema.parameters(), resumed.ema.parameters()):
        assert torch.equal(x, y)
    for sa, sb in zip(whole.optimizer.state_dict()["state"].values(),
                      resumed.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert whole.optimizer.count == resumed.optimizer.count == 9


def test_graphed_step_refuses_a_model_off_the_card():
    model = torch.nn.Linear(2, 2)
    state = create_train_state(model, make_optimizer(model))
    with pytest.raises(ValueError, match="CUDA"):
        GraphedTrainStep(state, lambda m, *a: (m(a[0]).sum(), None))


def test_optimizer_on_the_cpu_keeps_a_float_learning_rate():
    """The CPU keeps Adam as before (no capturable state, a float lr set
    from the schedule's count), so the CPU parity tests keep their numbers."""
    model = torch.nn.Linear(2, 2)
    opt = make_optimizer(model, 1e-3, 1.0, "cosine", total_steps=10)
    assert not opt.adam.param_groups[0]["capturable"]
    for _ in range(3):
        model(torch.ones(1, 2)).sum().backward()
        opt.step()
    assert opt.count == 3
    assert opt.adam.param_groups[0]["lr"] == opt.lr_at(2)
    assert isinstance(opt.adam.param_groups[0]["lr"], float)


@pytest.mark.parametrize("adam_state", [False, True], ids=["fresh_adam", "stepped_adam"])
def test_capture_warm_up_and_restore_change_nothing(adam_state):
    """What ``GraphedTrainStep`` does before a capture, run on the CPU: two
    device steps, then ``_restore`` of a snapshot taken before them. The
    next eager steps then equal those of an untouched copy bit for bit, for
    an optimizer with no state yet (its lazily made state is zeroed) and one
    that has stepped."""
    torch.manual_seed(0)
    model = UNet(dim=DIM, channels=2, dim_mults=(1, 2))
    cfg = RunConfig(pixels_per_dim=P, unet_dim=DIM, compute_dtype="float32")
    loss_fn = train.build_darcy_loss_fn(ts.create_schedule(100), DarcyResidual(P), cfg)
    data = torch.randn(6, P, P, 2, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator()

    def run(state, n):
        for _ in range(n):
            trainer.resident_train_step(state, loss_fn, data, 2, 100, 3, gen, ema_start=1)

    ref = create_train_state(model, make_optimizer(model, 1e-3, 1.0))
    if adam_state:
        run(ref, 2)
    warmed = copy.deepcopy(ref)
    snapshot = trainer._snapshot(warmed)
    args = trainer.resident_batch(data, 2, 100, torch.Generator().manual_seed(9))
    for ema_after in (False, True):
        trainer._device_step(warmed, loss_fn, args, ema_after, 0.99)
    trainer._restore(warmed, snapshot)
    assert len(warmed.optimizer.adam.state) > 0
    run(ref, 3)
    run(warmed, 3)
    for a, b in ((ref.model, warmed.model), (ref.ema, warmed.ema)):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    for sa, sb in zip(ref.optimizer.adam.state.values(), warmed.optimizer.adam.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert (ref.step, ref.optimizer.count) == (warmed.step, warmed.optimizer.count)
