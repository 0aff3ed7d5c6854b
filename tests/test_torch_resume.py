"""The cosine learning rate across a resume, port against the JAX package.

optax keeps the schedule's count in ``opt_state``. A final or SIGTERM save
keeps ``opt_state``, an intermediate save drops it, and the JAX
``restore_train_state`` then keeps a fresh one, so the schedule starts again
from count 0. The port's ``ClipAdam`` keeps its own count with the Adam
state and must give the lr of optax at every step of the same three runs.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.training import checkpoint as jck
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch.training import checkpoint as tck
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR, TOTAL, FINAL = 1e-3, 8, 0.1
STEPS, SAVE_AT = 6, 2  # the save after step label 2; the resumed run goes on at 3


def _counts(opt_state) -> int:
    """The count of every optax state in ``opt_state`` (they all agree)."""
    found = []

    def walk(s):
        if hasattr(s, "_fields") and "count" in s._fields:
            found.append(int(s.count))
        if isinstance(s, tuple):
            for f in s:
                walk(f)

    walk(opt_state)
    assert found and len(set(found)) == 1, found
    return found[0]


def _jax_lrs(tmp_path, resume: str | None) -> list[float]:
    """The lr optax applies at each step label 0..STEPS-1: the schedule at the
    count before the update."""
    tx = jt.make_optimizer(LR, 1.0, "cosine", total_steps=TOTAL, final_frac=FINAL)
    sched = optax.cosine_decay_schedule(LR, TOTAL, alpha=FINAL)
    state = jt.create_train_state({"w": jnp.ones(3)}, tx)
    grads = {"w": jnp.full(3, 0.5)}
    lrs = []
    for step in range(STEPS):
        lrs.append(float(sched(_counts(state.opt_state))))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        state = state._replace(params=optax.apply_updates(state.params, updates),
                               opt_state=opt_state, step=state.step + 1)
        if resume is not None and step == SAVE_AT:
            jck.save_checkpoint(tmp_path, step, params=state.params, ema_params=state.params,
                                opt_state=state.opt_state if resume == "with" else None)
            state, start = jck.restore_train_state(
                tmp_path, jt.create_train_state({"w": jnp.ones(3)}, tx))
            assert start == SAVE_AT + 1
    return lrs


def _drop_saved_count(directory) -> None:
    """Rewrite the newest checkpoint's optimizer state without its schedule
    count, as the port wrote it before it kept one."""
    path = tck.latest_checkpoint(directory)
    raw = tck.msgpack_restore(path.read_bytes())
    del raw["opt_state"]["count"]
    path.write_bytes(tck.msgpack_serialize(raw))


def _port_lrs(tmp_path, resume: str | None) -> tuple[list[float], list[int]]:
    """The lr the port's optimizer applies at each step label, and its count
    before each step. ``resume='without count'`` resumes from a checkpoint
    with Adam's state but no saved count."""

    def fresh():
        model = torch.nn.Sequential(torch.nn.Linear(3, 1))
        return create_train_state(model, make_optimizer(model, LR, 1.0, "cosine", TOTAL, FINAL))

    def loss_fn(model, x):
        loss = model(x).square().sum()
        return loss, loss

    state, x = fresh(), torch.ones(2, 3)
    lrs, counts = [], []
    for step in range(STEPS):
        counts.append(state.optimizer.count)
        train_step(state, loss_fn, x, ema_start=0)
        lrs.append(state.optimizer.adam.param_groups[0]["lr"])
        if resume is not None and step == SAVE_AT:
            tck.save_checkpoint(tmp_path, step, model=state.model, ema=state.ema,
                                optimizer=state.optimizer if resume != "without" else None)
            if resume == "without count":
                _drop_saved_count(tmp_path)
            state, start = tck.restore_train_state(tmp_path, fresh())
            assert start == state.step == SAVE_AT + 1
    return lrs, counts


@pytest.mark.parametrize("resume,want_counts", [
    (None, [0, 1, 2, 3, 4, 5]),           # uninterrupted
    ("with", [0, 1, 2, 3, 4, 5]),         # final/SIGTERM save: opt_state kept
    ("without", [0, 1, 2, 0, 1, 2]),      # intermediate save: the schedule starts again
])
def test_resumed_cosine_lr_matches_optax(tmp_path, resume, want_counts):
    ref = _jax_lrs(tmp_path / "jax", resume)
    lrs, counts = _port_lrs(tmp_path / "port", resume)
    # the count, which picks the lr, is exact; the lr itself is optax's
    # float32 arithmetic against the port's float64, so equal to fp32 rounding
    assert counts == want_counts
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=0)
    sched = optax.cosine_decay_schedule(LR, TOTAL, alpha=FINAL)
    assert ref == [float(sched(c)) for c in want_counts]


def test_resume_from_a_checkpoint_without_a_saved_count_continues_the_schedule(tmp_path):
    """A checkpoint with Adam's state but no count ran the schedule on the
    step, so the schedule goes on from the resumed step: the lr of every step
    equals the uninterrupted run's."""
    lrs, counts = _port_lrs(tmp_path / "old", "without count")
    assert counts == [0, 1, 2, 3, 4, 5]
    assert lrs == _port_lrs(tmp_path / "new", None)[0]
