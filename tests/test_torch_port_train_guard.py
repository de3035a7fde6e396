"""The training step's NaN guard on the card (`engine/state.py::
make_train_step`): the loss's finiteness leaves the card before the
backward pass is enqueued, and the host reads it after.  Three steps give
the parameters, Adam state and BatchNorm buffers of a step that reads the
loss after its backward pass, bit for bit; ``skipped_nan`` is a Python
float; a NaN batch is skipped as on the CPU.  Tiny config, batch 2, bf16.

The card's step repeats bit for bit only under PyTorch's deterministic
switch (with cuDNN's free choice of algorithms two runs of the same step
differ), so the comparison turns it on for its two runs.

This file imports neither JAX nor the JAX package; without a card its
tests skip with the reason:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_train_guard.py
"""

import copy
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.py")


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the early read is the card's path "
                    "(run `python -m pytest -m cuda` on the card)")
    return torch.device("cuda")


@pytest.fixture
def deterministic(monkeypatch):
    """PyTorch's and cuDNN's deterministic algorithms, restored after."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        was[2:]


def _train(device):
    """(config, train state, step, batch) of the training benchmark."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.tools.bench import build_train

    cfg = Config.fromfile(TINY)
    return (cfg, *build_train(cfg, 2, device))


def _reading_after_backward(loss_fn, compute_dtype):
    """The step at a world of one with the guard's read after the backward
    pass, as it was before the early read: the ordering to hold the
    program's to."""
    from lanemapping_tpu_torch.engine.state import model_input

    def step(state, batch):
        model = state.model
        model.train()
        buffers = [b.detach().clone() for b in model.buffers()]
        inp = model_input(batch, False, compute_dtype)
        params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
        out = torch.func.functional_call(model, params, (inp,))
        loss = loss_fn(out, batch)["loss"]
        state.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        ok = bool(torch.isfinite(loss))
        if ok:
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            state.scheduler.step()
        else:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        state.step += 1
        return {"loss": loss.detach(), "skipped_nan": 0.0 if ok else 1.0}
    return step


def _snapshot(state):
    return copy.deepcopy({
        "params": dict(state.model.named_parameters()),
        "buffers": dict(state.model.named_buffers()),
        "adam": state.optimizer.state_dict()["state"],
        "lr": state.optimizer.param_groups[0]["lr"], "step": state.step})


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["lr"] == b["lr"]
    for part in ("params", "buffers"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["adam"].keys() == b["adam"].keys()
    for i in a["adam"]:
        for k, v in a["adam"][i].items():
            assert torch.equal(v, b["adam"][i][k]), ("adam", i, k)


@pytest.mark.cuda
def test_early_read_is_the_late_reads_update_bit_for_bit(cuda_device,
                                                         deterministic):
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)

    snaps = []
    for late in (False, True):
        cfg, state, step, batch = _train(cuda_device)
        if late:
            hp = head_hparams(cfg)
            step = _reading_after_backward(
                lambda out, b: column_proposal_loss(out, b, hp),
                torch.bfloat16)
        for _ in range(3):
            stats = step(state, batch)
            assert type(stats["skipped_nan"]) is float
            assert stats["skipped_nan"] == 0.0
        torch.cuda.synchronize()
        snaps.append(_snapshot(state))
    _assert_same(*snaps)


@pytest.mark.cuda
def test_nan_batch_is_skipped_on_the_card(cuda_device):
    _, state, step, batch = _train(cuda_device)
    step(state, batch)
    before = _snapshot(state)
    bad = dict(batch)
    bad["proj"] = batch["proj"].clone()
    bad["proj"][0, 5, 7, 0] = float("nan")
    stats = step(state, bad)
    assert type(stats["skipped_nan"]) is float
    assert stats["skipped_nan"] == 1.0 and not torch.isfinite(stats["loss"])
    after = _snapshot(state)
    assert after["step"] == before["step"] + 1
    after["step"] = before["step"]
    _assert_same(after, before)
    # and the next finite batch updates again
    assert step(state, batch)["skipped_nan"] == 0.0
