"""Two faults of the port, repaired in the port's copy only, on the CPU.

- The proposal-GT cache (``cfg.gt_cache``) keyed a sample by head geometry
  alone, so a cache filled in training served evaluation samples without
  their ``mask`` and ``Runner.validate`` dropped the semantic F1 without a
  word.  A validate on a cache filled by training must equal an uncached
  validate.
- A checkpoint restored the dropout generator's state into a generator of
  the model's device, and a CPU generator refuses a CUDA generator's
  16-byte state.  A checkpoint written on the card must load for
  evaluation (``LaneMapper``, ``tools/infer.py``) and resume on the CPU.
"""

import os
import struct

import pytest
import torch
from torch_port_helpers import TINY, wire_data_root

NAMES = [f"{190000 + i:06d}_{i:04d}" for i in range(4)]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3, splits={
        "train": NAMES, "valid": NAMES, "test": NAMES[2:],
        "single": NAMES[:1], "pretrain": NAMES})
    return root


def tiny_cfg(root, **over):
    import lanemapping_tpu_torch as lmt
    cfg = wire_data_root(lmt.Config.fromfile(TINY), root)
    for k, v in over.items():
        cfg[k] = v
    return cfg


def test_validate_on_a_cache_filled_in_training(data_root, tmp_path):
    from lanemapping_tpu_torch.data.laserlane import LaserLaneProposal
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.runner import Runner

    cached = tiny_cfg(data_root, gt_cache=True)
    train = LaserLaneProposal(data_root, mode="train", cfg=cached)
    for i in range(len(train)):  # fills the cache with training samples
        assert "mask" not in train[i]
    metrics = {}
    for name, cfg in (("uncached", tiny_cfg(data_root)),
                      ("cached", cached), ("cached again", cached)):
        runner = Runner(cfg, log_dir=str(tmp_path / name), device="cpu")
        metrics[name] = runner.validate(loader=build_dataloader(
            cfg.dataset.val, cfg, is_train=False))
    assert "semantic_f1" in metrics["uncached"]
    assert metrics["cached"] == metrics["uncached"]
    assert metrics["cached again"] == metrics["uncached"]
    assert LaserLaneProposal(data_root, mode="valid", cfg=cached)[0][
        "mask"].shape == (192, 192)


def cuda_style_state(seed, offset=0):
    """A CUDA generator's state: its seed and philox offset, 8 bytes each."""
    return torch.tensor(list(struct.pack("<QQ", seed, offset)),
                        dtype=torch.uint8)


@pytest.fixture()
def card_checkpoint(data_root, tmp_path):
    """A Runner checkpoint as the card writes it: trained weights, step 5
    and a CUDA generator's state; (log_dir, the saved weights)."""
    from lanemapping_tpu_torch.engine.checkpoint import STATE_FILE, save_model
    from lanemapping_tpu_torch.engine.runner import Runner

    log_dir = str(tmp_path / "card")
    runner = Runner(tiny_cfg(data_root), log_dir=log_dir, device="cpu")
    with torch.no_grad():
        for p in runner.model.parameters():
            p.add_(0.01)
    runner.state.step = 5
    path = os.path.join(save_model(log_dir, runner.state, "epoch_1"),
                        STATE_FILE)
    ckpt = torch.load(path, weights_only=True)
    ckpt["generator"] = cuda_style_state(2021, 4096)
    ckpt["generator_device"] = "cuda"
    torch.save(ckpt, path)
    return log_dir, {k: v.clone() for k, v in ckpt["model"].items()}


def assert_same_weights(model, weights):
    sd = model.state_dict()
    assert set(sd) == set(weights)
    for k, v in weights.items():
        assert torch.equal(sd[k].cpu(), v), k


def test_card_checkpoint_serves_on_the_cpu(data_root, card_checkpoint):
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools import infer

    log_dir, weights = card_checkpoint
    ckpt_dir = os.path.join(log_dir, "ckpt", "epoch_1")
    mapper = lmt.LaneMapper(tiny_cfg(data_root), ckpt=ckpt_dir,
                            device="cpu", log_dir=log_dir)
    assert_same_weights(mapper.model, weights)
    res = infer.main([TINY, f"dataset.test.data_root={data_root}",
                      f"log_dir={log_dir}", "--device", "cpu", "--ckpt",
                      ckpt_dir, "--max-batches", "1"])
    assert "composite" in res["metrics"]


@pytest.mark.parametrize("recorded", [True, False])
def test_card_checkpoint_resumes_on_the_cpu(data_root, card_checkpoint,
                                            recorded, caplog):
    """The generator is reseeded from (seed, step) and training goes on; a
    checkpoint written before the device type was recorded is told apart
    by the size of its state."""
    from lanemapping_tpu_torch.engine.checkpoint import STATE_FILE
    from lanemapping_tpu_torch.engine.runner import Runner

    log_dir, weights = card_checkpoint
    if not recorded:
        path = os.path.join(log_dir, "ckpt", "epoch_1", STATE_FILE)
        ckpt = torch.load(path, weights_only=True)
        del ckpt["generator_device"]
        torch.save(ckpt, path)
    cfg = tiny_cfg(data_root)
    runner = Runner(cfg, log_dir=log_dir, device="cpu")
    assert runner.resume_latest()
    assert runner.state.step == 5
    assert_same_weights(runner.model, weights)
    want = torch.Generator().manual_seed(cfg.seed * 2 ** 32 + 5)
    assert torch.equal(runner.state.generator.get_state(), want.get_state())
    assert "reseeded" in caplog.text
    runner.train(max_iters=1)
    assert runner.state.step == 6


def test_same_device_resume_restores_the_generator(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.engine.runner import Runner

    cfg = tiny_cfg(data_root)
    runner = Runner(cfg, log_dir=str(tmp_path), device="cpu")
    torch.rand(7, generator=runner.state.generator)
    saved = runner.state.generator.get_state()
    save_model(str(tmp_path), runner.state, "epoch_1")
    fresh = Runner(cfg, log_dir=str(tmp_path), device="cpu")
    assert not torch.equal(fresh.state.generator.get_state(), saved)
    assert fresh.resume_latest()
    assert torch.equal(fresh.state.generator.get_state(), saved)
