"""Reference checkpoints load into the port by name, on the CPU.

The repo's torch transcriptions of the reference flagship
(`tests/test_torch_parity.py::TDetector`: FPNWrapper, VitSegNet,
ColumnProposal2) and of its ``column_att`` head (``TColumnAttProposal2``,
one ``emb_{i}`` parameter per proposal) stand in for reference ``.pth``
files.  Their ``state_dict()`` loads into the port with no rules: strict
on every key but BatchNorm's ``num_batches_tracked``, through
``api.load_checkpoint`` for the whole net.  The port's outputs are then
held to the transcription's at the bar the JAX package's parity tests
use for the same transcriptions (rel-max 2e-3: the reference computes
exact GELU and LayerNorm eps 1e-5, the port flax's tanh GELU and eps
1e-6).
"""

import numpy as np
import torch
import torch.nn as nn
from torch_port_helpers import configs, nhwc, rel_max_err

TOL = 2e-3


def randomise_bn(model):
    """Running statistics away from (0, 1), as the JAX parity tests do."""
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.6, 1.4)
    return model


def assert_close(got, want, image_keys):
    for k, w in want.items():
        g = got[k].detach()
        w = w.detach()
        if k in image_keys:  # the port's net returns image maps NHWC
            w = w.permute(0, 2, 3, 1)
        assert rel_max_err(g.numpy(), w.numpy()) < TOL, k


def test_reference_detector_state_dict_loads_by_name(tmp_path):
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.api import load_checkpoint
    from test_torch_parity import IMG, VIT_DEPTH, TDetector

    torch.manual_seed(0)
    ref = randomise_bn(TDetector()).eval()
    path = str(tmp_path / "reference.pth")
    torch.save({"net": ref.state_dict()}, path)  # the reference's container

    _, cfg = configs()
    cfg.heads.endp_mode = "endpoint"  # the transcription runs the branch
    assert cfg.backbone.depth == VIT_DEPTH
    model = load_checkpoint(lmt.build_model(cfg), path).eval()
    assert set(model.state_dict()) == set(ref.state_dict())

    x = np.random.RandomState(0).rand(1, IMG, IMG, 3).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.tensor(x).permute(0, 3, 1, 2))
        got = model(torch.tensor(x))
    assert set(want) < set(got)
    assert_close(got, want, {"semantic_seg", "endp_est", "endpoint",
                             "orient"})


def test_reference_column_att_state_dict_loads_by_name():
    from lanemapping_tpu_torch.models.column_head import ColumnProposalHead
    from test_torch_parity import (DIM_SHARED, F_DIM, HB, N_ORIENT, PW, S,
                                   VIT_OUT, P, TColumnAttProposal2)

    torch.manual_seed(3)
    ref = randomise_bn(TColumnAttProposal2()).eval()
    emb = [k for k in ref.state_dict() if k.startswith("emb_")]
    assert len(emb) == P
    head = ColumnProposalHead(
        dim_feat=F_DIM, row_size=S, dim_shared=DIM_SHARED, num_prop=P,
        prop_width=PW, prop_half_buff=HB, num_orients=N_ORIENT,
        endp_mode="endpoint", in_channels=VIT_OUT, up_channels=F_DIM,
        column_att=True, dim_token=ref.DIM_TOKEN, tr_depth=1,
        tr_heads=ref.TR_HEADS, tr_dim_head=ref.TR_DH, tr_mlp_dim=ref.TR_MLP)
    missing, unexpected = head.load_state_dict(ref.state_dict(),
                                               strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    head.eval()

    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, VIT_OUT, S, S).astype(np.float32))
    x_up = torch.tensor(rng.randn(2, F_DIM, 2 * S, 2 * S).astype(np.float32))
    x_endp = torch.tensor(rng.randn(2, 1, 8 * S, 8 * S).astype(np.float32))
    with torch.no_grad():
        want = ref(x, x_up, x_endp)
        got = head(x, x_up, x_endp)
    assert set(want) < set(got)
    for k in ("endpoint", "orient"):  # both packages' heads keep NCHW here
        assert rel_max_err(nhwc(got[k]), nhwc(want[k])) < TOL, k
    assert_close({k: v for k, v in got.items() if k in want},
                 {k: v for k, v in want.items()
                  if k not in ("endpoint", "orient")}, ())
