"""Loss primitives (port of `lanemapping_tpu/ops/losses.py`).

Elementwise functions on tensors with the JAX package's formulas:
torchvision's sigmoid focal loss on the explicit stable BCE
``max(x, 0) - x*y + log1p(exp(-|x|))``, torch's smooth-L1, and a
cross-entropy that CLIPS its integer labels into ``[0, C-1]`` (labels -1
and 255 score against class 0 and class C-1), which
``F.cross_entropy(ignore_index=...)`` does not.
"""

from __future__ import annotations

import torch


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Numerically stable binary CE with logits (elementwise)."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Elementwise focal loss, torchvision defaults."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber/smooth-L1, torch semantics."""
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def cross_entropy_with_int_labels(logits: torch.Tensor,
                                  labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``-log softmax(logits)[label]`` in float32; logits
    [..., C], labels [...] integer, clipped into [0, C-1].  The JAX
    package's one-hot contraction sums one non-zero term, so the gather
    gives the same values."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = labels.long().clamp(0, logits.shape[-1] - 1)
    return -torch.gather(logp, -1, idx[..., None])[..., 0]
