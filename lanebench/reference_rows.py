"""The plain reference of the KLane RowRef cell at work: the first three
training steps of the float32 KLane net (`lanebench/plain/models/
row_head.py`) with ``row_shar_loss``, as `lanebench/reference.py`'s
``train_steps`` takes them for the other cells, on the same seeded
weights and batches as the program.

The head routes each lane-row through a window picked by an ``argmax``
over 144 columns, and gates each lane on its mean existence.  At random
weights the top columns nearly tie, so a bf16 run and a float32 run may
pick different windows for reasons that say nothing about the program,
and from there their stage-2 outputs and gradients part.  So each step
of the reference takes a given route (the program's decisions of the
same step: each lane-row's window and each lane's gate) and computes
everything else itself.  ``route_flips`` counts the decisions the
reference would have taken otherwise by more than a rounding margin: a
window whose own best column beats the given one by more than
``route_margin`` in the reference's probability, or a gate whose mean
existence lies on the other side of ``thr_ext`` by more than
``gate_margin``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import rows
from .precision import e4m3, hook_inputs, strict_float32, weights_at
from .reference import _schedule, leaf_norms


def route_flips(out: Dict[str, torch.Tensor], route: Tuple, thr: float,
                route_margin: float, gate_margin: float) -> Dict[str, float]:
    """The decisions of ``route`` (window starts [B,N,S], gates [B,N], or
    fewer tiles) that the head's own probabilities in ``out`` would have
    taken otherwise: ``windows`` and ``gates`` that differ at all, the
    largest margins by which they differ (``window_gap``: best column's
    probability less the given column's; ``gate_gap``: distance of the
    mean existence from ``thr``), and ``flips``, those beyond the
    margins."""
    corr, gate = route
    n = corr.shape[0]
    cls = out["cls"][:n].detach().float()
    mean_ext = out["ext"][:n, ..., 0].detach().float().mean(-1)
    corr = corr.to(cls.device)
    gate = gate.to(cls.device)
    best = cls.max(-1).values
    given = torch.gather(cls, -1, corr[..., None].long())[..., 0]
    wgap = (best - given).flatten()
    ggap = torch.where((mean_ext > thr) != gate, (mean_ext - thr).abs(),
                       torch.zeros_like(mean_ext)).flatten()
    return {"windows": int((wgap > 0).sum()), "gates": int((ggap > 0).sum()),
            "window_gap": float(wgap.max()), "gate_gap": float(ggap.max()),
            "flips": int((wgap > route_margin).sum()
                         + (ggap > gate_margin).sum())}


def _lane_float8(model: torch.nn.Module) -> Tuple[set, list]:
    """Under ``float8``: the lane-batched weights (which
    `precision.weights_at` does not know) to round to e4m3, and pre-hooks
    that round their heads' inputs; (names, handles)."""
    from .plain.models.row_head import PerLaneConvHead
    names, hs = set(), []
    for mname, m in model.named_modules():
        if isinstance(m, PerLaneConvHead):
            names |= {f"{mname}.w1", f"{mname}.w2"}
            hs.append(m.register_forward_pre_hook(
                lambda m, a: (e4m3(a[0]),) + tuple(a[1:])))
    return names, hs


def train_steps(cfg: Dict, sd: Dict[str, torch.Tensor],
                batches: Sequence[Dict[str, torch.Tensor]], level: str,
                routes: Optional[List[Tuple]] = None,
                margins: Tuple[float, float] = (0.0, 0.0)) -> Dict:
    """The configuration's training steps over ``batches`` at ``level``
    (`lanebench/precision.py`; under ``float8`` the lane-batched products
    too), step ``i`` on ``routes[i]`` where given: each step's loss, the
    first step's outputs (float32), the first gradient's and the change's
    norms by leaf (as `reference.train_steps`), ``routes`` (the decisions
    each step took) and ``route`` (``route_flips`` summed over the steps,
    against the given routes, with the largest gaps)."""
    device = next(iter(sd.values())).device
    model = rows.plain_model(cfg).to(device).train()
    model.load_state_dict(sd)
    thr = cfg["heads"]["thr_ext"]
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    hs = hook_inputs(model, level)
    lane8, h8 = _lane_float8(model) if level == "float8" else (set(), [])
    losses, grad1, out1, taken = [], None, None, []
    route = {"windows": 0, "gates": 0, "window_gap": 0.0, "gate_gap": 0.0,
             "flips": 0}
    with strict_float32():
        for i, b in enumerate(batches):
            w = weights_at(model, level)
            for k in lane8:
                w[k] = e4m3(w[k])
            given = routes[i] if routes is not None else None
            inp = b["proj"].to(torch.float32 if level == "float32"
                               else torch.bfloat16).contiguous()
            out = torch.func.functional_call(model, w, (inp,),
                                             {"route": given})
            taken.append(tuple(t.cpu() for t in out.pop("route")))
            if given is not None:
                r = route_flips(out, given, thr, *margins)
                for k in ("windows", "gates", "flips"):
                    route[k] += r[k]
                for k in ("window_gap", "gate_gap"):
                    route[k] = max(route[k], r[k])
            loss = rows.loss(out, b, cfg)["loss"]
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            losses.append(float(loss.detach()))
            g = {k: (gr if gr is not None else torch.zeros_like(params[k]))
                 for k, gr in zip(params, grads)}
            if i == 0:
                grad1 = leaf_norms(g)
                out1 = {k: v.detach().float() for k, v in out.items()}
            lr = _schedule(cfg, i)
            t = i + 1
            with torch.no_grad():
                for k, p in params.items():
                    m[k].mul_(0.9).add_(g[k], alpha=0.1)
                    v2[k].mul_(0.999).addcmul_(g[k], g[k], value=0.001)
                    den = (v2[k] / (1 - 0.999 ** t)).sqrt_().add_(1e-8)
                    p.sub_(lr * (m[k] / (1 - 0.9 ** t)) / den)
    for h in hs + h8:
        h.remove()
    change = leaf_norms({k: params[k].detach() - start[k] for k in params})
    del model, m, v2, start
    return {"losses": losses, "out1": out1, "grad1": grad1,
            "change": change, "routes": taken, "route": route}
