"""The training step's share (%) of the card's dense bf16 peak: the frozen
FLOPs of a step (forward, ten-term loss, backward, no remat;
`lanebench/flops.py`, on the plain model) times the steps a second of the
window, over the published peak."""


def read(run):
    from lanebench import core
    if not run.units or not run.unit_flops or not run.window_s:
        return None
    return 100.0 * run.unit_flops * run.units / run.window_s / core.peaks(
        run.device_kind)["bf16_flops_per_s"]
