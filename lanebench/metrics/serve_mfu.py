"""The served model's share (%) of the card's dense bf16 peak: the frozen
forward FLOPs a tile (`lanebench/flops.py`, on the plain model) times the
tiles a second of the window, over the published peak."""


def read(run):
    from lanebench import core
    rate = run.e2e.get("serve_tiles_per_s")
    if not rate or not run.unit_flops:
        return None
    return 100.0 * run.unit_flops * rate / core.peaks(
        run.device_kind)["bf16_flops_per_s"]
