"""Training BatchNorm calls a step that normalised a bf16 or fp16
activation in one mixed-precision call: the program's counter
``bn_mixed`` (`models/norm.py::_FlaxBatchNorm._normalise_mixed`) over
the traced ``train.step`` spans (`lanebench/recorder.py`).  0 where every
BatchNorm sees float32; no reading from a program whose BatchNorm has no
such call (no ``MIXED_DTYPES``)."""


def read(run):
    from lanebench.recorder import recorded, train_steps
    try:
        from lanemapping_tpu_torch.models.norm import MIXED_DTYPES  # noqa: F401
    except ImportError:
        return None
    steps = train_steps()
    if steps is None:
        return None
    return recorded()["counters"].get("bn_mixed", 0) / len(steps)
