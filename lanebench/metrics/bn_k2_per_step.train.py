"""Training BatchNorm calls a step that K2 normalised: the program's
counter ``bn_k2``, one a launch of its forward pass on the card
(`kernels/batch_norm.py::bn_forward`), over the traced ``train.step``
spans (`lanebench/recorder.py`).  The mixed calls K2 does not take (a
layout it refuses) go to the library and count in ``bn_mixed`` only.  0
where every BatchNorm sees float32; no reading from a program without
K2."""


def read(run):
    from lanebench.recorder import recorded, train_steps
    try:
        from lanemapping_tpu_torch.kernels.batch_norm import bn_forward  # noqa: F401
    except ImportError:
        return None
    steps = train_steps()
    if steps is None:
        return None
    return recorded()["counters"].get("bn_k2", 0) / len(steps)
