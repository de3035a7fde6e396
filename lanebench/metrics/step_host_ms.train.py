"""Host milliseconds to enqueue one training step: the mean over the
traced steps of the ``train.step`` span's wall time less its
``train.guard`` span's (`engine/state.py::make_train_step`;
`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import train_steps, wall_ms
    steps = train_steps()
    if steps is None:
        return None
    return sum(wall_ms(st) - wall_ms(st["phases"]["train.guard"])
               for st in steps) / len(steps)
