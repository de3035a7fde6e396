"""Host milliseconds a training step waits on the card at its loss read:
the mean ``train.guard`` span (`engine/state.py::make_train_step`) over
the traced steps (`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import train_steps, wall_ms
    steps = train_steps()
    if steps is None:
        return None
    return sum(wall_ms(st["phases"]["train.guard"])
               for st in steps) / len(steps)
