"""Host milliseconds a training step spends in the KLane RowRef head's
forward: the ``rowref.head`` spans' wall time
(`models/row_head.py::RowSharNotReducRef.forward`) over the traced
``train.step`` spans (`lanebench/recorder.py`).  None from a program
without the span."""


def read(run):
    from lanebench.recorder import recorded, train_steps, wall_ms
    steps = train_steps()
    if steps is None:
        return None
    heads = [s for s in recorded()["spans"] if s["name"] == "rowref.head"]
    if not heads:
        return None
    return sum(wall_ms(s) for s in heads) / len(steps)
