"""Lane windows the KLane RowRef head writes back a training step: the
program's counter ``rowref.write_backs``, one an ``index_put`` of
`models/row_head.py::write_back`, over the traced ``train.step`` spans
(`lanebench/recorder.py`); 12 (one a lane) while the head writes lane
by lane.  None from a program without the counter."""


def read(run):
    from lanebench.recorder import recorded, train_steps
    steps = train_steps()
    if steps is None:
        return None
    n = recorded()["counters"].get("rowref.write_backs")
    if n is None:
        return None
    return n / len(steps)
