"""Training steps whose NaN-guard read still waited on the card: the
program's counter ``guard_waits``, 0 or 1 a step
(`engine/state.py::make_train_step`), over the traced ``train.step``
spans (`lanebench/recorder.py`); 0 where the loss's flag had left the
card before the host reached ``train.guard``.  None from a program
without the counter."""


def read(run):
    from lanebench.recorder import recorded, train_steps
    steps = train_steps()
    if steps is None:
        return None
    n = recorded()["counters"].get("guard_waits")
    if n is None:
        return None
    return n / len(steps)
