"""Post-process stages that ran in NumPy because the native library
failed: the program's counter ``native_fallbacks``
(`decode/postprocess.py::_native_fallback`) over the traced stretch
(`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import counters
    c = counters()
    if c is None:
        return None
    return c.get("native_fallbacks", 0)
