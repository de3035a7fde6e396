"""Proposals a tile that pass ``proposal_obj_thre`` and the border cut,
the tracker's load: the program's counters ``proposals`` / ``tiles``
(`decode/postprocess.py::lane_maps_from_decode`) over the traced stretch
(`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import counters
    c = counters()
    if c is None:
        return None
    return c.get("proposals", 0) / c["tiles"]
