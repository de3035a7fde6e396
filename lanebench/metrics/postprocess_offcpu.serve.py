"""The share (%) of the post-process workers' ``serve.postprocess`` spans
(`decode/postprocess.py::lane_maps_from_decode`) in which their threads
were off the CPU: 100 x (1 - thread CPU / wall) over the traced stretch
(`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import offcpu_pct
    return offcpu_pct(("serve.postprocess",))
