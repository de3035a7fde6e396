"""Seconds this process spent building the program's native libraries
(nvcc in `kernels/build.py::build_all`, g++ in
`native/__init__.py::build_library`): the union of the recorded builds,
0 when every library was fresh (`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import build_seconds
    return build_seconds()
