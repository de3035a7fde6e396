"""The share (%) of the serving main thread's device stages in which it
was off the CPU: 100 x (1 - thread CPU / wall) over the program's spans
``serve.input`` (`tools/stream_map.py::network_input`), ``serve.forward``
(`models/nets.py::Detector1stage.forward`) and ``serve.decode``
(`stream_map.readback_view`) of the traced stretch
(`lanebench/recorder.py`)."""


def read(run):
    from lanebench.recorder import offcpu_pct
    return offcpu_pct(("serve.input", "serve.forward", "serve.decode"))
