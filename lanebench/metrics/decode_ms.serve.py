"""Host or device milliseconds a batch of the serving stage 'decode' in
the window (the serving loop's spans, `lanebench/loops/serve.py`)."""


def read(run):
    return run.spans.mean_ms("decode")
