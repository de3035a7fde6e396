"""The K1Z kernel's share (%) of its bandwidth roofline in the traced
stretch (`lanebench/binning.py`)."""


def read(run):
    from lanebench.binning import roofline_pct
    return roofline_pct(run, "k1z")
