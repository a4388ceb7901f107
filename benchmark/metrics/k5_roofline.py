"""k5_roofline (%): the least time of K5's live launches in the traced
window over the device time of all its launches (trace.roofline_share;
its work per instantiation in kernels/k5_*.json)."""

from benchmark import trace


def read(run):
    return trace.roofline_share(run, "k5")
