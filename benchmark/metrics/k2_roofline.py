"""k2_roofline (%): the least time of K2's live launches in the traced
window over the device time of all its launches (trace.roofline_share;
its work per instantiation in kernels/k2_*.json)."""

from benchmark import trace


def read(run):
    return trace.roofline_share(run, "k2")
