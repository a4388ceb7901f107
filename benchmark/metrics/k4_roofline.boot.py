"""k4_roofline.boot (%): the least time of each of K4's launches in the
traced window at the replicates live in it, over the device time of all
its launches (lockstep.roofline_share; its work per instantiation in
kernels/k4_*.json).  A job's first launch, the init, has every replicate
live."""

from benchmark import lockstep


def read(run):
    return lockstep.roofline_share(run, "k4")
