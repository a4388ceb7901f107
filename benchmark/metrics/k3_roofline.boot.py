"""k3_roofline.boot (%): the least time of each of K3's launches in the
traced window at the replicates live in it, over the device time of all
its launches (lockstep.roofline_share; its work per instantiation in
kernels/k3_*.json).  A replicate that is done does no row work, so the
least time follows the live replicates, not the batch's B."""

from benchmark import lockstep


def read(run):
    return lockstep.roofline_share(run, "k3")
