"""live_share.boot (%): the replicate-passes of the window's batches that
did work, the sum of the replicates' iterations, over the passes enqueued,
B x K3's launches (lockstep.live_share): what the lockstep loses to
replicates that are done and to the chunk run on past the last one."""

from benchmark import lockstep


def read(run):
    return lockstep.live_share(run)
