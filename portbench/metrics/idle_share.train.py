"""``idle_share.train``: the share of the profiled stretch of a ``train``
cell in which no device operation ran, in percent."""


def read(run):
    return run.idle_share() if run.driver == "train" else None
