"""``idle_share.solve``: the share of the profiled stretch of a ``solve``
cell in which no device operation ran, in percent."""


def read(run):
    return run.idle_share() if run.driver == "solve" else None
