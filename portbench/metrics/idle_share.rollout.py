"""``idle_share.rollout``: the share of the profiled stretch of a ``rollout``
cell in which no device operation ran, in percent."""


def read(run):
    return run.idle_share() if run.driver == "rollout" else None
