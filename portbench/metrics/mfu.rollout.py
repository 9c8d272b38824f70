"""``mfu.rollout``: the model FLOP of a stretch of window work (``workcount``,
from the per-call records of its recorded pass) over the float32 peak
times the wall time of the same work run untraced, in a ``rollout`` cell, in
percent."""


def read(run):
    return run.mfu() if run.driver == "rollout" else None
