"""``mfu.solve``: the model FLOP of a stretch of window blocks (K1 and K2,
``workcount``, from the per-call records of its recorded pass) over the
float32 peak times the wall time of the same work run untraced, in a
``solve`` cell, in percent."""


def read(run):
    return run.mfu() if run.driver == "solve" else None
