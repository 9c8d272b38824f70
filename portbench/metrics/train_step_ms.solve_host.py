"""``train_step_ms.solve_host``: the host clock's time of the window over
its Adam iterations in a ``solve`` cell (window time to the end of the last
block finished in it, each block ending in the loss's host read), the wall
time a user of the solve waits; a per-layer reading because runs of one
code spread on the host's clock by more than an end-to-end bound holds.
A traced run's window records nothing, so this is its plain host time."""


def read(run):
    if run.driver != "solve":
        return None
    return run.result["metrics"].get("train_step_ms")
