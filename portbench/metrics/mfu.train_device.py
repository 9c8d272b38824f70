"""``mfu.train_device``: the model FLOP of a stretch of window work
(``workcount``, from the per-call records of its recorded pass) over the
float32 peak times the device's busy time in the profiled pass of the same
work, in a ``train`` cell, in percent."""


def read(run):
    return run.mfu_device() if run.driver == "train" else None
