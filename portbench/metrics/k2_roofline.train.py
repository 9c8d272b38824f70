"""``k2_roofline.train``: K2's bound (the work of the active Gaussians, from
``workcount``) over its device time per launch in the profiled stretch of
a ``train`` cell, in percent."""


def read(run):
    return run.roofline("k2") if run.driver == "train" else None
