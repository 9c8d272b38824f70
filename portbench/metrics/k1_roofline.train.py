"""``k1_roofline.train``: K1's bound (the work of the active Gaussians, from
``workcount``) over its device time per launch in the profiled stretch of
a ``train`` cell, in percent."""


def read(run):
    return run.roofline("k1") if run.driver == "train" else None
