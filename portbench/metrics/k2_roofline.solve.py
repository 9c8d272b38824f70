"""``k2_roofline.solve``: K2's bound (the work of the active Gaussians, from
``workcount``: 1024 samples, order 2, c=1) over its device time per launch
in the profiled stretch of a ``solve`` cell, in percent."""


def read(run):
    return run.roofline("k2") if run.driver == "solve" else None
