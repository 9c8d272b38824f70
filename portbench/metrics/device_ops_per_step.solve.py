"""``device_ops_per_step.solve``: device operations (kernels, copies, sets)
per Adam iteration in the profiled stretch of a ``solve`` cell."""


def read(run):
    return run.device_ops_per_step() if run.driver == "solve" else None
