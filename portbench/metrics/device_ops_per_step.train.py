"""``device_ops_per_step.train``: device operations (kernels, copies,
sets) per step in the profiled stretch of a ``train`` cell."""


def read(run):
    return run.device_ops_per_step() if run.driver == "train" else None
