"""``device_ops_per_step.rollout``: device operations (kernels, copies,
sets) per step in the profiled stretch of a ``rollout`` cell."""


def read(run):
    return run.device_ops_per_step() if run.driver == "rollout" else None
