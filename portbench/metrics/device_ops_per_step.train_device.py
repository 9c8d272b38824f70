"""``device_ops_per_step.train_device``: ``device_ops_per_step.train`` in a
``train`` cell whose end-to-end step time is the device's
(``train_device_ms``)."""


def read(run):
    return run.device_ops_per_step() if run.driver == "train" else None
