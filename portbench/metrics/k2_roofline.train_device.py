"""``k2_roofline.train_device``: ``k2_roofline.train`` in a ``train`` cell
whose end-to-end step time is the device's (``train_device_ms``)."""


def read(run):
    return run.roofline("k2") if run.driver == "train" else None
