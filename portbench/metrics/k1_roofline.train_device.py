"""``k1_roofline.train_device``: ``k1_roofline.train`` in a ``train`` cell
whose end-to-end step time is the device's (``train_device_ms``)."""


def read(run):
    return run.roofline("k1") if run.driver == "train" else None
