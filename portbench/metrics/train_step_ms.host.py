"""``train_step_ms.host``: the host clock's time of the window over its
steps, as ``train_step_ms`` reads it, in a ``train`` cell where runs of
one code spread too widely on the host's clock for that metric to hold a
bound; a traced run's window records nothing."""


def read(run):
    if run.driver != "train":
        return None
    return run.result["metrics"].get("train_step_ms")
