"""Device milliseconds of the optimizer (``optim/adamw.update``) a step,
on average over the window: CUDA events the benchmark records around
the call in a traced run."""


def read(run):
    if run["kind"] != "train" or not run.get("adamw_ms"):
        return None
    return sum(run["adamw_ms"]) / len(run["adamw_ms"])
