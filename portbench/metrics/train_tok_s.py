"""Tokens of the training steps completed in the window over the
window's seconds."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["steps"] * run["tokens_per_step"] / run["window_s"]
