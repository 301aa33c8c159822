"""Host milliseconds an engine step takes, on average over the window
(the engine's ``engine_step_seconds`` histogram: sum over count)."""


def read(run):
    if run["kind"] != "serve" or not run["counters"]["steps"]:
        return None
    c = run["counters"]
    return 1e3 * c["step_seconds"] / c["steps"]
