"""Share of the traced window in which no operation ran on the device:
one minus the union of the device operations' intervals over the
window."""


def read(run):
    if run["kind"] != "serve" or "trace_summary" not in run:
        return None
    t = run["trace_summary"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
