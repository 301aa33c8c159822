"""The 90th percentile, over every request whose first token lands in
the window, of first token minus queued (the request's trace stamps;
for scoring traffic, the request's latency)."""
from portbench.bench import quantile


def read(run):
    if run["kind"] != "serve":
        return None
    ttft = [q["first_token"] - q["queued"] for q in run["requests"]
            if q["first_token"] is not None
            and run["t0"] <= q["first_token"] <= run["t1"]]
    return quantile(ttft, 0.9) if ttft else None
