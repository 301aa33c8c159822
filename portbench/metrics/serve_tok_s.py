"""Valid prompt tokens prefilled in the window over the window's
seconds (the engine's ``engine_prefill_tokens_total``, read at the
window's two ends): all the work over all the time."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["counters"]["prefill_tokens"] / run["window_s"]
