"""Share of the prefill steps' token slots that carried a valid prompt
token: ``engine_prefill_tokens_total`` over prefill steps x rows x
chunk, in the window."""


def read(run):
    if run["kind"] != "serve" or not run["counters"]["prefill_steps"]:
        return None
    c, e = run["counters"], run["engine"]
    slots = c["prefill_steps"] * e["prefill_batch"] * e["prefill_chunk"]
    return 100.0 * c["prefill_tokens"] / slots
