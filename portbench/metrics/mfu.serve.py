"""Share of the card's bf16 dense peak that the window's useful work
reaches: the operations its valid prompt tokens need, counted from the
configuration (``cost.token_flops`` at each token's position, the head
on each request's last prompt token), over the window, over 989
TFLOP/s. The tokens come from the engine's ``prefill_chunk`` spans."""
from portbench import cost


def read(run):
    if run["kind"] != "serve" or "spans" not in run:
        return None
    s = run["sizes"]
    plen = {q["uid"]: q["prompt_len"] for q in run["requests"]}
    done = {}
    flops = 0.0
    for sp in run["spans"]:
        if sp["name"] != "prefill_chunk":
            continue
        start = done.get(sp["uid"], 0)
        end = start + sp["tokens"]
        done[sp["uid"]] = end
        if not run["t0"] <= sp["t"] <= run["t1"]:
            continue
        flops += cost.tokens_flops(s, start, end)
        if end == plen[sp["uid"]]:
            flops += cost.head_flops(s)
    return 100.0 * flops / run["window_s"] / cost.PEAK_BF16_FLOPS
