"""Share of the card's bf16 dense peak that the window's training work
reaches: 6 operations a weight a token (the head included, the
embedding lookup not) plus causal attention, forward and backward, over
the window, over 989 TFLOP/s; the recompute of remat is not counted."""
from portbench import cost


def read(run):
    if run["kind"] != "train":
        return None
    s = run["sizes"]
    b, seq = run["batch"], run["seq"]
    per_seq = cost.tokens_flops(s, 0, seq) \
        + seq * cost.head_flops(s)
    flops = 3.0 * b * per_seq * run["steps"]
    return 100.0 * flops / run["window_s"] / cost.PEAK_BF16_FLOPS
