"""Share of its roofline that the spinner kernel reaches
(``csrc/spinner.cu``, ``spinner_kernel``: the SRF feature maps, one
launch for a layer's queries and one for its keys): the bound of every
launch in the window, from the frozen cost copy at the step's shapes
(Hkv groups of prefill rows x chunk rows, the queries' x Hq / Hkv, bf16),
over the device time of those launches."""
from portbench import cost


def read(run):
    if run["kind"] != "serve" or "trace" not in run \
            or run["sizes"]["attn"] != "srf":
        return None
    s, e, c = run["sizes"], run["engine"], run["counters"]
    launches = [(a, b) for name, a, b in run["trace"][0]
                if "spinner_kernel" in name and "seeded" not in name]
    if c["decode_steps"] or not launches \
            or len(launches) != 2 * s["layers"] * c["prefill_steps"]:
        return None
    rows = e["prefill_batch"] * e["prefill_chunk"]
    g, n, m = s["hq"] // s["hkv"], s["hd"], s["m"]
    bound = 0.0
    for b in (g * rows, rows):              # queries, keys
        ops, byts = cost.spinner(s["kind"], s["hkv"], b, n, m, 2,
                                 cost.gen_elems(s["kind"], n, m), m)
        bound += cost.bound_s(ops, byts)
    bound *= s["layers"] * c["prefill_steps"]
    return 100.0 * bound / sum(b - a for a, b in launches)
