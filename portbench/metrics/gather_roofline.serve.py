"""Share of its roofline that the bf16 paged gather reaches
(``csrc/paged_gather.cu``, ``paged_gather_kernel``: a layer's K and V
pools in one launch), over the window's prefill steps: the bound of
every launch from the frozen cost copy at its step's shapes, over the
device time of those launches. A launch writes rows x table width x
page rows of Hkv x hd for each pool, and reads each distinct page its
tables name once: every page of the step's requests (the scheduler
allocates a prompt's pages at admission) and the null page of the
padded columns. The step's requests come from the engine's
``prefill_step`` spans and their ``prefill_chunk`` instants."""
from portbench import cost


def read(run):
    if run["kind"] != "serve" or "trace" not in run \
            or run["sizes"]["attn"] != "full" or "spans" not in run \
            or run["counters"]["decode_steps"]:
        return None
    s, e = run["sizes"], run["engine"]
    page = e["page_size"]
    width = -(-e["max_len"] // page)
    plen = {q["uid"]: q["prompt_len"] for q in run["requests"]}
    steps = [sp for sp in run["spans"] if sp["name"] == "prefill_step"
             and run["t0"] <= sp["t"] <= run["t1"]]
    chunks = [sp for sp in run["spans"] if sp["name"] == "prefill_chunk"]
    launches = [b - a for name, a, b in run["trace"][0]
                if "paged_gather_kernel" in name and "dequant" not in name]
    if not steps or len(launches) != s["layers"] * len(steps):
        return None
    d = s["hkv"] * s["hd"]
    bound = 0.0
    for st in steps:
        pages = sum(-(-plen[c["uid"]] // page) for c in chunks
                    if st["t"] <= c["t"] <= st["t1"])
        rows = e["prefill_batch"] * width * page
        reads = (pages + (pages < e["prefill_batch"] * width)) * page
        ops, byts = cost.gather(rows, d, 2, read_rows=reads)
        bound += s["layers"] * cost.bound_s(2 * ops, 2 * byts)
    return 100.0 * bound / sum(launches)
