"""Serving example on the PyTorch port: paged continuous batching,
comparing the full-KV cache against the paper's SRF state cache (same
engine, same pool). The port of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

On the card (the default ``--device cuda``) full KV gathers its pages
with the paged_gather kernel, and SRF runs the spinner kernel in its
feature maps and the srf_decode kernel at every decode step.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402


def run(attn: str, device):
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl=attn)
    params = T.init(cfg, seed=0, device=device)
    eng = Engine(cfg, params, batch_slots=8, max_len=96, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(4, 24))).astype(np.int32), max_new=16)
        for i in range(16)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    rep = eng.cache_report(max_len=32768)
    print(f"attn={attn:4s} requests={len(done)} tokens={toks} "
          f"wall={dt:.1f}s  family={rep['family']} "
          f"bytes/token/layer@32k={rep['bytes_per_token_per_layer']:.1f}")
    return {"submitted": len(reqs), "done": len(done), "tokens": toks,
            "max_new": [len(r.out_tokens) for r in done],
            "family": rep["family"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"full": run("full", args.device)}
    out["srf"] = run("srf", args.device)  # paper technique: O(m d) state
    print("(SRF serves the same batch from a constant-size state page "
          "per request: no KV growth)")
    return out


if __name__ == "__main__":
    main()
