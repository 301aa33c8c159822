"""Dry run: analyze every (arch x shape x mesh) cell, and the serving
smokes. Port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape decode_32k [--multi-pod] [--attn srf] [--remat dots]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-mesh --device cpu

A cell (:func:`run_cell`) runs its step (train, prefill or decode) once
at full width on the ``meta`` device (shapes and dtypes, no storage, no
arithmetic) under ``launch.cost_analysis``, on the production mesh
(``launch.mesh.make_production_mesh``, 256 or 512 positions of the one
device repeated), and records what the reference's lowering records:
per-device bytes of params, optimizer state, cache and batch (exactly,
from the shard shapes of the layout rules), flops, HBM bytes, the peak
of live bytes, the roofline terms and whether the peak fits one card.

The reference compiles the partitioned program and walks its
per-device HLO. The port has no partitioner: it counts the global step
and divides its flops, bytes and live activations by the widths the
layout rules and the constrainer shard them over (an ideal partition:
the batch over the data axes where the activations' batch divides, and
the model axis by the share of the params each device holds). It sees
no collective the partitioner would insert: ``collective_bytes`` counts
only the port's own collectives (none in these steps).

The smokes (:func:`pipeline_smoke`, :func:`serve_mesh_smoke`,
:func:`serve_chaos_smoke`, :func:`serve_prefix_smoke`,
:func:`serve_seeded_smoke`) check the reference's invariants on the
port's engine, router, meshes and chaos harness; the meshes are one
device (``--device``) repeated. ``check_bench`` (the reference's
benchmark gate) waits for the port's benchmark.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import registry, shapes as shp
from repro_torch.distributed import sharding as S
from repro_torch.launch import cost_analysis as H
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import hooks
from repro_torch.models import transformer as T
from repro_torch.obs.report import Reporter
from repro_torch.optim import adamw

# the card's memory: torch.cuda.get_device_properties(0).total_memory of
# an NVIDIA H100 80GB HBM3 (700 W), the counterpart of the reference's
# 16 GiB v5e chip
HBM_PER_CHIP = 85_017_493_504


def _zeros(t: torch.Tensor, device) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def step_call(cfg, step: str, b: int, l: int, device="meta"):
    """The step of a cell and its arguments on ``device``: params from
    ``transformer.init`` (trainable for a train step, with AdamW state),
    a zero batch of ``b`` sequences of ``l`` tokens (``shapes.batch_specs``)
    and, to prefill or decode, a zero serve cache of ``l`` positions.
    -> (fn, args)."""
    params = T.init(cfg, device=device)
    if step == "train":
        T.requires_grad(params)
        batch = {k: _zeros(v, device)
                 for k, v in shp.batch_specs(cfg, b, l, True).items()}
        return steps.make_train_step(cfg), (params, adamw.init(params), 0,
                                            batch)
    cache = T.init_serve_cache(cfg, b, l, device=device)
    if step == "prefill":
        batch = {k: _zeros(v, device)
                 for k, v in shp.batch_specs(cfg, b, l, False).items()}
        return steps.make_prefill_step(cfg), (params, batch, cache)
    if step == "decode":
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=device)
        return steps.make_serve_step(cfg), (params, cache, tokens)
    raise ValueError(step)


def _shard_bytes(tree, placements) -> int:
    """Bytes one device holds of a tree laid out by ``placements``."""
    total = 0
    for x, ns in zip(tree_lib.leaves(tree), tree_lib.leaves(placements)):
        if isinstance(x, torch.Tensor):
            total += math.prod(ns.shard_shape(x.shape)) * x.element_size()
    return total


def _failed(rec: Dict, e: Exception) -> None:
    rec["ok"] = False
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-2000:]


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             use_reduced: bool = False, overrides: Optional[Dict] = None,
             device="meta") -> Dict:
    """One cell's record (the module docstring); ``ok`` is False with the
    error on any exception."""
    t0 = time.time()
    cfg, note = shp.cell_config(arch, shape, use_reduced, **(overrides or {}))
    ss = shp.SHAPES[shape]
    positions = 512 if multi_pod else 256
    mesh = M.make_production_mesh(
        multi_pod=multi_pod, devices=[torch.device(device)] * positions)
    chips = mesh.devices.size
    hooks.set_constrainer(S.make_constrainer(mesh, cfg))
    rec: Dict = {
        "arch": arch, "shape": shape, "mesh": M.describe(mesh),
        "chips": chips, "step": ss.step, "attn_impl": cfg.attn_impl,
        "note": note, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    try:
        fn, args = step_call(cfg, ss.step, ss.global_batch, ss.seq_len,
                             device)
        params = args[0]
        pspecs = S.param_specs(params, mesh)
        rec["param_bytes"] = _shard_bytes(params, S.named(mesh, pspecs))
        param_global = sum(H.tensor_bytes(t) for t in tree_lib.leaves(params))
        if ss.step == "train":
            opt, batch = args[1], args[3]
            ospecs = S.opt_state_specs(opt, params, pspecs, mesh)
            rec["opt_bytes"] = _shard_bytes(opt, S.named(mesh, ospecs))
        else:
            cache = args[2] if ss.step == "prefill" else args[1]
            batch = args[1] if ss.step == "prefill" else {"t": args[2]}
            cspecs = S.cache_specs_tree(cache, cfg, mesh)
            rec["cache_bytes"] = _shard_bytes(cache, S.named(mesh, cspecs))
        rec["batch_bytes"] = _shard_bytes(
            batch, S.named(mesh, S.batch_specs_tree(batch, mesh)))
        rec["arg_bytes"] = sum(rec.get(k, 0) for k in (
            "param_bytes", "opt_bytes", "cache_bytes", "batch_bytes"))
        with H.Analysis() as a:
            fn(*args)
        an = a.result()
        dp = max([w for role, _, w in a.shares if role == "activation"],
                 default=1)
        model = param_global / max(rec["param_bytes"], 1)
        width = dp * model
        rec.update({"dp_width": dp, "model_width": model,
                    "global_flops": an["flops"], "global_bytes": an["bytes"],
                    "flops": an["flops"] / width,
                    "bytes": an["bytes"] / width,
                    "collective_bytes": an["collective_bytes"],
                    "temp_bytes": an["peak_bytes"] / width})
        rec.update({k: v for k, v in an.items() if k.startswith(
            ("coll/", "kernel/"))})
        rec["peak_bytes"] = rec["arg_bytes"] + rec["temp_bytes"]
        rec.update(H.roofline_terms(rec))
        rec["fits_hbm"] = bool(rec["peak_bytes"] < HBM_PER_CHIP)
        rec["ok"] = True
    except Exception as e:  # failures here are bugs in the system
        _failed(rec, e)
    finally:
        hooks.reset()
    rec["run_s"] = round(time.time() - t0, 2)
    return rec


def pipeline_smoke(device="cuda") -> Dict:
    """``--pipeline``: spinner-pipeline serialization round-trip smoke.

    Builds a mixed-kind 3-block SpinnerPipeline, round-trips it through
    ``spinner.dumps``/``loads`` (the checkpointable config form), and
    proves the reloaded pipeline is spec-equal AND bit-identical under
    ``apply`` with the same params on ``device``, the invariant
    checkpoint restore relies on. ``dumps`` holds the serialized form.
    """
    from repro_torch.core import spinner
    t0 = time.time()
    pipe = spinner.chain(
        [spinner.SpinnerBlock("circulant", 128, 128),
         spinner.SpinnerBlock("toeplitz", 128, 128),
         spinner.SpinnerBlock("skew_circulant", 256, 128)], f="relu")
    rec: Dict = {"cell": "pipeline_smoke", "depth": pipe.depth,
                 "n_in": pipe.n_in, "out_dim": pipe.out_dim,
                 "budget_t": pipe.budget, "storage_floats": pipe.storage}
    try:
        blob = spinner.dumps(pipe)
        pipe2 = spinner.loads(blob)
        gen = torch.Generator(device=device).manual_seed(0)
        params = pipe.init(gen, device=device)
        x = torch.randn((8, pipe.n_in), generator=gen, device=device) * 0.3
        with torch.no_grad():
            y1 = pipe.apply(params, x)
            y2 = pipe2.apply(params, x)
        rec["dumps"] = blob
        rec["config_bytes"] = len(blob)
        rec["roundtrip_spec_equal"] = bool(pipe2 == pipe)
        rec["roundtrip_apply_identical"] = bool(torch.equal(y1, y2))
        rec["apply_finite"] = bool(torch.isfinite(y1).all())
        rec["ok"] = (rec["roundtrip_spec_equal"]
                     and rec["roundtrip_apply_identical"]
                     and rec["apply_finite"])
    except Exception as e:
        _failed(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _meshes(device, replicas: int = 2, model_parallel: int = 2):
    """Router meshes over ``device`` repeated."""
    return M.make_serving_meshes(
        replicas, model_parallel,
        devices=[torch.device(device)] * (replicas * model_parallel))


def _prompts(cfg, lens, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def serve_mesh_smoke(arch: str = "qwen3-4b", device="cuda") -> Dict:
    """``--serve-mesh``: mesh-serving end-to-end smoke.

    Builds 2 router-managed engine replicas with model-axis-sharded page
    pools (TP=2 each, on ``device`` repeated), serves 4 mixed-length
    requests end to end, and checks (a) every request completes with
    greedy tokens identical to the single-host paged engine, (b)
    per-device pool bytes are 1/model_axis of the single-host layout.
    """
    from repro_torch.serving import Engine, Request, Router
    from repro_torch.serving.mesh import shard as mesh_shard

    t0 = time.time()
    cfg = registry.reduced(arch, n_layers=2)
    rec: Dict = {"cell": "serve_mesh_smoke", "arch": arch,
                 "device": str(device)}
    try:
        params = T.init(cfg, device=device)
        prompts = _prompts(cfg, [3, 9, 17, 6])
        single = Engine(cfg, params, batch_slots=4, max_len=64,
                        device=device)
        for i, p in enumerate(prompts):
            single.submit(Request(uid=i, prompt=p, max_new=6))
        want = {r.uid: r.out_tokens for r in single.run()}

        meshes = _meshes(device)
        router = Router([Engine(cfg, params, batch_slots=4, max_len=64,
                                device=device, mesh=m) for m in meshes])
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, prompt=p.copy(), max_new=6))
        got = {r.uid: r.out_tokens for r in router.run()}

        rep = router.engines[0].cache_report()
        tp = mesh_shard.paged_tp(cfg, meshes[0])
        rec.update({
            "replicas": 2, "model_parallel": 2, "paged_tp": tp,
            "requests_done": len(got),
            "tokens_match_single_host": bool(got == want),
            "pool_bytes_single": single.cache_report()["pool_bytes"],
            "pool_bytes_per_device": rep["pool_bytes_per_device"],
            "router": router.describe(),
        })
        rec["ok"] = (got == want and len(got) == len(prompts)
                     and tp == 2
                     and rep["pool_bytes_per_device"] * tp
                     == single.cache_report()["pool_bytes"])
    except Exception as e:
        _failed(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def serve_chaos_smoke(arch: str = "qwen3-4b", device="cuda") -> Dict:
    """``--serve-chaos``: fault-tolerant mesh-serving smoke.

    Builds 2 router-managed TP=2 replicas sharing one metrics registry,
    arms the FT watchdog, and kills replica 1 mid-decode with the
    TEST-ONLY chaos harness (``raise`` at its 4th step). Checks (a) every
    request still completes with greedy tokens bit-identical to an
    undisturbed single-host run (exactly-once rescue), (b) exactly one
    quarantine and zero rescue failures, (c) after ``heal`` + ``revive``
    the pool leaks no pages/slots and fresh requests bit-match too.
    """
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving import Engine, FTConfig, Request, Router
    from repro_torch.serving.chaos import ChaosEngine, ChaosPlan

    t0 = time.time()
    cfg = registry.reduced(arch, n_layers=2)
    rec: Dict = {"cell": "serve_chaos_smoke", "arch": arch,
                 "device": str(device)}
    try:
        params = T.init(cfg, device=device)
        prompts = _prompts(cfg, [3, 9, 17, 6, 11, 5])
        single = Engine(cfg, params, batch_slots=4, max_len=64,
                        device=device)
        for i, p in enumerate(prompts):
            single.submit(Request(uid=i, prompt=p.copy(), max_new=6))
        want = {r.uid: r.out_tokens for r in single.run()}

        reg = MetricsRegistry()
        engines = [Engine(cfg, params, batch_slots=2, max_len=64, seed=i,
                          device=device, mesh=m, metrics=reg)
                   for i, m in enumerate(_meshes(device))]
        chaos = ChaosEngine(engines[1], ChaosPlan("raise", at_step=4))
        engines[1] = chaos
        router = Router(engines, metrics=reg, ft=FTConfig())
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, prompt=p.copy(), max_new=6))
        got = {r.uid: r.out_tokens for r in router.run()}

        v = reg.value_sum
        quarantined = int(router.metrics.value_sum(
            "router_quarantined_total"))
        rec.update({
            "replicas": 2, "model_parallel": 2,
            "requests_done": len(got),
            "tokens_match_undisturbed": bool(got == want),
            "quarantined": quarantined,
            "dead_after_fault": sorted(router.dead),
            "rescued": int(router.metrics.value_sum("router_rescued_total")),
            "replayed": int(router.metrics.value_sum(
                "router_replayed_total")),
            "failed": int(router.metrics.value_sum("router_failed_total")),
        })

        chaos.heal()
        revived = router.revive(1)
        extra = [Request(uid=100 + i, prompt=p.copy(), max_new=6)
                 for i, p in enumerate(prompts[:2])]
        for r in extra:
            router.submit(r)
        router.run()
        used = sum(e.sched.alloc.used_pages for e in router.engines)
        slots = sum(e.sched.slot_alloc.used_pages for e in router.engines
                    if e.sched.slot_alloc is not None)
        conserved = (v("sched_submitted_total") + v("sched_adopted_total")
                     == v("sched_finished_total")
                     + v("sched_released_total"))
        rec.update({
            "revived": bool(revived),
            "extra_after_revive_match": bool(
                all(np.array_equal(r.out_tokens, want[r.uid - 100])
                    for r in extra)),
            "used_pages_after": used, "used_slots_after": slots,
            "conservation_holds": bool(conserved),
            "router": router.describe(),
        })
        rec["ok"] = (got == want and len(got) == len(prompts)
                     and quarantined == 1 and rec["failed"] == 0
                     and rec["dead_after_fault"] == [1]
                     and revived and rec["extra_after_revive_match"]
                     and used == 0 and slots == 0 and conserved)
    except Exception as e:
        _failed(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def serve_prefix_smoke(arch: str = "qwen3-4b", device="cuda") -> Dict:
    """``--serve-prefix``: prefix-sharing serving smoke.

    Serves 8 requests sharing a 32-token prompt prefix through one
    paged engine with the radix prefix cache + chunked prefill armed
    (small slot count so admission staggers into waves and later waves
    can hit the donor wave's cached pages). Checks (a) the cache
    actually hit (hit-rate > 0 and strictly fewer tokens prefilled than
    the cold engine), (b) greedy tokens are bit-identical to a cold-cache
    run, (c) after the drain + ``drop_all`` not a single page or slot is
    leaked.
    """
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving import (ChunkConfig, Engine, PrefixConfig,
                                     Request)

    t0 = time.time()
    cfg = registry.reduced(arch, n_layers=2)
    rec: Dict = {"cell": "serve_prefix_smoke", "arch": arch,
                 "device": str(device)}
    try:
        params = T.init(cfg, device=device)
        rng = np.random.default_rng(0)
        shared = rng.integers(0, cfg.vocab, 32).astype(np.int32)
        prompts = [np.concatenate([shared, rng.integers(
            0, cfg.vocab, 3 + i).astype(np.int32)]) for i in range(8)]

        def serve(prefix, reg):
            eng = Engine(cfg, params, batch_slots=2, max_len=64,
                         metrics=reg, prefix=prefix, device=device)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p.copy(), max_new=6))
            return eng, {r.uid: r.out_tokens for r in eng.run()}

        cold_reg = MetricsRegistry()
        _, want = serve(None, cold_reg)
        warm_reg = MetricsRegistry()
        eng, got = serve(PrefixConfig(chunk=ChunkConfig(chunk_tokens=16)),
                         warm_reg)

        hits = int(warm_reg.value_sum("prefix_hits_total"))
        rec.update({
            "requests_done": len(got),
            "hit_rate": round(hits / len(prompts), 3),
            "hit_tokens": int(warm_reg.value_sum("prefix_hit_tokens_total")),
            "cow_forks": int(warm_reg.value_sum("prefix_cow_forks_total")),
            "prefill_tokens_cold": int(cold_reg.value_sum(
                "engine_prefill_tokens_total")),
            "prefill_tokens_warm": int(warm_reg.value_sum(
                "engine_prefill_tokens_total")),
            "tokens_match_cold": bool(got == want),
        })
        cache_pages = eng.prefix.pages
        eng.prefix.drop_all()
        rec.update({
            "cache_pages_at_drain": cache_pages,
            "used_pages_after_drop": eng.sched.alloc.used_pages,
        })
        rec["ok"] = (got == want and len(got) == len(prompts)
                     and hits > 0
                     and rec["prefill_tokens_warm"]
                     < rec["prefill_tokens_cold"]
                     and eng.sched.alloc.used_pages == 0
                     and eng.sched.alloc.total_refs == 0)
    except Exception as e:
        _failed(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def serve_seeded_smoke(arch: str = "qwen3-4b", device="cuda") -> Dict:
    """``--serve-seeded``: zero-storage seeded-projection serving smoke.

    Builds the SRF variant of ``arch`` with ``srf.seeded=True`` (every
    projection regenerated in-kernel from one seed per head) and serves
    one base request plus two requests with DISTINCT per-request
    ``embed_seed``s through one paged engine. Checks (a) zero
    materialized projection bytes: the params hold one seed word per
    (layer, head, block), orders of magnitude under the materialized
    twin's float storage, (b) personalization: the seeded requests
    decode different streams than the base one from the SAME prompt, and
    differ from each other, (c) determinism: a rerun is bit-identical.
    The port's seed words are int64 (the reference's uint32).
    """
    from repro_torch.models.attention import srf_cfg
    from repro_torch.serving import Engine, Request

    t0 = time.time()
    cfg = registry.reduced(arch, n_layers=2, attn_impl="srf")
    cfg = dataclasses.replace(
        cfg, srf=dataclasses.replace(cfg.srf, seeded=True))
    rec: Dict = {"cell": "serve_seeded_smoke", "arch": arch,
                 "device": str(device)}
    try:
        params = T.init(cfg, device=device)
        seed_leaves = [t for p, t in tree_lib.leaves_with_path(params)
                       if p.endswith("/seed")]
        seed_bytes = sum(t.numel() * t.element_size() for t in seed_leaves)
        pipe = srf_cfg(cfg).pipeline
        twin = dataclasses.replace(pipe, blocks=tuple(
            dataclasses.replace(b, seeded=False) for b in pipe.blocks))
        head_pipes = sum(t.numel() for t in seed_leaves) // len(pipe.blocks)
        mat_bytes = int(twin.storage) * 4 * head_pipes

        prompt = np.arange(9, dtype=np.int32)

        def serve():
            eng = Engine(cfg, params, batch_slots=4, max_len=64,
                         device=device)
            for uid, es in ((0, 0), (1, 1234), (2, 98765)):
                eng.submit(Request(uid=uid, prompt=prompt.copy(), max_new=6,
                                   embed_seed=es))
            return {r.uid: list(r.out_tokens) for r in eng.run()}

        got, again = serve(), serve()
        rec.update({
            "requests_done": len(got),
            "projection_seed_bytes": seed_bytes,
            "materialized_equiv_bytes": mat_bytes,
            "projection_bytes_reduction_x":
                round(mat_bytes / max(seed_bytes, 1), 1),
            "personalized": bool(got[1] != got[0] and got[2] != got[0]
                                 and got[2] != got[1]),
            "deterministic": bool(got == again),
        })
        rec["ok"] = (len(got) == 3 and len(seed_leaves) > 0
                     and rec["personalized"] and rec["deterministic"]
                     and all(not t.is_floating_point() for t in seed_leaves)
                     and mat_bytes > 10 * seed_bytes)
    except Exception as e:
        _failed(rec, e)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


SMOKES = {"pipeline": pipeline_smoke, "serve_mesh": serve_mesh_smoke,
          "serve_chaos": serve_chaos_smoke,
          "serve_prefix": serve_prefix_smoke,
          "serve_seeded": serve_seeded_smoke}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=registry.ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(shp.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--attn", default=None, choices=[None, "full", "srf"])
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "dots", "full"])
    ap.add_argument("--srf-kind", default=None)
    ap.add_argument("--srf-features", type=int, default=None)
    ap.add_argument("--out", default=None, help="append-jsonl results path")
    ap.add_argument("--pipeline", action="store_true",
                    help="spinner-pipeline serialization round-trip smoke "
                         "(no mesh/arch needed)")
    ap.add_argument("--serve-mesh", action="store_true",
                    help="mesh-serving smoke: router + sharded pools on a "
                         "mesh of --device repeated, 4 mixed-length "
                         "requests e2e")
    ap.add_argument("--serve-chaos", action="store_true",
                    help="fault-tolerance smoke: FT router + chaos-killed "
                         "replica mid-decode, rescue must be bit-identical")
    ap.add_argument("--serve-prefix", action="store_true",
                    help="prefix-sharing smoke: 8 shared-prefix requests, "
                         "hit-rate > 0, bit-match vs cold cache, zero "
                         "leaked pages")
    ap.add_argument("--serve-seeded", action="store_true",
                    help="seeded-projection smoke: requests with distinct "
                         "embed_seeds personalize deterministically with "
                         "zero materialized projection bytes")
    ap.add_argument("--device", default=None,
                    help="the cells' device (default meta) or the smokes' "
                         "(default cuda)")
    args = ap.parse_args(argv)

    rep = Reporter()
    smoke = [k for k in SMOKES if getattr(args, k)]
    if smoke:
        device = args.device or "cuda"
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu")
        fn = SMOKES[smoke[0]]
        rec = fn(device=device) if smoke[0] == "pipeline" \
            else fn(args.arch or "qwen3-4b", device=device)
        line = json.dumps(rec, default=float)
        rep.line(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return 0 if rec["ok"] else 1

    overrides = {}
    if args.attn:
        overrides["attn_impl"] = args.attn
    if args.remat:
        overrides["remat"] = args.remat
    if args.srf_kind or args.srf_features:
        base = registry.get(args.arch or registry.ARCHS[0]).srf
        overrides["srf"] = dataclasses.replace(
            base, **({"kind": args.srf_kind} if args.srf_kind else {}),
            **({"n_features": args.srf_features} if args.srf_features else {}))

    cells = []
    archs = [args.arch] if args.arch else registry.ARCHS
    shapes_ = [args.shape] if args.shape else list(shp.SHAPES)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch/--shape or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes_:
            for mp in meshes:
                cells.append((a, s, mp))

    ok = True
    for a, s, mp in cells:
        rec = run_cell(a, s, multi_pod=mp, use_reduced=args.reduced,
                       overrides=overrides, device=args.device or "meta")
        ok = ok and rec["ok"]
        line = json.dumps(rec, default=float)
        rep.line(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
