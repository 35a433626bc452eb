"""Replica-fleet serving launcher: workload traffic through one router.

    PYTHONPATH=src python -m repro_torch.launch.route --arch smollm-360m \\
        --replicas 2 --scenario chatbot --requests 16
    PYTHONPATH=src python -m repro_torch.launch.route --reduced \\
        --device cpu --replicas 2 --cache paged --share-prefix \\
        --policy prefix-affinity --shared-prefix-tokens 16 \\
        --remove-at 4 --add-at 8

Counterpart of ``repro.launch.route``.  Builds a ``ReplicaFleet`` of
``--replicas`` full serving engines (each takes the same ``--plan`` /
``--cache`` / ``--tp`` options as ``repro_torch.launch.serve``), generates
open-loop traffic from a named workload scenario, and drains it through
the ``RequestRouter`` with a pluggable ``--policy``.  ``--stream`` prints
one JSON line per emitted token as replicas produce them; the final line
is the fleet report (per-replica stats, routing counters, TTFT
percentiles, throughput, and the critical-path ``triage``).

Elasticity under load: ``--remove-at K`` drains replica 0 after the Kth
routing decision (its queued requests re-enter the router queue; its
admitted ones finish in place), ``--add-at M`` attaches a fresh replica
after the Mth — the same ``launch.elastic.plan_fleet`` arithmetic a
device-pool change would trigger.  ``--metrics-out`` writes the fleet
snapshot: aggregated ``fleet_*``/``router_*`` families with per-replica
labels plus each replica's full registry dump.  ``--trace-out`` writes
one Perfetto track per request.

Every replica holds its own CUDA graphs (they are keyed on its cache's
addresses), so a throwaway warm-up engine would warm nothing a replica
replays: unless ``--no-warmup``, each replica serves the whole workload
once and is ``reset()``, which keeps its graphs.  A replica attached by
``--add-at`` captures at its first steps, on its own clock; the report's
``per_replica`` gives each replica's warm-up and in-drain capture
seconds.

All replicas share one device (``--device``, the GPU by default; ``cpu``
runs the plain PyTorch path) and the same weight tensors.  The router
ticks one replica at a time, and each replica's clock advances by the
measured wall time of its own calls, so the per-replica clocks simulate R
devices: ``fleet_tok_per_s`` (tokens over the makespan of those clocks)
is the simulated fleet's rate, and ``wall_tok_per_s`` (over the wall
time of the drain) counts the replicas' serialization on the one device.
Neither is a measured multi-GPU throughput.  Weights are random, drawn
on the device from a generator seeded 0.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.export import save_request_trace
from repro_torch.core.fusion import json_sanitize
from repro_torch.device import resolve_device
from repro_torch.inference.backends import PLANS
from repro_torch.inference.engine import CACHE_MODES, Request
from repro_torch.inference.fleet import ReplicaFleet
from repro_torch.inference.kv_quant import KV_DTYPES
from repro_torch.inference.router import POLICIES, RequestRouter
from repro_torch.models import init_params
from repro_torch.telemetry.critical_path import (SLO, analyze, record_goodput,
                                                 triage)
from repro_torch.telemetry.metrics import percentile
from repro_torch.telemetry.tracing import RequestTracer
from repro_torch.workload import get_scenario, list_scenarios, sample_requests


def build_requests(wl) -> list:
    """Workload records -> engine Requests (arrival times preserved)."""
    return [Request(w.rid, prompt=list(w.prompt),
                    max_new_tokens=w.max_new_tokens, arrival_s=w.arrival_s)
            for w in wl.requests]


def _captures(rep) -> tuple:
    """(graphs captured, capture seconds) of a replica's backend so far."""
    g = rep.engine.backend.graph_stats
    return g.captured, g.capture_s


def fleet_report(router, report, fleet, wall_s: float,
                 warm: dict | None = None) -> dict:
    """Assemble the CLI's JSON report from one routed drain.  ``warm``
    maps a replica rid to its (graphs, seconds) captured in warm-up;
    replicas absent from it were not warmed."""
    warm = warm or {}
    per_replica = {}
    ttft_all = []
    tokens = 0
    adoptions = shared_tokens = peak_shared = 0
    for rep in fleet.live():
        st = rep.engine.stats
        ttft = sorted(st.ttft_s.values())
        ttft_all.extend(ttft)
        tokens += st.tokens_out
        kv = rep.engine.kv
        rep_peak = kv.pool.peak_shared_blocks if kv is not None else 0
        adoptions += st.prefix_adoptions
        shared_tokens += st.shared_prefix_tokens
        peak_shared += rep_peak
        n_cap, cap_s = _captures(rep)
        w_n, w_s = warm.get(rep.rid, (0, 0.0))
        per_replica[str(rep.rid)] = {
            "state": rep.state,
            "dispatched": rep.dispatched,
            "tokens_out": st.tokens_out,
            "decode_steps": st.decode_steps,
            "decode_dispatches": st.decode_dispatches,
            "preemptions": st.preemptions,
            "prefix_adoptions": st.prefix_adoptions,
            "shared_prefix_tokens": st.shared_prefix_tokens,
            "kv_shared_blocks_peak": rep_peak,
            "mean_ttft_ms": round(st.mean_ttft_s * 1e3, 3),
            "clock_s": round(rep.engine.now, 6),
            "warmed": rep.rid in warm,
            "warmup_graphs": w_n,
            "warmup_capture_s": w_s,
            "drain_graphs": n_cap - w_n,
            "drain_capture_s": cap_s - w_s,
        }
    return {
        "replicas": len(fleet.replicas),
        "policy": report.policy,
        "requests_done": len(report.completed),
        "dispatches": report.dispatches,
        "requeued": report.requeued,
        "token_events": report.token_events,
        "fleet_tokens_out": tokens,
        "prefix_adoptions": adoptions,
        "shared_prefix_tokens": shared_tokens,
        "kv_shared_blocks_peak": peak_shared,
        "makespan_s": round(report.clock_s, 6),
        "fleet_tok_per_s": round(tokens / report.clock_s, 1)
        if report.clock_s else 0.0,
        "wall_s": wall_s,
        "wall_tok_per_s": round(tokens / wall_s, 1) if wall_s else 0.0,
        "ttft_ms": {
            "p50": round(percentile(ttft_all, 50.0) * 1e3, 3),
            "p99": round(percentile(ttft_all, 99.0) * 1e3, 3),
        } if ttft_all else {},
        "assignment": {str(k): v for k, v in
                       sorted(report.assignment.items())},
        "per_replica": per_replica,
    }


def main(argv=None):
    """Entry point for ``python -m repro_torch.launch.route``; returns the
    fleet, the router's report and the printed JSON report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="least-queue-depth",
                    choices=POLICIES)
    ap.add_argument("--scenario", default="chatbot",
                    choices=list_scenarios())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-scale", type=float, default=100.0,
                    help="compress the scenario's arrival timeline so "
                         "short runs see queueing, not idle gaps")
    ap.add_argument("--prompt-cap", type=int, default=24)
    ap.add_argument("--output-cap", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--plan", default="jit", choices=PLANS)
    ap.add_argument("--platform", default="Intel+H100",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree per replica; the fleet "
                         "is the (data=replicas, model=tp) grid, each "
                         "replica's ranks processes of their own")
    ap.add_argument("--cache", default="contiguous", choices=CACHE_MODES)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--kv-dtype", default="bf16", choices=KV_DTYPES,
                    help="paged KV storage dtype per replica (int8: "
                         "quantized pages, dequantized at load)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="copy-on-write prefix sharing inside each "
                         "replica's block pool (paged cache only)")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="prepend the same sampled system prompt of this "
                         "many tokens to every request (pairs with "
                         "--policy prefix-affinity and --share-prefix)")
    ap.add_argument("--validate-mesh", action="store_true",
                    help="require replicas x tp GPUs (default: the "
                         "replicas time-multiplex --device)")
    ap.add_argument("--remove-at", type=int, default=None,
                    help="drain replica 0 after this many dispatches")
    ap.add_argument("--add-at", type=int, default=None,
                    help="attach a fresh replica after this many "
                         "dispatches")
    ap.add_argument("--stream", action="store_true",
                    help="print one JSON line per emitted token")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip each replica's warm-up drain (measured TTFT "
                         "then includes the kernels' first build and the "
                         "graph captures)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the fleet metrics snapshot (aggregated "
                         "families + per-replica registries) as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write the per-request critical-path trace "
                         "(Perfetto/chrome JSON, one track per request)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO in ms for goodput accounting "
                         "(default: the scenario's registered SLO; "
                         "0 disables)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="mean-ITL SLO in ms for goodput accounting "
                         "(default: the scenario's registered SLO; "
                         "0 disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.remove_at is not None and args.replicas < 2:
        ap.error("--remove-at needs --replicas >= 2 (the last serving "
                 "replica cannot drain)")
    if args.cache != "paged" and (args.kv_dtype != "bf16"
                                  or args.share_prefix):
        ap.error("--kv-dtype/--share-prefix need --cache paged (the "
                 "contiguous cache has no block pool to quantize or share)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    engine_kwargs = dict(max_batch=args.max_batch, max_len=args.max_len,
                         plan=args.plan, platform=args.platform,
                         cache=args.cache, block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         kv_dtype=args.kv_dtype,
                         share_prefix=args.share_prefix)

    wl = sample_requests(args.scenario, args.requests, seed=args.seed,
                         vocab_size=cfg.vocab_size,
                         prompt_cap=args.prompt_cap,
                         output_cap=args.output_cap,
                         time_scale=args.time_scale,
                         shared_prefix=args.shared_prefix_tokens)

    # one tracer shared by the router and every replica engine: lifecycle
    # events land on one timeline per request regardless of which replica
    # served (or re-served) it
    tracer = RequestTracer()
    fleet = ReplicaFleet(cfg, params, replicas=args.replicas, tp=args.tp,
                         validate_mesh=args.validate_mesh, device=dev,
                         tracer=tracer, **engine_kwargs)
    try:
        warm = {}
        if not args.no_warmup:
            # each replica captures its own graphs on the whole workload;
            # reset() keeps them, so the measured drain replays
            for rep in fleet.live():
                rep.engine.run(build_requests(wl))
                rep.engine.reset()
                warm[rep.rid] = _captures(rep)
            tracer.clear()

        def emit(ev):
            print(json.dumps({"stream": {"rid": ev.rid, "replica": ev.replica,
                                         "index": ev.index, "token": ev.token,
                                         "t": round(ev.t, 6)}}))

        router = RequestRouter(fleet, policy=args.policy,
                               on_token=emit if args.stream else None,
                               tracer=tracer)
        actions = []
        if args.remove_at is not None:
            actions.append((args.remove_at,
                            lambda rt: rt.remove_replica(0)))
        if args.add_at is not None:
            actions.append((args.add_at, lambda rt: rt.add_replica()))

        t0 = time.perf_counter()
        report = router.route(build_requests(wl), actions=actions)
        wall = time.perf_counter() - t0
    finally:
        # tensor-parallel replicas' ranks serve nothing more
        fleet.close()

    out = {"arch": cfg.name, "scenario": args.scenario, "tp": args.tp,
           "device": str(dev), "plan": args.plan, "cache": args.cache}
    out.update(fleet_report(router, report, fleet, wall, warm))

    # critical-path decomposition + SLO/goodput accounting.  Goodput
    # families land in the fleet registry BEFORE the snapshot writes, so
    # --metrics-out carries them alongside the router/queue-wait series.
    slo = SLO.resolve(get_scenario(args.scenario),
                      args.slo_ttft_ms, args.slo_itl_ms)
    analysis = analyze(tracer)
    tri = triage(analysis, slo)
    if "slo_report" in tri:
        record_goodput(fleet.registry, tri["slo_report"])
    out["triage"] = tri
    if args.trace_out:
        save_request_trace(analysis, args.trace_out,
                           platform=args.platform,
                           metadata={"scenario": args.scenario,
                                     "policy": args.policy})
        out["trace_out"] = args.trace_out
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(json_sanitize(fleet.snapshot()), fh, indent=2,
                      allow_nan=False)
        out["metrics_out"] = args.metrics_out
    print(json.dumps(json_sanitize(out), allow_nan=False))
    return fleet, report, out


if __name__ == "__main__":
    main()
