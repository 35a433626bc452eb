"""Serving launcher: the continuous-batching engine over synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --cache paged \\
        --kv-dtype int8 --num-blocks 12 --prefill-chunk 8 --offload host
    PYTHONPATH=src python -m repro_torch.launch.serve --speculative \\
        --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --metrics-out m.prom \\
        --trace-out t.json --slo-ttft-ms 200 --slo-itl-ms 50
    PYTHONPATH=src python -m repro_torch.launch.serve --plan fused \\
        --attribution
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-1b \\
        --tp 2

Counterpart of ``repro.launch.serve`` for the flags the port supports
(``--plan``, ``--cache paged`` with its block, dtype, sharing, offload and
chunking flags, ``--platform``, which prices the offload tier and the
launch plans, and ``--speculative`` with ``--spec-k``,
``--spec-inflection`` and ``--draft-layers``: draft-propose /
batched-verify decoding under ``--plan jit``, whose tokens are plain
greedy decoding's, and the observability flags: ``--metrics-out``
writes the engine's registry after the measured run, Prometheus text when
the path ends in ``.prom`` and a JSON snapshot otherwise; ``--trace-out``
writes one Perfetto track per request (its critical path) over the
engine's host lanes; ``--slo-ttft-ms`` / ``--slo-itl-ms`` set the SLO the
goodput accounting classifies each request against; ``--attribution``
adds the per-operator launch/queue/exec attribution of one decode step,
which needs a launch plan; ``--tp N`` serves through the tensor-parallel
backend, N rank processes with head-sharded weights and KV and an
all-reduce at every attention and MLP output, ``--plan jit`` only; with
fewer GPUs than ranks the ranks share a card, so its times are no
tensor-parallel speed).  ``--plan jit``, the default as in the reference, replays
each step as one CUDA graph (``inference.backends.local``); ``eager``,
``whole_graph``, ``chain``, ``auto`` and ``fused`` run it through the
launch-plan runtime (``eager`` op by op; the others one CUDA graph per
segment, ``fused`` with the norm windows on the hand-written kernels);
``--plan autotuned --plan-table plan_table.json`` serves the plan that
``repro_torch.launch.autotune`` measured best for ``--max-batch``.
``--arch`` takes every registered config (``repro_torch.configs``): the
dense decoders, Gemma-2's local/global stack, RWKV-6, the MoE decoders
Moonlight-16B-A3B (``moonshot-v1-16b-a3b``, 57.8 GB of bf16 weights) and
Kimi K2, the Jamba hybrid (contiguous cache only, as RWKV-6) and the
encoder-only BERT and XLM-R, which the engine serves greedily as the
reference's does, their prompts attending each other without the causal
mask.  At full depth Kimi K2 and Jamba hold more weights than one card.
Weights are random, drawn on the device from a generator seeded 0; prompts
are 12 tokens from numpy's generator seeded 0, as in the reference.  Runs
on the GPU by default and raises without one; ``--device cpu`` runs the
plain PyTorch path.  Prints one JSON line: the fields ``EngineStats``
fills (``dispatches_per_decode_step``, ``modeled_tklqt_us`` and
``fused_dispatches_per_decode_step`` among them), the device,
``kernel_launches_per_decode_step`` of the hand-written kernels, the CUDA
graphs captured (count, seconds, device memory) and the traces of the
planned bodies (count, nodes, seconds); under ``--cache
paged`` also the reference's paged fields and the measured device time of
the offload copies; the reference's speculative fields (``spec_rounds``,
``accept_rate``, ``steps_per_emitted_token``, ``draft_dispatches``, ...);
``boundedness``, the live monitor's verdict over the measured decode
steps (``telemetry.monitor``); and ``triage``, the critical-path
decomposition of every request's latency (``telemetry.critical_path``:
the segments sum to each request's end-to-end time) with the SLO verdicts
when an SLO is set.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.export import save_request_trace
from repro_torch.core.fusion import json_sanitize
from repro_torch.device import resolve_device
from repro_torch.inference.backends import PLANS
from repro_torch.inference.engine import (CACHE_MODES, OFFLOAD_MODES,
                                          Request, ServeEngine)
from repro_torch.inference.kv_quant import KV_DTYPES
from repro_torch.inference.speculative import (default_draft_config,
                                               validate_draft)
from repro_torch.models import init_params
from repro_torch.telemetry.critical_path import (SLO, analyze, record_goodput,
                                                 triage)
from repro_torch.telemetry.metrics import percentile
from repro_torch.telemetry.tracing import RequestTracer


def make_requests(n: int, vocab: int, max_new: int) -> list:
    rng = np.random.default_rng(0)
    return [Request(i, prompt=[int(t) for t in rng.integers(0, vocab, 12)],
                    max_new_tokens=max_new) for i in range(n)]


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def report(eng: ServeEngine, done: list, wall_s: float) -> dict:
    """The JSON report of one measured run."""
    st = eng.stats
    occ = st.slot_occupancy
    ttft = list(st.ttft_s.values())
    itl = st.itl_samples_s
    paged = eng.kv is not None
    tier = eng.offload_tier
    graphs = eng.backend.graph_stats
    traces = eng.backend.trace_stats
    return {
        "arch": eng.cfg.name,
        "device": device_name(eng.backend.device),
        "requests": sum(1 for r in done if r.status == "done"),
        "rejected": st.rejected,
        "plan": st.plan,
        "cache": eng.cache_mode,
        "slot_occupancy": {"mean": float(np.mean(occ)) if occ else 0.0,
                           "peak": int(max(occ)) if occ else 0},
        "block_pool_utilization": {
            "mean": st.mean_block_pool_utilization,
            "peak": st.peak_block_pool_utilization},
        "kv_dtype": eng.kv_dtype,
        "share_prefix": eng.share_prefix,
        "num_blocks": eng.kv.num_blocks if paged else 0,
        "prefix_adoptions": st.prefix_adoptions,
        "shared_prefix_tokens": st.shared_prefix_tokens,
        "kv_cow_copies": eng.kv.pool.cow_copies_total if paged else 0,
        "preemptions": st.preemptions,
        "prefill_chunks": st.prefill_chunks,
        "offload_bytes": st.offload_bytes,
        "restore_bytes": st.restore_bytes,
        "platform": eng.platform,
        "modeled_offload_tax_us": st.modeled_offload_tax_s * 1e6,
        "measured_offload_copy_us": (tier.measured_copy_s * 1e6
                                     if tier is not None
                                     and eng.backend.device.type == "cuda"
                                     else None),
        "tp": st.tp,
        "devices": list(eng.backend.info.devices),
        "per_device_dispatches": {str(d): n for d, n in
                                  sorted(st.per_device_dispatches.items())},
        "collectives": st.collectives,
        "collective_bytes": st.collective_bytes,
        "collective_bytes_per_decode_step":
            st.collective_bytes_per_decode_step,
        "modeled_collective_tax_us": st.modeled_collective_tax_s * 1e6,
        "tokens_out": st.tokens_out,
        "prefills": st.prefills,
        "decode_steps": st.decode_steps,
        "wall_s": wall_s,
        "tok_per_s": st.tokens_out / wall_s if wall_s > 0 else 0.0,
        "mean_ttft_ms": st.mean_ttft_s * 1e3,
        "p50_ttft_ms": percentile(ttft, 50) * 1e3 if ttft else 0.0,
        "mean_itl_ms": st.mean_itl_s * 1e3,
        "p50_itl_ms": percentile(itl, 50) * 1e3 if itl else 0.0,
        "p99_itl_ms": percentile(itl, 99) * 1e3 if itl else 0.0,
        "mean_decode_step_ms": (float(np.mean(st.step_times_s)) * 1e3
                                if st.step_times_s else 0.0),
        "measured_launch_tax_per_step_us": st.launch_tax_per_step_s * 1e6,
        "measured_launch_tax_per_decode_step_us":
            st.launch_tax_per_decode_step_s * 1e6,
        "decode_dispatches": st.decode_dispatches,
        "dispatches_per_decode_step": st.dispatches_per_decode_step,
        "fused_dispatches_per_decode_step":
            st.fused_dispatches_per_decode_step,
        "rule_hits": dict(st.rule_hits),
        "modeled_tklqt_us": st.modeled_tklqt_s * 1e6,
        "traces": traces.traces,
        "trace_kernels": traces.kernels,
        "trace_s": traces.seconds,
        "graphs_captured": graphs.captured,
        "graph_capture_s": graphs.capture_s,
        "graph_memory_bytes": graphs.memory_bytes,
        "kernel_launches_per_decode_step": st.kernel_launches_per_decode_step,
        "prefill_kernel_launches": st.prefill_kernel_launches,
        "speculative": eng.speculative,
        "spec_k": eng.spec_k if eng.speculative else 0,
        "draft": eng.draft_cfg.name if eng.speculative else None,
        "spec_rounds": st.spec_rounds,
        "proposed": st.proposed,
        "accepted": st.accepted,
        "corrections": st.corrections,
        "accept_rate": st.accept_rate,
        "steps_per_emitted_token": st.steps_per_emitted_token,
        "draft_dispatches": st.draft_dispatches,
        "modeled_draft_launch_tax_us": st.modeled_draft_launch_tax_s * 1e6,
        "boundedness": (eng.monitor.summary() if eng.monitor is not None
                        else None),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--plan", default="jit",
                    choices=PLANS + ("autotuned",),
                    help="jit: each step one CUDA graph replay (captured "
                         "once per signature); eager: op by op; "
                         "whole_graph, chain, auto, fused: a launch plan "
                         "over the step's trace, one CUDA graph a segment; "
                         "autotuned: the plan --plan-table picked for "
                         "--max-batch")
    ap.add_argument("--plan-table", default=None,
                    help="plan_table.json from repro_torch.launch.autotune "
                         "(required with --plan autotuned)")
    ap.add_argument("--platform", default="Intel+H100",
                    choices=sorted(PLATFORMS),
                    help="the paper's platform row whose host link prices "
                         "the offload tier and whose launch and device "
                         "rates price the plans (the H100's host link is "
                         "PCIe: an LC part)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: 1 = single-device "
                         "LocalBackend, N>1 = the sharded backend over N "
                         "rank processes (--plan jit only)")
    ap.add_argument("--cache", default="contiguous", choices=CACHE_MODES)
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged cache)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="block-pool size; default fits every slot at "
                         "--max-len (no memory pressure)")
    ap.add_argument("--kv-dtype", default="bf16", choices=KV_DTYPES,
                    help="paged KV storage dtype: int8 quantizes pages "
                         "per-(token, head) with f32 scales (entry cost "
                         "hd+4 bytes vs 2*hd) and dequantizes at load; "
                         "the default pool sizes up by the byte ratio")
    ap.add_argument("--share-prefix", action="store_true",
                    help="copy-on-write prefix sharing: requests whose "
                         "prompts share a token prefix map their leading "
                         "full blocks to the same pool pages (paged only)")
    ap.add_argument("--offload", default="none", choices=OFFLOAD_MODES,
                    help="host: evict cold blocks to pinned host memory "
                         "and restore on resume; none: preempt + recompute")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in chunks of this many tokens, "
                         "interleaved with decode steps")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass; measured fields then include "
                         "the kernels' first build and load")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-propose / batched-verify decoding "
                         "(greedy-lossless; needs --plan jit)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per round (>= 1)")
    ap.add_argument("--spec-inflection", type=int, default=None,
                    help="measured CPU->GPU-bound inflection batch for "
                         "the launch-tax-aware depth policy (from "
                         "launch.characterize); default: always deep")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="superblocks in the truncated-target draft "
                         "(default: half the target's)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine's MetricsRegistry here after "
                         "the measured run: Prometheus text exposition "
                         "when the path ends in .prom, else a JSON "
                         "snapshot")
    ap.add_argument("--trace-out", default=None,
                    help="write the per-request critical-path trace "
                         "(Perfetto/chrome JSON, one track per request)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO in ms for goodput accounting "
                         "(0 disables; unset = no TTFT bound)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="mean-ITL SLO in ms for goodput accounting "
                         "(0 disables; unset = no ITL bound)")
    ap.add_argument("--attribution", action="store_true",
                    help="include the per-operator launch/queue/exec "
                         "attribution of one decode step plus the live "
                         "boundedness verdict in the report (needs a "
                         "launch-plan mode, not --plan jit)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.attribution and args.plan == "jit":
        ap.error("--attribution needs a launch-plan mode (--plan eager/"
                 "chain/auto/whole_graph/fused): plan=jit dispatches one "
                 "whole-step executable with no kernel-level provenance "
                 "to attribute")
    if args.cache != "paged" and (args.kv_dtype != "bf16"
                                  or args.share_prefix):
        ap.error("--kv-dtype/--share-prefix need --cache paged (the "
                 "contiguous cache has no block pool to quantize or share)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    draft_cfg = None
    if args.speculative:
        # actionable CLI validation before any params materialize
        if args.plan != "jit":
            ap.error(f"--speculative needs --plan jit, got {args.plan} "
                     "(the launch-plan runtime replays fixed single-token "
                     "streams; model the draft/verify trade with "
                     "launch.characterize --spec-sweep instead)")
        if args.spec_k < 1:
            ap.error(f"--spec-k must be >= 1, got {args.spec_k} "
                     "(drop --speculative to serve without a draft)")
        if args.draft_layers is not None:
            if not 1 <= args.draft_layers <= cfg.n_superblocks:
                ap.error(f"--draft-layers must be in [1, "
                         f"{cfg.n_superblocks}] for {cfg.name} "
                         f"({cfg.n_superblocks} superblocks), got "
                         f"{args.draft_layers}")
            draft_cfg = cfg.replace(
                name=f"{cfg.name}-draft{args.draft_layers}sb",
                n_layers=args.draft_layers * len(cfg.block_pattern))
        else:
            draft_cfg = default_draft_config(cfg)
        try:
            validate_draft(cfg, draft_cfg, args.spec_k)
        except ValueError as e:
            ap.error(str(e))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    tracer = RequestTracer()
    eng = ServeEngine(cfg, params, max_batch=args.max_batch, tracer=tracer,
                      max_len=args.max_len, plan=args.plan, device=dev,
                      platform=args.platform, plan_table=args.plan_table,
                      tp=args.tp, cache=args.cache,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      offload=args.offload, prefill_chunk=args.prefill_chunk,
                      kv_dtype=args.kv_dtype,
                      share_prefix=args.share_prefix,
                      speculative=args.speculative, draft_config=draft_cfg,
                      spec_k=args.spec_k,
                      spec_inflection=args.spec_inflection)
    try:
        if not args.no_warmup:
            eng.run(make_requests(args.requests, cfg.vocab_size,
                                  args.max_new))
            eng.reset()
            # reset() keeps the tracer; drop the warmup's lifecycles so
            # the triage covers the measured run only
            tracer.clear()
        reqs = make_requests(args.requests, cfg.vocab_size, args.max_new)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        wall = time.perf_counter() - t0
    finally:
        # a tensor-parallel engine's ranks serve nothing more
        eng.close()
    out = report(eng, done, wall)
    if args.attribution:
        pd = eng._planned_decode
        rep = pd.attribution if pd is not None else None
        out["attribution"] = None if rep is None else {
            "complete": rep.complete,
            "total_events": rep.total_events,
            "accounted_launches": float(rep.accounted_launches),
            "tklqt_us": round(rep.tklqt_s * 1e6, 3),
            "rows": rep.as_dicts(),
        }
    # critical-path decomposition + goodput BEFORE the registry export,
    # so --metrics-out snapshots carry the goodput families
    slo = SLO.resolve(None, args.slo_ttft_ms, args.slo_itl_ms)
    analysis = analyze(tracer)
    tri = triage(analysis, slo)
    if "slo_report" in tri:
        record_goodput(eng.registry, tri["slo_report"])
    out["triage"] = tri
    if args.trace_out:
        save_request_trace(
            analysis, args.trace_out, platform=args.platform,
            host_spans=(eng.telemetry.spans
                        if eng.telemetry is not None else ()))
        out["trace_out"] = args.trace_out
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            if args.metrics_out.endswith(".prom"):
                fh.write(eng.registry.to_prometheus())
            else:
                json.dump(json_sanitize(eng.registry.snapshot()), fh,
                          indent=2, allow_nan=False)
        out["metrics_out"] = args.metrics_out
    # strict JSON even when a measured field degenerates to inf/nan
    print(json.dumps(json_sanitize(out), allow_nan=False))
    return eng, done


if __name__ == "__main__":
    main()
