"""Measured serving characterization launcher: scenario x batch x plan sweep.

    PYTHONPATH=src python -m repro_torch.launch.characterize \\
        --arch llama-3.2-1b --scenario code-completion --batches 1,4,16 \\
        --plan jit --requests 64 --prompt-cap 64
    PYTHONPATH=src python -m repro_torch.launch.characterize --reduced \\
        --device cpu --scenario chatbot --batches 1,2 --plan eager

Counterpart of ``repro.launch.characterize``.  Drives the port's live
``ServeEngine`` with a named traffic scenario (see
``repro_torch.workload.list_scenarios``), records host telemetry, prints
per-batch measured launch tax + TTFT/ITL percentiles with a
CPU/GPU-bound classification, and writes to ``--out-dir``:

  workload_<scenario>.jsonl     replayable traffic trace (--replay loads one)
  trace_<scenario>_b<N>.json    merged host+modeled-device Chrome trace
                                (open in Perfetto / chrome://tracing)
  characterize.json             summary of the whole sweep

``--memory-sweep`` runs the paged-KV memory-pressure sweep instead: the
same seeded traffic is served with the block pool driven past capacity on
each ``--sweep-platforms`` device model (LC/PCIe vs CC/NVLink-C2C),
printing measured offload traffic, the link-priced offload tax and (on
the GPU) the offload tier's measured copy time, and writing
``memory_sweep.json``.  ``--spec-sweep`` runs the speculative-decoding
depth sweep: the live engine serves the same seeded traffic at each
``--spec-ks`` depth (0 = plain decode) and ``--batches`` size, measuring
acceptance and steps per emitted token, then the port's decode stream is
priced per ``--sweep-platforms`` row with the draft's serialized dispatch
stream and the (k+1)x verify work (``--model-batches`` adds batch sizes
priced, not served), printing each cell and writing ``spec_sweep.json``.
``--tp-sweep`` models the tensor-parallel launch story: the port's decode
stream is traced once per ``--batches`` size and priced per
(``--sweep-platforms`` row, ``--tps`` degree) with one launch per device
stream (launch tax x tp), 1/tp of the device work and per-layer
all-reduce payloads over each platform's coupling link, printing how the
modeled CPU->GPU-bound inflection batch moves with tp and writing
``tp_sweep.json``; nothing executes sharded, so it needs one device.

Weights are random, drawn on the device from a generator seeded 0.  Runs
on the GPU by default and raises without one; ``--device cpu`` runs the
plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.core.export import save_merged_trace
from repro_torch.device import resolve_device
from repro_torch.inference.backends import PLANS
from repro_torch.launch.steps import params_sds
from repro_torch.models import init_params
from repro_torch.telemetry.characterize import (characterize,
                                                memory_pressure_sweep,
                                                spec_sweep, tp_sweep)
from repro_torch.workload import list_scenarios, load_workload, save_workload


def write_artifacts(result, out_dir: str) -> dict:
    """Write workload JSONL, per-batch Chrome traces, and the summary."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    wl = os.path.join(out_dir, f"workload_{result.scenario}.jsonl")
    paths["workload"] = save_workload(result.workload, wl)
    for p in result.points:
        tr = os.path.join(out_dir,
                          f"trace_{result.scenario}_b{p.batch}.json")
        paths[f"trace_b{p.batch}"] = save_merged_trace(
            p.spans, result.platform, tr,
            device_events=p.modeled_events,
            device_anchors=p.decode_anchors,
            metadata={"arch": result.arch, "scenario": result.scenario,
                      "plan": result.plan, "batch": p.batch})
    summary = os.path.join(out_dir, "characterize.json")
    with open(summary, "w") as f:
        json.dump(result.summary(), f, indent=2)
    paths["summary"] = summary
    return paths


def print_memory_sweep(sweep: dict) -> None:
    for r, copy_us in zip(sweep["points"], sweep["measured_offload_copy_us"]):
        measured = ("not measured (cpu)" if copy_us is None
                    else f"{copy_us:.1f}us")
        print(f"{r['platform']:<12s} {r['coupling']:<3s} "
              f"link={r['link_gbps']}GB/s {r['kv_dtype']:<4s} "
              f"pool={r['pool_frac']:<5} blocks={r['num_blocks']:<4d} "
              f"preempt={r['preemptions']:<3d} "
              f"offload={r['offload_bytes']}B "
              f"tax={r['modeled_offload_tax_us']}us "
              f"tax/tok={r['offload_tax_per_token_us']}us "
              f"copy={measured}")
    for d in sweep["kv_dtype_deltas"]:
        print(f"delta[{d['platform']} pool={d['pool_frac']}] "
              f"{d['baseline']}->{d['kv_dtype']}: "
              f"capacity x{d['capacity_ratio']} "
              f"preempt {d['preemptions'][d['baseline']]}->"
              f"{d['preemptions'][d['kv_dtype']]} "
              f"tax_delta={d['offload_tax_delta_us']}us")


def print_tp_sweep(sweep: dict) -> None:
    """One line a modeled (platform, tp, batch) cell, then the inflection
    batch per (platform, tp)."""
    for r in sweep["points"]:
        print(f"{r['platform']:<12s} {r['coupling']:<3s} "
              f"tp={r['tp']:<2d} batch={r['batch']:<3d} "
              f"tklqt={r['modeled_tklqt_us']}us "
              f"step={r['modeled_step_us']}us "
              f"launch={r['launch_tax_us']}us "
              f"coll={r['collective_bytes']}B "
              f"coll_tax={r['modeled_collective_tax_us']}us")
    for plat, by_tp in sweep["inflection_batch"].items():
        print(f"inflection[{plat}]: " + ", ".join(
            f"tp={t} -> {b}" for t, b in by_tp.items()))


def print_spec_sweep(sweep: dict) -> None:
    """One line a measured (k, batch) cell and a modeled (platform, k,
    batch) cell, then the batches where speculation wins."""
    for r in sweep["measured"]:
        print(f"measured k={r['k']:<2d} batch={r['batch']:<3d} "
              f"accept={r['accept_rate']:<5} "
              f"steps/tok={r['steps_per_emitted_token']:<5} "
              f"rounds={r['spec_rounds']:<4d} "
              f"draft_disp={r['draft_dispatches']}")
    for r in sweep["modeled"]:
        print(f"{r['platform']:<12s} {r['coupling']:<3s} "
              f"k={r['k']:<2d} batch={r['batch']:<5d} "
              f"base/tok={r['modeled_baseline_per_token_us']}us "
              f"spec/tok={r['modeled_spec_per_token_us']}us "
              f"draft_tax={r['modeled_draft_launch_tax_per_round_us']}"
              f"us win={r['win']}")
    for plat, by_k in sweep["win_batches"].items():
        print(f"win_batches[{plat}]: " + ", ".join(
            f"k={k} -> {bs}" for k, bs in by_k.items()))


def print_points(result) -> None:
    for p in result.points:
        cls = result.boundedness.classify(p.batch)
        r = p.row()
        print(f"batch={p.batch:<3d} {cls:<9s} "
              f"launch_tax/step={r['decode_launch_tax_us']}us "
              f"step={r['mean_decode_step_us']}us "
              f"disp/step={r['dispatches_per_decode_step']} "
              f"ttft_p50={r['ttft_p50_ms']}ms "
              f"ttft_p99={r['ttft_p99_ms']}ms "
              f"itl_p50={r['itl_p50_ms']}ms "
              f"itl_p99={r['itl_p99_ms']}ms "
              f"tok/s={r['tokens_per_s']} "
              f"occupancy={r['mean_occupancy']}")
    infl = result.boundedness.inflection_batch
    what = ("always CPU/dispatch-bound in range" if infl is None
            else "GPU/compute-bound from here")
    print(f"inflection_batch={infl} ({what})")


def print_attribution(result) -> None:
    for p in result.points:
        rep = p.attribution
        if rep is None:
            print(f"attribution[batch={p.batch}]: unavailable "
                  "(no planned decode ran at this point)")
            continue
        print(f"attribution[batch={p.batch}] "
              f"events={rep.total_events} complete={rep.complete} "
              f"tklqt={rep.tklqt_s * 1e6:.1f}us")
        print(f"  {'operator':<12s} {'launches':>9s} {'launch_us':>10s} "
              f"{'queue_us':>9s} {'exec_us':>9s} {'tklqt%':>7s}")
        for row in rep.as_dicts():
            print(f"  {row['operator']:<12s} {row['launches']:>9.1f} "
                  f"{row['launch_us']:>10.2f} {row['queue_us']:>9.2f} "
                  f"{row['exec_us']:>9.2f} {row['tklqt_pct']:>7.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scenario", default="chatbot",
                    choices=list_scenarios())
    ap.add_argument("--batches", default="1,2,4",
                    help="comma-separated slot-pool sizes to sweep")
    ap.add_argument("--plan", default="auto", choices=PLANS)
    ap.add_argument("--platform", default="Intel+H100",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-cap", type=int, default=24,
                    help="clip scenario prompt lengths (0 = no cap)")
    ap.add_argument("--output-cap", type=int, default=8,
                    help="clip scenario output lengths (0 = no cap)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress the arrival timeline by this factor")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass (timings include traces "
                         "and graph captures)")
    ap.add_argument("--replay", default=None,
                    help="replay a recorded workload JSONL instead of "
                         "generating from the scenario")
    ap.add_argument("--out-dir", default="characterize-out")
    ap.add_argument("--memory-sweep", action="store_true",
                    help="run the paged-KV memory-pressure sweep (LC vs "
                         "CC offload tax) instead of the batch sweep")
    ap.add_argument("--sweep-platforms", default="Intel+H100,GH200",
                    help="comma-separated device models for "
                         "--memory-sweep / --spec-sweep / --tp-sweep")
    ap.add_argument("--pool-fracs", default="1.0,0.5,0.33",
                    help="pool sizes as fractions of the no-pressure pool")
    ap.add_argument("--block-size", type=int, default=4,
                    help="tokens per KV block for --memory-sweep")
    ap.add_argument("--kv-dtypes", default="bf16",
                    help="comma-separated paged-KV storage dtypes for "
                         "--memory-sweep (e.g. bf16,int8); each pool is "
                         "held at the first dtype's device byte budget, "
                         "so int8 cells fit proportionally more blocks")
    ap.add_argument("--sweep-max-batch", type=int, default=4)
    ap.add_argument("--tp-sweep", action="store_true",
                    help="model the tensor-parallel dispatch/collective "
                         "sweep (inflection batch vs tp on LC vs CC) "
                         "instead of the measured batch sweep")
    ap.add_argument("--tps", default="1,2,4,8",
                    help="comma-separated tensor-parallel degrees for "
                         "--tp-sweep")
    ap.add_argument("--spec-sweep", action="store_true",
                    help="run the speculative-decoding k x batch sweep "
                         "(measured acceptance + modeled LC-vs-CC draft "
                         "launch tax) instead of the measured batch sweep")
    ap.add_argument("--spec-ks", default="0,2,4,8",
                    help="comma-separated speculation depths for "
                         "--spec-sweep (0 = plain decode baseline)")
    ap.add_argument("--model-batches", default="",
                    help="extra batch sizes to price (not serve) in "
                         "--spec-sweep, e.g. 16,64,256")
    ap.add_argument("--attribution-report", action="store_true",
                    help="print the per-operator launch/queue/%%-of-TKLQT "
                         "table for each batch point (needs a launch-plan "
                         "mode, not --plan jit)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.attribution_report and args.plan == "jit":
        ap.error("--attribution-report needs a launch-plan mode (--plan "
                 "eager/chain/auto/whole_graph/fused): plan=jit has no "
                 "kernel-level provenance to attribute")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    if args.tp_sweep:
        # trace-only sweep: abstract weights (params_sds, on the meta
        # device), traced with fake tensors, so no kernel runs and a
        # full-size arch is priced without materializing its parameters;
        # every (platform, tp) cell is priced, not served
        sweep = tp_sweep(
            cfg, params_sds(cfg),
            batches=[int(b) for b in args.batches.split(",") if b],
            tps=[int(t) for t in args.tps.split(",") if t],
            platforms=[p for p in args.sweep_platforms.split(",") if p],
            max_len=args.max_len, device=dev)
        print_tp_sweep(sweep)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "tp_sweep.json")
        with open(path, "w") as f:
            json.dump(sweep, f, indent=2)
        print(json.dumps({"summary": sweep, "artifacts": {"sweep": path}}))
        return sweep
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if args.spec_sweep:
        batches = [int(b) for b in args.batches.split(",") if b]
        mb = [int(b) for b in args.model_batches.split(",") if b]
        sweep = spec_sweep(
            cfg, params,
            ks=[int(k) for k in args.spec_ks.split(",") if k],
            batches=batches,
            platforms=[p for p in args.sweep_platforms.split(",") if p],
            scenario=args.scenario, n_requests=args.requests,
            seed=args.seed, prompt_cap=args.prompt_cap or None,
            output_cap=args.output_cap or None, max_len=args.max_len,
            model_batches=sorted(set(batches) | set(mb)) if mb else None,
            device=dev)
        print_spec_sweep(sweep)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "spec_sweep.json")
        with open(path, "w") as f:
            json.dump(sweep, f, indent=2)
        print(json.dumps({"summary": sweep, "artifacts": {"sweep": path}}))
        return sweep
    if args.memory_sweep:
        sweep = memory_pressure_sweep(
            cfg, params, scenario=args.scenario,
            platforms=[p for p in args.sweep_platforms.split(",") if p],
            pool_fracs=[float(f) for f in args.pool_fracs.split(",") if f],
            kv_dtypes=[d for d in args.kv_dtypes.split(",") if d],
            max_batch=args.sweep_max_batch, max_len=args.max_len,
            block_size=args.block_size, n_requests=args.requests,
            seed=args.seed, prompt_cap=args.prompt_cap or None,
            output_cap=args.output_cap or None, device=dev)
        print_memory_sweep(sweep)
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "memory_sweep.json")
        with open(path, "w") as f:
            json.dump(sweep, f, indent=2)
        print(json.dumps({"summary": sweep, "artifacts": {"sweep": path}}))
        return sweep

    result = characterize(
        cfg, params, scenario=args.scenario,
        batches=[int(b) for b in args.batches.split(",") if b],
        plan=args.plan, platform=args.platform, n_requests=args.requests,
        seed=args.seed, prompt_cap=args.prompt_cap or None,
        output_cap=args.output_cap or None, time_scale=args.time_scale,
        max_len=args.max_len, warmup=not args.no_warmup,
        workload=load_workload(args.replay) if args.replay else None,
        device=dev)
    print_points(result)
    if args.attribution_report:
        print_attribution(result)
    paths = write_artifacts(result, args.out_dir)
    print(json.dumps({"summary": result.summary(), "artifacts": paths}))
    return result


if __name__ == "__main__":
    main()
