"""Serving launcher: the continuous-batching engine over synthetic requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --cache paged \\
        --kv-dtype int8 --num-blocks 12 --prefill-chunk 8 --offload host

Counterpart of ``repro.launch.serve`` for the flags the port supports
(``--plan``, ``--cache paged`` with its block, dtype, sharing, offload and
chunking flags, and ``--platform``, which prices the offload tier and the
launch plans).  ``--plan jit``, the default as in the reference, replays
each step as one CUDA graph (``inference.backends.local``); ``eager``,
``whole_graph``, ``chain``, ``auto`` and ``fused`` run it through the
launch-plan runtime (``eager`` op by op; the others one CUDA graph per
segment, ``fused`` with the norm windows on the hand-written kernels);
``autotuned`` raises (ROADMAP Queue A, "measured characterization and
autotune").
``--arch`` takes every registered config (``repro_torch.configs``): the
dense decoders, Gemma-2's local/global stack, RWKV-6 and the encoder-only
BERT and XLM-R, which the engine serves greedily as the reference's does,
their prompts attending each other without the causal mask.
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
the offload copies.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device_model import PLATFORMS
from repro_torch.device import resolve_device
from repro_torch.inference.backends import PLANS
from repro_torch.inference.engine import (CACHE_MODES, OFFLOAD_MODES,
                                          Request, ServeEngine)
from repro_torch.inference.kv_quant import KV_DTYPES
from repro_torch.models import init_params
from repro_torch.telemetry.metrics import percentile


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
                         "over the step's trace, one CUDA graph a segment")
    ap.add_argument("--platform", default="Intel+H100",
                    choices=sorted(PLATFORMS),
                    help="the paper's platform row whose host link prices "
                         "the offload tier and whose launch and device "
                         "rates price the plans (the H100's host link is "
                         "PCIe: an LC part)")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.cache != "paged" and (args.kv_dtype != "bf16"
                                  or args.share_prefix):
        ap.error("--kv-dtype/--share-prefix need --cache paged (the "
                 "contiguous cache has no block pool to quantize or share)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len, plan=args.plan, device=dev,
                      platform=args.platform, cache=args.cache,
                      block_size=args.block_size, num_blocks=args.num_blocks,
                      offload=args.offload, prefill_chunk=args.prefill_chunk,
                      kv_dtype=args.kv_dtype,
                      share_prefix=args.share_prefix)
    if not args.no_warmup:
        eng.run(make_requests(args.requests, cfg.vocab_size, args.max_new))
        eng.reset()
    reqs = make_requests(args.requests, cfg.vocab_size, args.max_new)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0
    print(json.dumps(report(eng, done, wall)))
    return eng, done


if __name__ == "__main__":
    main()
