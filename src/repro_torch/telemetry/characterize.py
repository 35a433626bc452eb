"""Measured SKIP characterization of the serving engine under a scenario.

Copy of ``repro/telemetry/characterize.py``: the same row keys, the same
classification rule and the same memory-pressure sweep, over the port's
``ServeEngine`` on ``device`` (``"cuda"`` by default; tests pass
``"cpu"``).  Instead of simulating a kernel stream against
``core.device_model``, it drives the live engine with a named traffic
scenario, records host-side telemetry (per-step dispatch spans,
per-request TTFT/ITL/E2E), sweeps the slot-pool size, and classifies the
CPU/GPU-bound inflection from the MEASURED per-step latency curve via
``core.boundedness``: flat step time in batch = dispatch-bound (more
slots are free), growing step time = compute-bound (the paper's
transition, observed rather than modeled).

Each run per batch point is warmup-then-measure: the warmup pass pays
tracing, planning and CUDA graph capture once, and ``ServeEngine.reset``
keeps them, so the measured timings are steady-state serving.  The launch
tax of a decode step is the host time of its backend call without a
device sync (``CallAccount.host_time_s``: under ``plan="jit"`` one graph
replay), so ``classify_measured_sweep``'s queue share is the part of the
step the host did not spend dispatching.

``spec_sweep`` sweeps speculation depth x batch: acceptance and steps per
emitted token measured on the live engine, the launch trade modeled over
the port's own traced decode stream (aten ops and hand-written kernels,
so its kernel counts and times are the port's, not the reference's).
``tp_sweep`` models tensor parallelism the same way: the port's decode
stream is traced once per batch and priced per (platform, tp) with one
launch per device stream, 1/tp of the device work and the per-layer
all-reduce payloads on the coupling link.  Nothing executes sharded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from repro_torch.core.boundedness import BoundednessResult, classify_sweep
from repro_torch.core.device_model import (PLATFORMS, allreduce_cost_s,
                                           dispatch_fanout_s)
from repro_torch.core.metrics import report
from repro_torch.core.tracing import trace_fn
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.inference.engine import Request, ServeEngine
from repro_torch.inference.speculative import (default_draft_config,
                                               draft_params_from_target)
from repro_torch.models import make_cache
from repro_torch.runtime.plan import LaunchPlan
from repro_torch.runtime.planner import simulate_plan
from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.telemetry.metrics import LatencySummary, summarize
from repro_torch.telemetry.spans import SpanRecorder
from repro_torch.workload.generator import Workload, sample_requests

MAX_DEVICE_ANCHORS = 64     # cap modeled-lane replication in exported traces


@dataclass
class _MeasuredReport:
    """Measured stand-in for SkipReport in classify_sweep: tklqt is the
    measured mean decode-step latency, queue_share the non-dispatch part."""
    tklqt: float
    queue_share: float


def classify_measured_sweep(batches: Sequence[int],
                            step_times_s: Sequence[float],
                            launch_tax_s: Optional[Sequence[float]] = None
                            ) -> BoundednessResult:
    """Boundedness from a measured batch sweep, via classify_sweep."""
    if launch_tax_s is None:
        launch_tax_s = [0.0] * len(step_times_s)
    reports = [
        _MeasuredReport(t, max(0.0, 1.0 - (tax / t)) if t > 0 else 0.0)
        for t, tax in zip(step_times_s, launch_tax_s)
    ]
    return classify_sweep(batches, reports)


@dataclass
class MeasuredPoint:
    """One batch point of a measured serving sweep."""
    batch: int
    latency: LatencySummary
    mean_decode_step_s: float
    launch_tax_per_step_s: float          # prefill+decode, per engine step
    decode_launch_tax_s: float            # decode only, per decode step
    dispatches_per_decode_step: float
    modeled_tklqt_s: float
    tokens_per_s: float
    mean_occupancy: float
    tokens_out: int
    decode_steps: int
    fused_dispatches_per_decode_step: float = 0.0  # rule-backed fused kernels
    rule_hits: dict = field(default_factory=dict)  # fusion-rule launch counts
    # paged KV cache counters (zero under cache="contiguous")
    preemptions: int = 0
    offload_bytes: int = 0
    restore_bytes: int = 0
    modeled_offload_tax_s: float = 0.0
    mean_pool_utilization: float = 0.0
    peak_pool_utilization: float = 0.0
    spans: list = field(default_factory=list)           # telemetry Spans
    modeled_events: list = field(default_factory=list)  # one decode step
    decode_anchors: list = field(default_factory=list)  # decode span starts
    attribution: object = None     # AttributionReport of one decode step

    def row(self) -> dict:
        out = {
            "batch": self.batch,
            "mean_decode_step_us": round(self.mean_decode_step_s * 1e6, 1),
            "launch_tax_per_step_us":
                round(self.launch_tax_per_step_s * 1e6, 1),
            "decode_launch_tax_us": round(self.decode_launch_tax_s * 1e6, 1),
            "dispatches_per_decode_step":
                round(self.dispatches_per_decode_step, 2),
            "fused_dispatches_per_decode_step":
                round(self.fused_dispatches_per_decode_step, 2),
            "rule_hits": dict(self.rule_hits),
            "modeled_tklqt_us": round(self.modeled_tklqt_s * 1e6, 1),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "mean_occupancy": round(self.mean_occupancy, 2),
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "offload_bytes": self.offload_bytes,
            "restore_bytes": self.restore_bytes,
            "modeled_offload_tax_us":
                round(self.modeled_offload_tax_s * 1e6, 1),
            "mean_pool_utilization": round(self.mean_pool_utilization, 3),
            "peak_pool_utilization": round(self.peak_pool_utilization, 3),
        }
        if self.attribution is not None:
            out["attribution"] = self.attribution.as_dicts()
        out.update(self.latency.row())
        return out


@dataclass
class CharacterizationResult:
    arch: str
    scenario: str
    plan: str
    platform: str
    workload: Workload
    points: list                     # list[MeasuredPoint], one per batch
    boundedness: BoundednessResult

    def summary(self) -> dict:
        return {
            "arch": self.arch, "scenario": self.scenario,
            "plan": self.plan, "platform": self.platform,
            "seed": self.workload.seed,
            "n_requests": self.workload.n,
            "batches": [p.batch for p in self.points],
            "inflection_batch": self.boundedness.inflection_batch,
            "classification": {
                str(p.batch): self.boundedness.classify(p.batch)
                for p in self.points
            },
            "points": [p.row() for p in self.points],
        }


def _requests(workload: Workload) -> list:
    # engine Requests are mutable run state; mint fresh ones per run
    return [Request(r.rid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens,
                    arrival_s=r.arrival_s)
            for r in workload.requests]


def run_point(cfg, params, workload: Workload, *, batch: int,
              plan: str = "auto", platform: str = "Intel+H100",
              max_len: int = 256, warmup: bool = True,
              cache: str = "contiguous", block_size: int = 16,
              num_blocks=None, offload: str = "none",
              prefill_chunk=None, device="cuda") -> MeasuredPoint:
    """Serve the workload with ``batch`` slots and measure one sweep point."""
    rec = SpanRecorder()
    eng = ServeEngine(cfg, params, max_batch=batch, max_len=max_len,
                      plan=plan, platform=platform, telemetry=rec,
                      cache=cache, block_size=block_size,
                      num_blocks=num_blocks, offload=offload,
                      prefill_chunk=prefill_chunk, device=device)
    if warmup:
        eng.run(_requests(workload))
        eng.reset()
    eng.run(_requests(workload))
    st = eng.stats
    lat = summarize(list(eng.timings.values()))
    steps = st.step_times_s
    mean_step = sum(steps) / len(steps) if steps else 0.0
    planned = eng._planned_decode
    decode_spans = [s for s in rec.spans if s.cat == "decode"]
    return MeasuredPoint(
        batch=batch,
        latency=lat,
        mean_decode_step_s=mean_step,
        launch_tax_per_step_s=st.launch_tax_per_step_s,
        decode_launch_tax_s=st.launch_tax_per_decode_step_s,
        dispatches_per_decode_step=st.dispatches_per_decode_step,
        fused_dispatches_per_decode_step=st.fused_dispatches_per_decode_step,
        rule_hits=dict(st.rule_hits),
        preemptions=st.preemptions,
        offload_bytes=st.offload_bytes,
        restore_bytes=st.restore_bytes,
        modeled_offload_tax_s=st.modeled_offload_tax_s,
        mean_pool_utilization=st.mean_block_pool_utilization,
        peak_pool_utilization=st.peak_block_pool_utilization,
        modeled_tklqt_s=st.modeled_tklqt_s,
        tokens_per_s=st.tokens_out / eng.now if eng.now else 0.0,
        mean_occupancy=(sum(st.slot_occupancy) / len(st.slot_occupancy)
                        if st.slot_occupancy else 0.0),
        tokens_out=st.tokens_out,
        decode_steps=st.decode_steps,
        spans=list(rec.spans),
        modeled_events=(list(planned.modeled_events) if planned else []),
        decode_anchors=[s.t0 for s in decode_spans[:MAX_DEVICE_ANCHORS]],
        attribution=(planned.attribution if planned else None),
    )


def characterize(cfg, params, *, scenario: str = "chatbot",
                 batches: Sequence[int] = (1, 2, 4), plan: str = "auto",
                 platform: str = "Intel+H100", n_requests: int = 6,
                 seed: int = 0, prompt_cap: Optional[int] = 24,
                 output_cap: Optional[int] = 8, time_scale: float = 1.0,
                 max_len: int = 256, warmup: bool = True,
                 workload: Optional[Workload] = None,
                 cache: str = "contiguous", block_size: int = 16,
                 num_blocks=None, offload: str = "none",
                 prefill_chunk=None, device="cuda") -> CharacterizationResult:
    """Scenario x batch sweep over the live engine -> measured boundedness.

    Pass ``workload`` (e.g. loaded from a recorded JSONL trace) to replay
    exact traffic instead of generating it from the scenario registry.
    """
    if workload is None:
        workload = sample_requests(scenario, n_requests, seed=seed,
                                   vocab_size=cfg.vocab_size,
                                   prompt_cap=prompt_cap,
                                   output_cap=output_cap,
                                   time_scale=time_scale)
    elif workload.vocab_size > cfg.vocab_size:
        # a token past the vocabulary is an index error in torch.embedding
        # on the CPU and a device-side assert on CUDA (which poisons the
        # process's context): refuse the trace before serving it
        raise ValueError(
            f"workload was recorded for vocab_size={workload.vocab_size} "
            f"but model {cfg.name} has vocab_size={cfg.vocab_size}; "
            "re-record the trace against this config")
    points = [run_point(cfg, params, workload, batch=b, plan=plan,
                        platform=platform, max_len=max_len, warmup=warmup,
                        cache=cache, block_size=block_size,
                        num_blocks=num_blocks, offload=offload,
                        prefill_chunk=prefill_chunk, device=device)
              for b in batches]
    bound = classify_measured_sweep(
        [p.batch for p in points],
        [p.mean_decode_step_s for p in points],
        [p.decode_launch_tax_s for p in points])
    return CharacterizationResult(
        arch=cfg.name, scenario=workload.scenario, plan=plan,
        platform=platform, workload=workload, points=points,
        boundedness=bound)


# ------------------------------------------------------------ memory pressure
@dataclass
class MemoryPressurePoint:
    """One (platform, kv dtype, pool size) cell of the pressure sweep."""
    platform: str
    coupling: str                  # LC (PCIe) | CC (C2C)
    link_gbps: float
    kv_dtype: str                  # bf16 | int8 page payloads
    block_bytes: int               # device bytes of ONE pool block
    pool_frac: float               # fraction of the no-pressure pool size
    num_blocks: int
    preemptions: int
    offload_bytes: int
    restore_bytes: int
    modeled_offload_tax_s: float
    peak_pool_utilization: float
    tokens_out: int
    decode_steps: int

    def row(self) -> dict:
        tax_us = self.modeled_offload_tax_s * 1e6
        return {
            "platform": self.platform, "coupling": self.coupling,
            "link_gbps": round(self.link_gbps, 1),
            "kv_dtype": self.kv_dtype,
            "block_bytes": self.block_bytes,
            "pool_frac": self.pool_frac, "num_blocks": self.num_blocks,
            "preemptions": self.preemptions,
            "offload_bytes": self.offload_bytes,
            "restore_bytes": self.restore_bytes,
            "modeled_offload_tax_us": round(tax_us, 1),
            "offload_tax_per_token_us":
                round(tax_us / self.tokens_out, 2) if self.tokens_out
                else 0.0,
            "peak_pool_utilization": round(self.peak_pool_utilization, 3),
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
        }


def memory_pressure_sweep(cfg, params, *, scenario: str = "chatbot",
                          platforms: Sequence[str] = ("Intel+H100", "GH200"),
                          pool_fracs: Sequence[float] = (1.0, 0.5, 0.33),
                          kv_dtypes: Sequence[str] = ("bf16",),
                          max_batch: int = 4, max_len: int = 64,
                          block_size: int = 4,
                          prefill_chunk: Optional[int] = None,
                          n_requests: int = 8, seed: int = 0,
                          prompt_cap: Optional[int] = 16,
                          output_cap: Optional[int] = 8,
                          device="cuda") -> dict:
    """Drive the paged engine's block pool past capacity on LC vs CC
    device models (the paper's coupling axis applied to KV offload).

    The eviction traffic is MEASURED — the same seeded workload drives
    near-identical preemptions and offload bytes on every platform
    (exactly identical for closed-loop scenarios; open-loop arrivals
    interact with measured step durations) — while the transfer time
    those bytes cost is MODELED through each platform's coupling link
    (``core.device_model.offload_cost_s``), so the sweep isolates how
    PCIe (LC) vs NVLink-C2C (CC) bandwidth changes the offload tax of
    serving under memory pressure.

    ``kv_dtypes`` adds the quantization axis: every (platform, frac)
    cell is re-served per dtype with the pool held at the SAME device
    BYTE budget — an int8 pool fits ``block_bytes(bf16)/block_bytes
    (int8)`` more blocks, so the sweep measures how quantization converts
    a fixed byte budget into fewer preemptions and less offload traffic.

    Beside the reference's keys, ``measured_offload_copy_us`` holds, per
    point, the device time of the offload tier's pinned copies on a CUDA
    device (None on the CPU), the measured counterpart of the modeled tax.
    """
    from repro_torch.core.device_model import PLATFORMS
    workload = sample_requests(scenario, n_requests, seed=seed,
                               vocab_size=cfg.vocab_size,
                               prompt_cap=prompt_cap, output_cap=output_cap)
    # pool sized against the workload's own peak demand (longest possible
    # sequence on every slot at once) so pool_frac < 1 actually presses
    longest = max(len(r.prompt) + r.max_new_tokens
                  for r in workload.requests)
    per_seq = -(-longest // block_size)
    full_blocks = max_batch * per_seq
    min_blocks = per_seq + 1                     # one full request + growth
    # per-dtype bytes of one pool block, measured off a 1-block probe —
    # byte-budget equivalence below uses REAL leaf sizes, not entry math
    bb = {}
    for dt in kv_dtypes:
        probe = PagedKVCache(cfg, num_blocks=1, block_size=block_size,
                             max_len=block_size, kv_dtype=dt, device=device)
        probe.make_pages()
        bb[dt] = probe.pool.block_bytes
    points, copy_us = [], []
    for plat in platforms:
        spec = PLATFORMS[plat]
        for frac in pool_fracs:
            nb_native = max(min_blocks, int(full_blocks * frac))
            byte_budget = nb_native * bb[kv_dtypes[0]]
            for dt in kv_dtypes:
                nb = max(min_blocks, byte_budget // bb[dt])
                eng = ServeEngine(cfg, params, max_batch=max_batch,
                                  max_len=max_len, platform=plat,
                                  cache="paged", block_size=block_size,
                                  num_blocks=nb, offload="host",
                                  prefill_chunk=prefill_chunk,
                                  kv_dtype=dt, device=device)
                eng.run(_requests(workload))
                st = eng.stats
                points.append(MemoryPressurePoint(
                    platform=plat, coupling=spec.coupling,
                    link_gbps=spec.link_bw / 1e9, kv_dtype=dt,
                    block_bytes=bb[dt], pool_frac=frac,
                    num_blocks=nb, preemptions=st.preemptions,
                    offload_bytes=st.offload_bytes,
                    restore_bytes=st.restore_bytes,
                    modeled_offload_tax_s=st.modeled_offload_tax_s,
                    peak_pool_utilization=st.peak_block_pool_utilization,
                    tokens_out=st.tokens_out,
                    decode_steps=st.decode_steps))
                copy_us.append(eng.offload_tier.measured_copy_s * 1e6
                               if eng.backend.device.type == "cuda"
                               else None)
    return {
        "arch": cfg.name, "scenario": workload.scenario,
        "seed": workload.seed, "n_requests": workload.n,
        "max_batch": max_batch, "max_len": max_len,
        "block_size": block_size, "full_pool_blocks": full_blocks,
        "platforms": list(platforms), "pool_fracs": list(pool_fracs),
        "kv_dtypes": list(kv_dtypes),
        "block_bytes": dict(bb),
        "points": [p.row() for p in points],
        "kv_dtype_deltas": _kv_dtype_deltas(points, kv_dtypes),
        "measured_offload_copy_us": copy_us,
    }


def _kv_dtype_deltas(points, kv_dtypes) -> list:
    """Matched (platform, pool_frac) comparisons of each quantized dtype
    against the native baseline at the same device byte budget: pool
    capacity in blocks, preemption count, and offload-tax deltas."""
    if len(kv_dtypes) < 2:
        return []
    base_dt = kv_dtypes[0]
    base = {(p.platform, p.pool_frac): p for p in points
            if p.kv_dtype == base_dt}
    rows = []
    for p in points:
        if p.kv_dtype == base_dt:
            continue
        b = base[(p.platform, p.pool_frac)]
        rows.append({
            "platform": p.platform, "pool_frac": p.pool_frac,
            "kv_dtype": p.kv_dtype, "baseline": base_dt,
            "capacity_ratio": round(p.num_blocks / b.num_blocks, 2),
            "preemptions": {base_dt: b.preemptions,
                            p.kv_dtype: p.preemptions},
            "offload_bytes": {base_dt: b.offload_bytes,
                              p.kv_dtype: p.offload_bytes},
            "offload_tax_delta_us": round(
                (p.modeled_offload_tax_s - b.modeled_offload_tax_s) * 1e6,
                1),
            "peak_pool_utilization": {
                base_dt: round(b.peak_pool_utilization, 3),
                p.kv_dtype: round(p.peak_pool_utilization, 3)},
        })
    return rows


# ------------------------------------------------------------ tp sweep
@dataclass
class TPSweepPoint:
    """One (platform, tp, batch) cell of the tensor-parallel sweep."""
    platform: str
    coupling: str                  # LC (PCIe) | CC (C2C)
    tp: int
    batch: int
    n_kernels: int                 # eager stream length (one decode step)
    per_device_dispatches: int     # launches issued per device stream
    modeled_tklqt_s: float
    modeled_step_s: float          # end of the simulated device timeline
    launch_tax_s: float            # host-side launch time of the step
    collective_bytes: int          # all-reduce payload per step (all layers)
    modeled_collective_tax_s: float

    def row(self) -> dict:
        return {
            "platform": self.platform, "coupling": self.coupling,
            "tp": self.tp, "batch": self.batch,
            "n_kernels": self.n_kernels,
            "per_device_dispatches": self.per_device_dispatches,
            "modeled_tklqt_us": round(self.modeled_tklqt_s * 1e6, 1),
            "modeled_step_us": round(self.modeled_step_s * 1e6, 1),
            "launch_tax_us": round(self.launch_tax_s * 1e6, 1),
            "collective_bytes": self.collective_bytes,
            "modeled_collective_tax_us":
                round(self.modeled_collective_tax_s * 1e6, 1),
        }


def decode_collective_sites(cfg, batch: int, n_segments: int) -> list:
    """Per-segment all-reduce payloads of ONE tensor-parallel decode step.

    Every layer reduces its attention output and its MLP output — two
    (B, 1, d_model) activations in the compute dtype.  The ``2 *
    n_layers`` sites are spread uniformly across the segment stream (the
    layer structure is periodic), so each all-reduce pays its own
    ring-latency floor in the queue model instead of one smeared
    aggregate."""
    n_sites = 2 * cfg.n_layers
    per_site = batch * cfg.d_model * cfg.cdtype.itemsize
    coll = [0.0] * n_segments
    if not n_segments:
        return coll
    for s in range(n_sites):
        # last segment of each uniform span: the reduce closes a layer half
        idx = min(((s + 1) * n_segments) // n_sites, n_segments) - 1
        coll[max(idx, 0)] += per_site
    return coll


def tp_sweep(cfg, params, *, batches: Sequence[int] = (1, 2, 4, 8),
             tps: Sequence[int] = (1, 2, 4, 8),
             platforms: Sequence[str] = ("Intel+H100", "GH200"),
             max_len: int = 64, device="cuda") -> dict:
    """Model how tensor parallelism shifts the CPU->GPU-bound transition.

    The port's decode step is traced ONCE per batch (fake tensors: no
    kernel runs; on the GPU the stream holds the hand-written kernels),
    then priced per (platform, tp) through ``simulate_plan``: the host
    issues every launch once per device stream (launch tax x tp), each
    device runs 1/tp of the flops/bytes, and the per-layer all-reduce
    payloads ride the platform's coupling link (``allreduce_cost_s``).
    The per-(platform, tp) TKLQT-vs-batch curve is classified with the
    same inflection rule as the measured sweep, so the output shows how
    the inflection batch moves with tp.  The port's trace holds other
    kernels than the reference's XLA trace, so its inflections are its
    own.  Nothing executes sharded, so one device serves every tp.
    """
    traces = {b: _decode_trace(cfg, params, b, max_len, device)
              for b in batches}
    points: list[TPSweepPoint] = []
    inflection: dict = {}
    for plat in platforms:
        spec = PLATFORMS[plat]
        inflection[plat] = {}
        for tp in tps:
            reports = []
            for b in batches:
                tr = traces[b]
                n = len(tr.kernels)
                plan = LaunchPlan.eager(n)
                coll = (decode_collective_sites(cfg, b, n)
                        if tp > 1 else None)
                # one queue-model walk per cell: the SkipReport is
                # derived from the same event list the point exposes
                ev = simulate_plan(tr.kernels, plan, spec, tp=tp,
                                   collective_bytes=coll)
                rep = report(ev, spec.name,
                             spec.launch_overhead_ns * 1e-9)
                reports.append(rep)
                points.append(TPSweepPoint(
                    platform=plat, coupling=spec.coupling, tp=tp, batch=b,
                    n_kernels=n,
                    per_device_dispatches=n,
                    modeled_tklqt_s=rep.tklqt,
                    modeled_step_s=ev[-1].kernel_end if ev else 0.0,
                    launch_tax_s=sum(e.t_launch for e in ev),
                    collective_bytes=int(sum(coll)) if coll else 0,
                    modeled_collective_tax_s=sum(
                        allreduce_cost_s(spec, c, tp)
                        for c in (coll or []) if c)))
            bound = classify_sweep(batches, reports)
            inflection[plat][str(tp)] = bound.inflection_batch
    return {
        "arch": cfg.name, "max_len": max_len,
        "batches": list(batches), "tps": list(tps),
        "platforms": list(platforms),
        "inflection_batch": inflection,
        "points": [p.row() for p in points],
    }


# ------------------------------------------------------------ spec sweep
@dataclass
class SpecSweepPoint:
    """One (k, batch) cell of the speculative-decoding sweep (measured)."""
    k: int
    batch: int
    accept_rate: float
    steps_per_emitted_token: float
    spec_rounds: int
    proposed: int
    accepted: int
    corrections: int
    draft_dispatches: int
    tokens_out: int
    decode_steps: int

    def row(self) -> dict:
        return {
            "k": self.k, "batch": self.batch,
            "accept_rate": round(self.accept_rate, 3),
            "steps_per_emitted_token":
                round(self.steps_per_emitted_token, 3),
            "spec_rounds": self.spec_rounds,
            "proposed": self.proposed, "accepted": self.accepted,
            "corrections": self.corrections,
            "draft_dispatches": self.draft_dispatches,
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
        }


def _decode_trace(cfg, params, batch: int, max_len: int, device):
    """The port's decode step at ``batch`` rows, traced (fake tensors: no
    kernel runs)."""
    body = make_step_bodies(cfg).decode
    # one zero cross row, as every served cache holds
    cache = make_cache(cfg, batch, max_len, src_len=1, device=device)
    return trace_fn(lambda p, c, t, n: body(p, c, t, n)[0], params, cache,
                    torch.zeros((batch, 1), dtype=torch.int32, device=device),
                    torch.zeros((batch,), dtype=torch.int32, device=device))


def spec_sweep(cfg, params, *, draft_cfg=None, draft_params=None,
               ks: Sequence[int] = (2, 4, 8),
               batches: Sequence[int] = (1, 2, 4),
               platforms: Sequence[str] = ("Intel+H100", "GH200"),
               scenario: str = "chatbot", n_requests: int = 6,
               seed: int = 0, prompt_cap: Optional[int] = 16,
               output_cap: Optional[int] = 12, max_len: int = 128,
               cache: str = "contiguous", block_size: int = 16,
               num_blocks=None, warmup: bool = False,
               model_batches: Optional[Sequence[int]] = None,
               device="cuda") -> dict:
    """Sweep speculation depth x batch: measured acceptance, modeled tax.

    The trade speculation makes is the paper's launch-tax axis run in
    reverse: the draft ADDS k small dispatches per round to REMOVE
    sequential target steps (the batched verify scores k+1 positions per
    launch stream).  So it pays off where decode is CPU/dispatch-bound —
    low batch — and keeps paying on coupled (CC) parts out to larger
    batches.

    Measured side: the live engine (``plan="jit"``) serves the same seeded
    workload at every (k, batch) with a fixed depth (``spec_inflection``
    None pins ``pick_spec_k`` at k; k = 0 is plain decode); acceptance and
    steps per emitted token are properties of the draft/target pair.
    Modeled side: the port's decode step is traced per batch
    (``model_batches`` extends past the measured range) and priced per
    platform through ``simulate_plan``: the baseline is one decode step
    per emitted token per sequence; the speculative round scales the
    stream by ``batch_scale=k+1`` (verify work) and prepends ``k x
    n_draft_kernels`` serialized draft dispatches, then divides by the
    MEASURED emitted tokens per sequence per round (taken at the largest
    measured batch and carried to the extended ones).  A cell "wins"
    when modeled spec time per token beats the baseline."""
    if draft_cfg is None:
        draft_cfg = default_draft_config(cfg)
    if draft_params is None:
        draft_params = draft_params_from_target(params, draft_cfg)
    workload = sample_requests(scenario, n_requests, seed=seed,
                               vocab_size=cfg.vocab_size,
                               prompt_cap=prompt_cap, output_cap=output_cap)

    # ---- measured: acceptance + steps/token per (k, batch)
    points: list[SpecSweepPoint] = []
    for b in batches:
        for k in ks:
            eng = ServeEngine(cfg, params, max_batch=b, max_len=max_len,
                              cache=cache, block_size=block_size,
                              num_blocks=num_blocks, device=device,
                              speculative=k > 0, spec_k=max(k, 1),
                              draft_config=draft_cfg if k > 0 else None,
                              draft_params=draft_params if k > 0 else None)
            if warmup:
                eng.run(_requests(workload))
                eng.reset()
            eng.run(_requests(workload))
            st = eng.stats
            points.append(SpecSweepPoint(
                k=k, batch=b, accept_rate=st.accept_rate,
                steps_per_emitted_token=st.steps_per_emitted_token,
                spec_rounds=st.spec_rounds, proposed=st.proposed,
                accepted=st.accepted, corrections=st.corrections,
                draft_dispatches=st.draft_dispatches,
                tokens_out=st.tokens_out, decode_steps=st.decode_steps))
            dev = eng.backend.device
            del eng
    measured = {(p.k, p.batch): p for p in points}

    # emitted tokens per sequence per round: a per-sequence property of the
    # draft/target pair, carried from the largest measured batch
    emit_per_seq: dict = {}
    bmax = max(batches)
    for k in ks:
        if k == 0:
            continue
        p = measured[(k, bmax)]
        emitted = p.accepted + p.corrections
        emit_per_seq[k] = (emitted / (p.spec_rounds * bmax)
                          if p.spec_rounds else 1.0)

    if model_batches is None:
        model_batches = sorted(set(batches) | {16, 64, 256})
    traces = {b: _decode_trace(cfg, params, b, max_len, dev)
              for b in model_batches}
    n_draft_kernels = len(_decode_trace(draft_cfg, draft_params, 1, max_len,
                                        dev).kernels)

    modeled = []
    win_region: dict = {}
    for plat in platforms:
        spec = PLATFORMS[plat]
        win_region[plat] = {}
        for b in model_batches:
            tr = traces[b]
            plan = LaunchPlan.eager(len(tr.kernels))
            # one decode step emits one token per sequence
            base_ev = simulate_plan(tr.kernels, plan, spec)
            base_per_tok = base_ev[-1].kernel_end if base_ev else 0.0
            for k in ks:
                if k == 0:
                    continue
                meas = measured.get((k, b))
                ev = simulate_plan(tr.kernels, plan, spec,
                                   batch_scale=float(k + 1),
                                   draft_launches=k * n_draft_kernels)
                round_s = ev[-1].kernel_end if ev else 0.0
                spec_per_tok = round_s / emit_per_seq[k]
                tax = k * n_draft_kernels * dispatch_fanout_s(spec, 1)
                win = bool(spec_per_tok < base_per_tok)
                modeled.append({
                    "platform": plat, "coupling": spec.coupling,
                    "k": k, "batch": b, "measured": meas is not None,
                    "accept_rate": round(
                        (meas or measured[(k, bmax)]).accept_rate, 3),
                    "emitted_per_seq_per_round":
                        round(emit_per_seq[k], 3),
                    "modeled_baseline_per_token_us":
                        round(base_per_tok * 1e6, 1),
                    "modeled_spec_per_token_us":
                        round(spec_per_tok * 1e6, 1),
                    "modeled_draft_launch_tax_per_round_us":
                        round(tax * 1e6, 1),
                    "win": win,
                })
                if win:
                    win_region[plat].setdefault(str(k), []).append(b)
    return {
        "arch": cfg.name, "draft": draft_cfg.name,
        "scenario": workload.scenario, "seed": workload.seed,
        "n_requests": workload.n, "max_len": max_len, "cache": cache,
        "ks": list(ks), "batches": list(batches),
        "model_batches": list(model_batches),
        "platforms": list(platforms),
        "n_draft_kernels": n_draft_kernels,
        "device": str(dev),
        "measured": [p.row() for p in points],
        "modeled": modeled,
        "win_batches": win_region,
    }
