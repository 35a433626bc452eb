"""Continuous-batching serving scheduler over the contiguous KV cache.

Counterpart of the contiguous path of ``repro/inference/engine.py``: a
fixed pool of B slots; a new request is prefilled into a free slot (its
prompt padded to a power-of-two bucket, min 8); every step decodes all
active slots in one batched step with per-slot lengths; a finished slot
frees at once and is refilled from the queue.  Greedy tokens are chosen by
argmax on the host, as the reference does.

Device work goes through an ``ExecutionBackend`` (``backends.local``).
The paged cache, host offload, speculative decoding, tensor parallelism,
launch plans, the request tracer and the boundedness monitor are not
ported yet: asking for any of them raises ``ValueError`` rather than being
ignored.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.inference.backends import (NOT_PORTED, CallAccount,
                                            make_backend)
from repro_torch.telemetry.metrics import RequestTiming
from repro_torch.telemetry.registry import MetricsRegistry


@dataclass
class Request:
    """One serving request: prompt in, greedy continuation out."""

    rid: int
    prompt: list
    max_new_tokens: int = 16
    arrival_s: float = 0.0         # offset on the engine clock (open loop)
    generated: list = field(default_factory=list)
    done: bool = False
    status: str = "queued"         # queued|active|done|rejected


class EngineStats:
    """Serving counters as a derived view of a ``MetricsRegistry``.

    Scalar fields live in registry gauges (attribute reads pull the gauge,
    assignments and ``+=`` write it); series and per-request timings are
    plain attributes.  The field set is the reference's, restricted to what
    the contiguous eager path fills, plus the hand-written kernels' launch
    counts.
    """

    # attribute -> (gauge name, python type, help text)
    _SCALARS = {
        "prefills": ("engine_prefills", int, "prefill steps executed"),
        "decode_steps": ("engine_decode_steps", int,
                         "batched decode steps executed"),
        "tokens_out": ("engine_tokens_out", int, "tokens emitted"),
        "measured_dispatch_s": ("engine_measured_dispatch_seconds", float,
                                "measured host launch tax, all steps"),
        "decode_dispatch_time_s": ("engine_decode_dispatch_seconds", float,
                                   "measured launch tax, decode only"),
        "rejected": ("engine_rejected", int,
                     "admissions refused: plen + budget > max_len"),
        "prefill_kernel_launches": ("engine_prefill_kernel_launches", int,
                                    "hand-written kernel launches in "
                                    "prefills"),
    }

    def __init__(self, plan: str = "eager", registry=None):
        if registry is None:
            registry = MetricsRegistry()
        object.__setattr__(self, "registry", registry)
        gauges = {}
        for attr, (name, _, help_text) in self._SCALARS.items():
            g = registry.gauge(name, help_text)
            g.set(0)
            gauges[attr] = g
        object.__setattr__(self, "_gauges", gauges)
        self.plan = plan
        self.slot_occupancy = []
        self.step_times_s = []         # decode step durations
        self.decode_launches_by_kernel = {}   # wrapper name -> launches
        self.timings = {}              # rid -> RequestTiming

    def __getattr__(self, name):
        spec = type(self)._SCALARS.get(name)
        if spec is None:
            raise AttributeError(
                f"{type(self).__name__!r} object has no attribute {name!r}")
        try:
            gauges = object.__getattribute__(self, "_gauges")
        except AttributeError:
            raise AttributeError(name) from None
        v = gauges[name].value()
        return int(v) if spec[1] is int else v

    def __setattr__(self, name, value):
        if name in self._SCALARS:
            self._gauges[name].set(value)
        else:
            object.__setattr__(self, name, value)

    @property
    def ttft_s(self) -> dict:
        """Time-to-first-token per request id (first-token seen only)."""
        return {rid: t.ttft_s for rid, t in self.timings.items()
                if not math.isnan(t.first_token_s)}

    @property
    def e2e_s(self) -> dict:
        """End-to-end latency per completed request id."""
        return {rid: t.e2e_s for rid, t in self.timings.items()
                if not math.isnan(t.done_s)}

    @property
    def itl_samples_s(self) -> list:
        """Every inter-token-latency gap across all requests."""
        return [g for t in self.timings.values() for g in t.itl_s]

    @property
    def mean_ttft_s(self) -> float:
        ttft = self.ttft_s
        return sum(ttft.values()) / len(ttft) if ttft else 0.0

    @property
    def mean_itl_s(self) -> float:
        itl = self.itl_samples_s
        return sum(itl) / len(itl) if itl else 0.0

    @property
    def launch_tax_per_step_s(self) -> float:
        """Measured host time per engine step (prefill + decode)."""
        steps = self.prefills + self.decode_steps
        return self.measured_dispatch_s / steps if steps else 0.0

    @property
    def launch_tax_per_decode_step_s(self) -> float:
        return (self.decode_dispatch_time_s / self.decode_steps
                if self.decode_steps else 0.0)

    @property
    def kernel_launches_per_decode_step(self) -> dict:
        """Mean hand-written kernel launches per decode step, by kernel."""
        n = self.decode_steps
        return {k: (v / n if n else 0.0)
                for k, v in sorted(self.decode_launches_by_kernel.items())}


class ServeEngine:
    """Continuous-batching serving scheduler over an execution backend.

    Drive it closed-loop with ``run(requests)`` or steppable with
    ``submit()`` + ``tick()``.  ``device`` defaults to ``"cuda"`` and
    raises when no GPU is present; tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256, plan: str = "eager", device="cuda",
                 plan_table=None, tp: int = 1, cache: str = "contiguous",
                 offload: str = "none", speculative: bool = False,
                 monitor=None, tracer=None):
        unported = [name for name, asked in (
            ("plan_table", plan_table is not None),
            ("cache='paged'", cache != "contiguous"),
            ("offload", offload != "none"),
            ("speculative", bool(speculative)),
            ("monitor", bool(monitor)),
            ("tracer", tracer is not None)) if asked]
        if unported:
            raise ValueError(f"{', '.join(unported)} {NOT_PORTED}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch} "
                             "(an engine with no slots can never admit)")
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.T = max_len
        self.backend = make_backend(cfg, params, max_batch=max_batch,
                                    max_len=max_len, tp=tp, plan=plan,
                                    device=device)
        self.plan = self.plan_label = self.backend.plan
        self.tp = self.backend.info.tp
        self.cache = self.backend.init_contiguous_cache()
        self._pending: list = []
        self.lengths = np.zeros(max_batch, np.int32)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.registry = MetricsRegistry()
        self.stats = EngineStats(plan=self.plan_label, registry=self.registry)
        # virtual serving clock (seconds): advances by measured wall time
        # while the engine works, jumps over idle gaps of open-loop arrivals
        self.now = 0.0
        self._bind_telemetry()

    # ------------------------------------------------------------ internals
    @property
    def timings(self) -> dict:
        return self.stats.timings

    @staticmethod
    def _bucket(n: int) -> int:
        """Round a length to its power-of-two bucket (min 8)."""
        return max(8, 1 << (n - 1).bit_length())

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @staticmethod
    def _sample(logits_row: torch.Tensor) -> int:
        """Greedy token choice from one logits row, on the host."""
        return int(np.argmax(logits_row.cpu().numpy()))

    def _absorb(self, acct: CallAccount, *, decode: bool) -> None:
        """Fold one backend call's accounting into EngineStats."""
        if decode:
            self.stats.decode_dispatch_time_s += acct.host_time_s
            by = self.stats.decode_launches_by_kernel
            for name, c in acct.kernel_launches.items():
                by[name] = by.get(name, 0) + c
        else:
            self.stats.prefill_kernel_launches += sum(
                acct.kernel_launches.values())
        self.stats.measured_dispatch_s += acct.host_time_s

    def _bind_telemetry(self) -> None:
        reg = self.registry
        self.backend.bind_metrics(reg)
        self._h_step = reg.histogram("engine_step_time_seconds",
                                     "decode step wall time")
        self._h_ttft = reg.histogram(
            "engine_ttft_seconds", "arrival to first emission, engine clock")
        self._h_itl = reg.histogram("engine_itl_seconds",
                                    "inter-token latency")

    def _note_first_token(self, req: Request) -> RequestTiming:
        timing = RequestTiming(req.rid, arrival_s=req.arrival_s,
                               first_token_s=self.now)
        timing.token_times_s.append(self.now)
        self.timings[req.rid] = timing
        self._h_ttft.observe(max(0.0, self.now - req.arrival_s))
        return timing

    def _note_token(self, timing) -> None:
        if timing is None:
            return
        if timing.token_times_s:
            self._h_itl.observe(max(0.0, self.now - timing.token_times_s[-1]))
        timing.token_times_s.append(self.now)

    # ------------------------------------------------------------ api
    def admit(self, req: Request) -> bool:
        """Admit one request into a slot and prefill; False = no room.

        A request whose prompt + decode budget exceeds ``max_len`` is
        rejected (status ``rejected``) instead of writing out of bounds.
        """
        plen = len(req.prompt)
        if plen + req.max_new_tokens > self.T:
            req.done = True
            req.status = "rejected"
            self.stats.rejected += 1
            self.timings.setdefault(
                req.rid, RequestTiming(req.rid, arrival_s=req.arrival_s))
            return True
        slot = self._free_slot()
        if slot is None:
            return False
        toks = np.zeros((1, self._bucket(plen)), np.int32)
        toks[0, :plen] = req.prompt
        t0 = time.perf_counter()
        logits, self.cache = self.backend.prefill(
            self.cache, torch.from_numpy(toks), slot, plen)
        self._absorb(self.backend.last, decode=False)
        first = self._sample(logits[0])
        self.now += time.perf_counter() - t0
        req.generated.append(first)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        timing = self._note_first_token(req)
        if len(req.generated) >= req.max_new_tokens:
            # single-token budget: done at prefill, never occupies a slot
            req.done = True
            req.status = "done"
            timing.done_s = self.now
        else:
            req.status = "active"
            self.slots[slot] = req
            self.lengths[slot] = plen
        return True

    def step(self) -> None:
        """One batched decode step for all active slots."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        toks = np.zeros((self.B, 1), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].generated[-1]
        t0 = time.perf_counter()
        logits, self.cache = self.backend.decode(
            self.cache, torch.from_numpy(toks), self.lengths.copy())
        self._absorb(self.backend.last, decode=True)
        self.stats.decode_steps += 1
        self.stats.slot_occupancy.append(len(active))
        logits_np = logits.cpu().numpy()
        dt = time.perf_counter() - t0
        self.now += dt
        self.stats.step_times_s.append(dt)
        self._h_step.observe(dt)
        for i in active:
            req = self.slots[i]
            self.lengths[i] += 1
            req.generated.append(int(np.argmax(logits_np[i])))
            self.stats.tokens_out += 1
            timing = self.timings.get(req.rid)
            self._note_token(timing)
            if len(req.generated) >= req.max_new_tokens or \
                    self.lengths[i] >= self.T - 1:
                req.done = True
                req.status = "done"
                self.slots[i] = None
                self.lengths[i] = 0
                if timing is not None:
                    timing.done_s = self.now

    # ------------------------------------------------------------ run loop
    def submit(self, req: Request) -> None:
        """Enqueue one request; ``tick()`` admits it once the engine clock
        reaches ``req.arrival_s`` and a slot is free."""
        self._pending.append(req)
        self._pending.sort(key=lambda r: r.arrival_s)   # stable

    @property
    def busy(self) -> bool:
        """True while any request is queued or in a slot."""
        return bool(self._pending) or any(s is not None for s in self.slots)

    def tick(self) -> bool:
        """One scheduling round: fast-forward over an idle gap, admit every
        eligible request, then one ``step()``.  False once no work remains."""
        if not self.busy:
            return False
        idle = not any(s is not None for s in self.slots)
        if idle and self._pending and self._pending[0].arrival_s > self.now:
            self.now = self._pending[0].arrival_s
        while (self._pending and self._pending[0].arrival_s <= self.now
               and self._free_slot() is not None):
            if not self.admit(self._pending[0]):
                break
            self._pending.pop(0)
        self.step()
        return True

    def run(self, requests: list[Request]) -> list[Request]:
        """Continuous batching: admit whenever a slot frees; returns the
        finished requests in completion order."""
        for r in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(r)
        done: list[Request] = []
        while self.tick():
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        for r in requests:
            if r.done and r not in done:
                done.append(r)
        return done

    def reset(self) -> None:
        """Clear serving state (slots, stats, clock, timings) but keep the
        backend and its built kernels: warmup run, reset, measured run."""
        for c in self.cache:
            for t in c.values():
                t.zero_()
        self.lengths = np.zeros(self.B, np.int32)
        self.slots = [None] * self.B
        self.registry = MetricsRegistry()
        self.stats = EngineStats(plan=self.plan_label, registry=self.registry)
        self.now = 0.0
        self._pending = []
        self._bind_telemetry()
