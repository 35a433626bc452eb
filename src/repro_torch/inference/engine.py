"""Continuous-batching serving scheduler over a contiguous or paged KV cache.

Counterpart of ``repro/inference/engine.py``: a fixed pool of B slots; a
new request is prefilled into a free slot; every step decodes all active
slots in one batched step with per-slot lengths; a finished slot frees at
once and is refilled from the queue.  Greedy tokens are chosen by argmax
on the host, as the reference does.

``cache="contiguous"`` prefills a whole prompt (padded to a power-of-two
bucket, min 8) into the slot's rows.  A recurrent stack (RWKV-6) and an
encoder (BERT, XLM-R) are prefilled with exactly the prompt's tokens: a
pad token would run through a recurrence and token shift and change the
state decode starts from, and an encoder's non-causal prompt would attend
to it.  The reference pads both and lets the pads in, and its tokens then
differ from an unpadded incremental forward (ROADMAP Queue C).  The paged
cache refuses a recurrent stack, as the reference's does.

``cache="paged"`` keeps KV in a pool
of fixed-size pages reached through numpy block tables
(``repro_torch.kvcache``) and runs the reference's paged policy: chunked
prefill interleaved with decode steps, evict-or-preempt under pool
pressure (youngest victim first; its KV either discarded and recomputed on
resume or, with ``offload="host"``, staged in pinned host memory and
restored), int8 pages (``kv_dtype="int8"``) and copy-on-write prefix
sharing (``share_prefix=True``).

Device work goes through an ``ExecutionBackend`` (``backends.local``):
``plan="jit"`` (the default, as in the reference) replays each step as
one CUDA graph; ``"eager"``, ``"whole_graph"``, ``"chain"``, ``"auto"``
and ``"fused"`` run it through the launch-plan runtime (``runtime/``),
whose dispatches, modeled TKLQT and fused rule hits the stats count.
``plan="autotuned"``, speculative decoding, tensor parallelism, the
request tracer and the boundedness monitor are not ported yet: asking for
any of them raises ``ValueError`` rather than being ignored.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device_model import PLATFORMS
from repro_torch.inference.backends import (NOT_PORTED, CallAccount,
                                            make_backend)
from repro_torch.inference.kv_quant import KV_DTYPES
from repro_torch.kvcache import (HostOffloadTier, PagedKVCache,
                                 default_num_blocks)
from repro_torch.models import is_recurrent
from repro_torch.telemetry.metrics import RequestTiming
from repro_torch.telemetry.registry import MetricsRegistry

CACHE_MODES = ("contiguous", "paged")
OFFLOAD_MODES = ("none", "host")
PREFIX_LEN = 8      # prompt tokens hashed to find a prefix-sharing donor


@dataclass
class Request:
    """One serving request: prompt in, greedy continuation out."""

    rid: int
    prompt: list
    max_new_tokens: int = 16
    arrival_s: float = 0.0         # offset on the engine clock (open loop)
    generated: list = field(default_factory=list)
    done: bool = False
    status: str = "queued"         # queued|active|preempted|done|rejected


@dataclass
class _PrefillTask:
    """One in-flight (chunked) prefill: tokens left to write into the
    paged cache for a slot.  ``replay=True`` rebuilds KV for a preempted
    request (prompt + already-emitted tokens) without emitting anything."""
    req: Request
    slot: int
    toks: list
    pos: int = 0                   # tokens already written
    replay: bool = False
    last_logits: Optional[torch.Tensor] = None


class EngineStats:
    """Serving counters as a derived view of a ``MetricsRegistry``.

    Scalar fields live in registry gauges (attribute reads pull the gauge,
    assignments and ``+=`` write it); series and per-request timings are
    plain attributes.  The field set is the reference's, restricted to what
    the port's plans fill, plus the hand-written kernels' launch counts.
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
        "decode_dispatches": ("engine_decode_dispatches", int,
                              "host dispatches issued by decode steps"),
        "fused_dispatches": ("engine_fused_dispatches", int,
                             "decode dispatches that ran fused kernels"),
        "modeled_tklqt_s": ("engine_modeled_tklqt_seconds", float,
                            "device-model TKLQT summed over steps "
                            "(0 under plan=jit: nothing modeled)"),
        "rejected": ("engine_rejected", int,
                     "admissions refused: plen + budget > max_len"),
        "prefill_kernel_launches": ("engine_prefill_kernel_launches", int,
                                    "hand-written kernel launches in "
                                    "prefills"),
        # ---- paged KV cache (cache="paged"; zero under contiguous)
        "preemptions": ("engine_preemptions", int,
                        "slots evicted under block-pool pressure"),
        "prefill_chunks": ("engine_prefill_chunks", int,
                           "chunked-prefill segments executed"),
        "offload_bytes": ("engine_offload_bytes", int,
                          "measured KV bytes evicted to the host tier"),
        "restore_bytes": ("engine_restore_bytes", int,
                          "measured KV bytes restored from the host tier"),
        "offload_transfers": ("engine_offload_transfers", int,
                              "block DMAs (evict + restore directions)"),
        "modeled_offload_tax_s": ("engine_modeled_offload_tax_seconds",
                                  float,
                                  "offload DMAs priced over the coupling "
                                  "link (core.device_model PCIe/C2C)"),
        # ---- prefix sharing (share_prefix=True; zero otherwise)
        "prefix_adoptions": ("engine_prefix_adoptions", int,
                             "admissions that adopted shared prefix blocks"),
        "shared_prefix_tokens": ("engine_shared_prefix_tokens", int,
                                 "prompt tokens served from shared blocks "
                                 "instead of re-prefilling"),
    }

    def __init__(self, plan: str = "jit", registry=None):
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
        self.rule_hits = {}            # fusion rule name -> launches
        self.block_pool_utilization = []  # per paged decode step
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
    def mean_block_pool_utilization(self) -> float:
        """Mean paged block-pool occupancy across sampled steps."""
        u = self.block_pool_utilization
        return sum(u) / len(u) if u else 0.0

    @property
    def peak_block_pool_utilization(self) -> float:
        """Peak paged block-pool occupancy across sampled steps."""
        return max(self.block_pool_utilization, default=0.0)

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
    def dispatches_per_decode_step(self) -> float:
        """Host dispatches per decode step (1 under jit: one replay)."""
        return (self.decode_dispatches / self.decode_steps
                if self.decode_steps else 0.0)

    @property
    def fused_dispatches_per_decode_step(self) -> float:
        """Mean fused-kernel launches per decode step."""
        return (self.fused_dispatches / self.decode_steps
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
    ``platform`` names the paper's platform row whose host link prices the
    offload tier: the default ``"Intel+H100"`` is an LC part (PCIe), as the
    H100 SXM's host link is.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256, plan: str = "jit", device="cuda",
                 platform: str = "Intel+H100", plan_table=None, tp: int = 1,
                 cache: str = "contiguous", block_size: int = 16,
                 num_blocks: Optional[int] = None, offload: str = "none",
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: str = "bf16", share_prefix: bool = False,
                 speculative: bool = False,
                 monitor=None, tracer=None):
        unported = [name for name, asked in (
            ("plan_table", plan_table is not None),
            ("speculative", bool(speculative)),
            ("monitor", bool(monitor)),
            ("tracer", tracer is not None)) if asked]
        if unported:
            raise ValueError(f"{', '.join(unported)} {NOT_PORTED}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch} "
                             "(an engine with no slots can never admit)")
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}; expected one "
                             f"of {sorted(PLATFORMS)}")
        if cache not in CACHE_MODES:
            raise ValueError(f"unknown cache {cache!r}; "
                             f"expected one of {CACHE_MODES}")
        if offload not in OFFLOAD_MODES:
            raise ValueError(f"unknown offload {offload!r}; "
                             f"expected one of {OFFLOAD_MODES}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if cache != "paged" and (offload != "none"
                                 or prefill_chunk is not None):
            raise ValueError(
                "offload= and prefill_chunk= need cache='paged' (the "
                "contiguous cache has no blocks to evict or chunk over)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                             f"expected one of {KV_DTYPES}")
        if cache != "paged" and (kv_dtype != "bf16" or share_prefix):
            raise ValueError(
                "kv_dtype= and share_prefix= need cache='paged' (the "
                "contiguous cache has no pages to quantize or share)")
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.T = max_len
        self.cache_mode = cache
        self.recurrent = is_recurrent(cfg)
        # prefill exactly the prompt: no pad token may enter a recurrence or
        # an encoder's non-causal attention
        self.exact_prefill = self.recurrent or cfg.family == "encoder"
        self.prefill_chunk = prefill_chunk
        self.platform = platform
        self.backend = make_backend(cfg, params, max_batch=max_batch,
                                    max_len=max_len, tp=tp, plan=plan,
                                    device=device, platform=platform)
        self.plan = self.plan_label = self.backend.plan
        self.tp = self.backend.info.tp
        self.kv_dtype = kv_dtype
        self.share_prefix = bool(share_prefix)
        if cache == "paged":
            # default pool sized by BYTES: a quantized pool holds the same
            # byte budget as the full-capacity pool, in more blocks
            nb = default_num_blocks(max_batch, max_len, block_size,
                                    num_blocks, kv_dtype=kv_dtype,
                                    hd=cfg.hd,
                                    payload_bytes=torch.empty(
                                        (), dtype=cfg.cdtype).element_size())
            self.kv = PagedKVCache(cfg, num_blocks=nb,
                                   block_size=block_size, max_len=max_len,
                                   dtype=cfg.cdtype, kv_dtype=kv_dtype,
                                   device=self.backend.device)
            self.cache = self.backend.init_paged_cache(self.kv)
            self.offload_tier = (HostOffloadTier(platform)
                                 if offload == "host" else None)
        else:
            self.kv = None
            self.offload_tier = None
            self.cache = self.backend.init_contiguous_cache()
        # prefix-sharing donor registry: prompt-prefix key -> [(donor rid,
        # donor's token sequence, tokens with fully written blocks)]
        self._prefix_donors: dict = {}
        self._prefill_tasks: dict = {}      # slot -> _PrefillTask
        self._preempted: list = []          # evicted Requests awaiting resume
        self._pending: list = []            # submitted, not yet admitted
        self._admit_seq = 0                 # victim ordering (youngest first)
        self._last_step_progressed = True
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
            self.stats.decode_dispatches += acct.dispatches
            self.stats.fused_dispatches += len(acct.rule_names)
            by = self.stats.decode_launches_by_kernel
            for name, c in acct.kernel_launches.items():
                by[name] = by.get(name, 0) + c
        else:
            self.stats.prefill_kernel_launches += sum(
                acct.kernel_launches.values())
        self.stats.measured_dispatch_s += acct.host_time_s
        self.stats.modeled_tklqt_s += acct.modeled_tklqt_s
        for nm in acct.rule_names:
            self.stats.rule_hits[nm] = self.stats.rule_hits.get(nm, 0) + 1

    def _bind_telemetry(self) -> None:
        reg = self.registry
        self.backend.bind_metrics(reg)
        if self.kv is not None:
            self.kv.pool.bind_metrics(reg)
        if self.offload_tier is not None:
            self.offload_tier.bind_metrics(reg)
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
        if self.cache_mode == "paged":
            return self._admit_paged(req)
        slot = self._free_slot()
        if slot is None:
            return False
        width = plen if self.exact_prefill else self._bucket(plen)
        toks = np.zeros((1, width), np.int32)
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

    # ------------------------------------------------------------ paged api
    def _admit_paged(self, req: Request) -> bool:
        """Paged-cache admission: start a (chunked) prefill, or restore or
        replay a preempted request's KV.  False = no slot (or, for a
        restore, no blocks yet)."""
        slot = self._free_slot()
        if slot is None:
            return False
        resume = getattr(req, "_resume", None)
        if resume is not None and resume[0] == "host":
            return self._restore_from_host(req, slot, resume[1])
        toks = list(req.prompt)
        replay = False
        if resume is not None:
            # recompute-on-resume: re-prefill the prompt plus everything
            # emitted EXCEPT the last token, which is the next decode
            # step's input; a request preempted mid-prefill has emitted
            # nothing and re-prefills normally
            toks = list(req.prompt) + list(req.generated[:-1])
            replay = len(req.generated) > 0
        req._resume = None
        req.status = "active"
        req._admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = req
        self.lengths[slot] = 0
        # prefix sharing: map a donor's leading full blocks with the same
        # token prefix into this request's table and start past them
        shared = self._adopt_prefix(req, toks) if self.share_prefix else 0
        self._prefill_tasks[slot] = _PrefillTask(
            req=req, slot=slot, toks=toks, pos=shared, replay=replay)
        return True

    # bound on live donor candidates tracked per prefix key
    _DONORS_PER_KEY = 4

    def _register_donor(self, key, rid: int, toks, written: int) -> None:
        """Add/refresh a donor candidate for ``key``; ``written`` caps how
        many of ``toks`` have fully-written KV blocks."""
        cands = self._prefix_donors.setdefault(key, [])
        cands[:] = [c for c in cands if c[0] != rid]
        cands.insert(0, (rid, tuple(toks), written))
        del cands[self._DONORS_PER_KEY:]

    def _adopt_prefix(self, req: Request, toks: list) -> int:
        """Adopt a donor's leading blocks when its token sequence shares a
        block-aligned prefix with ``toks``.  Only FULL blocks strictly
        inside the prompt are shared (the final prompt token is re-written
        so its logits exist).  Returns the prompt tokens covered."""
        if len(toks) < PREFIX_LEN:
            return 0
        key = tuple(toks[:PREFIX_LEN])
        cands = self._prefix_donors.get(key)
        if not cands:
            return 0
        bs = self.kv.block_size
        shared, live = 0, []
        for drid, dtoks, written in cands:
            if drid == req.rid:
                continue
            dblocks = self.kv.pool.owned(drid)
            if not dblocks:
                continue               # donor drained: prune this candidate
            live.append((drid, dtoks, written))
            if shared:
                continue               # already adopted from a fresher donor
            common = 0
            for a, b in zip(dtoks, toks):
                if a != b:
                    break
                common += 1
            common = min(common, written)
            n = min(min(common, len(toks) - 1) // bs, len(dblocks))
            if n <= 0:
                continue
            self.kv.pool.adopt(req.rid, dblocks[:n])
            self.stats.prefix_adoptions += 1
            self.stats.shared_prefix_tokens += n * bs
            shared = n * bs
        if live:
            self._prefix_donors[key] = live
        else:
            self._prefix_donors.pop(key, None)
        if shared:
            # the adopter holds fully-written shared blocks, so it can
            # donate them before its own prefill finishes
            self._register_donor(key, req.rid, toks, shared)
        return shared

    def _cow_protect(self, rid, start: int, end: int) -> bool:
        """Copy-on-write guard: before a write into token range
        ``[start, end)``, diverge any covering block that is still shared.
        False = no free block for the copy; the caller stalls."""
        if not self.share_prefix:
            return True
        pool = self.kv.pool
        ids = pool.owned(rid)
        if not ids:
            return True
        bs = self.kv.block_size
        first = start // bs
        last = min((max(end, start + 1) - 1) // bs, len(ids) - 1)
        for j in range(first, last + 1):
            if pool.ref_count(ids[j]) > 1:
                try:
                    old, new = pool.cow(rid, j)
                except MemoryError:
                    return False
                self.cache = self.kv.copy_pages(self.cache, old, new)
        return True

    def _restore_from_host(self, req: Request, slot: int,
                           entries: int) -> bool:
        """Re-admit an offloaded request by copying its pinned host pages
        into fresh pool pages; False = pool still too full."""
        tier = self.offload_tier
        if not self.kv.pool.can_alloc(tier.stored_blocks(req.rid)):
            return False                   # wait for blocks to free
        host, n_blocks, nbytes, tax = tier.restore(req.rid)
        ids = self.kv.pool.alloc(req.rid, n_blocks)
        self.cache = self.kv.scatter_host(
            self.cache, ids, host,
            timer=tier.copy_timer(self.backend.device))
        self.stats.restore_bytes += nbytes
        self.stats.offload_transfers += max(n_blocks, 1)
        self.stats.modeled_offload_tax_s += tax
        req._resume = None
        req.status = "active"
        req._admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = req
        self.lengths[slot] = entries
        return True

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Youngest decode-phase slot (latest admitted); when every other
        slot is still prefilling, the youngest in-flight prefill (its
        partial KV is discarded, not offloaded)."""
        decode = [i for i, s in enumerate(self.slots)
                  if s is not None and i != exclude
                  and i not in self._prefill_tasks]
        if decode:
            return max(decode, key=lambda i: self.slots[i]._admit_seq)
        prefills = [i for i in self._prefill_tasks
                    if i != exclude and self.slots[i] is not None]
        if prefills:
            return max(prefills, key=lambda i: self.slots[i]._admit_seq)
        return None

    def _preempt(self, slot: int) -> None:
        """Evict a slot's request: offload its KV to pinned host memory
        (or discard it for recompute-on-resume) and free its blocks."""
        req = self.slots[slot]
        entries = int(self.lengths[slot])
        ids = self.kv.pool.owned(req.rid)
        mid_prefill = self._prefill_tasks.pop(slot, None) is not None
        tier = self.offload_tier
        if tier is not None and not mid_prefill:
            host = self.kv.gather_host(
                self.cache, ids, timer=tier.copy_timer(self.backend.device))
            nbytes, tax = tier.evict(req.rid, host, len(ids))
            self.stats.offload_bytes += nbytes
            self.stats.offload_transfers += max(len(ids), 1)
            self.stats.modeled_offload_tax_s += tax
            req._resume = ("host", entries)
        else:
            req._resume = ("recompute", None)
        freed = self.kv.pool.free(req.rid)
        self.cache = self.kv.zero_pages(self.cache, freed)
        self.slots[slot] = None
        self.lengths[slot] = 0
        req.status = "preempted"
        self._preempted.append(req)
        self.stats.preemptions += 1

    def _ensure_paged_blocks(self, req: Request, n_tokens: int,
                             exclude: int) -> bool:
        """Grow ``req`` to cover ``n_tokens`` KV entries, preempting
        youngest-first victims while the pool is short (evict-or-preempt).
        False = stalled: no victim available, caller retries next step."""
        pool = self.kv.pool
        while (pool.blocks_for(n_tokens) - len(pool.owned(req.rid))
               > pool.free_blocks):
            victim = self._pick_victim(exclude)
            if victim is None:
                return False
            self._preempt(victim)
        pool.ensure(req.rid, n_tokens)
        return True

    def _release_slot(self, slot: int, req: Request) -> None:
        """Free a finished request's slot, blocks, and host staging."""
        self.slots[slot] = None
        self.lengths[slot] = 0
        freed = self.kv.pool.free(req.rid)
        self.cache = self.kv.zero_pages(self.cache, freed)
        if self.offload_tier is not None:
            self.offload_tier.drop(req.rid)

    def _run_prefill_chunk(self, task: _PrefillTask, chunk_len: int) -> None:
        """Write the next ``chunk_len`` prompt tokens of one in-flight
        prefill into the paged cache (one backend call)."""
        toks = np.asarray([task.toks[task.pos:task.pos + chunk_len]],
                          np.int32)
        bt = self.kv.table_row(task.req.rid)
        t_start = time.perf_counter()
        logits, self.cache = self.backend.prefill_chunk(
            self.cache, torch.from_numpy(toks), bt, task.pos)
        self._absorb(self.backend.last, decode=False)
        task.last_logits = logits
        task.pos += chunk_len
        self.stats.prefill_chunks += 1
        self.now += time.perf_counter() - t_start

    def _finish_prefill(self, task: _PrefillTask) -> None:
        """Complete a chunked prefill: emit the first token (or nothing
        on a replay) and move the slot into decode."""
        req, slot = task.req, task.slot
        del self._prefill_tasks[slot]
        self.lengths[slot] = len(task.toks)
        if self.share_prefix and len(task.toks) >= PREFIX_LEN:
            # the newest finished prefill becomes the freshest donor
            self._register_donor(tuple(task.toks[:PREFIX_LEN]),
                                 req.rid, task.toks, len(task.toks))
        if task.replay:
            return          # resumed recompute: KV rebuilt, nothing emitted
        first = self._sample(task.last_logits[0])
        req.generated.append(first)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        timing = self._note_first_token(req)
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.status = "done"
            timing.done_s = self.now
            self._release_slot(slot, req)

    def _advance_prefills(self) -> bool:
        """One chunk of every in-flight prefill, interleaved with decode."""
        progressed = False
        for slot in sorted(self._prefill_tasks):
            task = self._prefill_tasks.get(slot)
            if task is None:        # finished earlier in this sweep
                continue
            remaining = len(task.toks) - task.pos
            chunk_len = (remaining if self.prefill_chunk is None
                         else min(self.prefill_chunk, remaining))
            if not self._ensure_paged_blocks(
                    task.req, task.pos + chunk_len, exclude=slot):
                continue            # stalled on blocks; retry next step
            if not self._cow_protect(task.req.rid, task.pos,
                                     task.pos + chunk_len):
                continue            # stalled on a CoW copy block
            self._run_prefill_chunk(task, chunk_len)
            progressed = True
            if task.pos >= len(task.toks):
                self._finish_prefill(task)
        return progressed

    def _paged_decode_step(self) -> bool:
        """One paged decode round: grow block tables (preempting if the
        pool is exhausted) and step the ready rows.  False when nothing
        could progress."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefill_tasks]
        # grow every row's table to cover the entry this step writes;
        # growth may preempt younger rows out of this very step
        stalled = set()
        for i in active:
            if self.slots[i] is None:
                continue
            if not self._ensure_paged_blocks(
                    self.slots[i], int(self.lengths[i]) + 1, exclude=i):
                # no victim now (in-flight prefills hold the rest): sit
                # this step out; a true deadlock is raised by tick()
                stalled.add(i)
            elif not self._cow_protect(self.slots[i].rid,
                                       int(self.lengths[i]),
                                       int(self.lengths[i]) + 1):
                stalled.add(i)
        active = [i for i in active
                  if self.slots[i] is not None and i not in stalled]
        if not active:
            return False
        toks = np.zeros((self.B, 1), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].generated[-1]
        owners = [self.slots[i].rid
                  if self.slots[i] is not None
                  and i not in self._prefill_tasks else None
                  for i in range(self.B)]
        bt = self.kv.block_tables(owners)
        t0 = time.perf_counter()
        logits, self.cache = self.backend.paged_decode(
            self.cache, torch.from_numpy(toks), self.lengths.copy(), bt)
        self._absorb(self.backend.last, decode=True)
        self.stats.decode_steps += 1
        self.stats.slot_occupancy.append(len(active))
        self.stats.block_pool_utilization.append(self.kv.pool.utilization)
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
                if timing is not None:
                    timing.done_s = self.now
                self._release_slot(i, req)
        return True

    def step(self) -> None:
        """One decode step for all active slots (paged: after one chunk of
        every in-flight prefill)."""
        if self.cache_mode == "paged":
            progressed = self._advance_prefills()
            progressed = self._paged_decode_step() or progressed
            self._last_step_progressed = progressed
            return
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
        """True while any work remains: queued, preempted, or in a slot."""
        return bool(self._pending) or bool(self._preempted) or \
            any(s is not None for s in self.slots)

    @property
    def queue_depth(self) -> int:
        """Requests admitted-or-waiting on this engine (pending +
        preempted + active slots)."""
        return (len(self._pending) + len(self._preempted)
                + sum(1 for s in self.slots if s is not None))

    def tick(self) -> bool:
        """One scheduling round: fast-forward over an idle gap, admit every
        eligible request (resumed ones first: they hold generation progress
        and possibly offloaded KV), then one ``step()``.  False once no
        work remains."""
        if not self.busy:
            return False
        idle = not any(s is not None for s in self.slots) \
            and not self._preempted
        if idle and self._pending and self._pending[0].arrival_s > self.now:
            self.now = self._pending[0].arrival_s
        admitted = False
        while self._preempted and self._free_slot() is not None:
            if not self._admit_paged(self._preempted[0]):
                break               # no blocks to restore into yet
            self._preempted.pop(0)
            admitted = True
        while (self._pending and self._pending[0].arrival_s <= self.now
               and self._free_slot() is not None):
            if not self.admit(self._pending[0]):
                break
            self._pending.pop(0)
            admitted = True
        self.step()
        if self.cache_mode == "paged" and not admitted \
                and not self._last_step_progressed \
                and (self._preempted
                     or any(s is not None for s in self.slots)):
            # nothing ran and nothing was admitted: no future step can
            # free blocks either; the pool cannot hold this workload
            raise RuntimeError(
                "paged engine deadlocked: block pool "
                f"({self.kv.num_blocks} x {self.kv.block_size} tokens) "
                "too small for even one in-flight request; raise "
                "num_blocks")
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
        if self.cache_mode == "paged":
            self.kv.reset()
            self._prefill_tasks = {}
            self._preempted = []
            self._admit_seq = 0
            self._prefix_donors = {}
            if self.offload_tier is not None:
                self.offload_tier.clear()
        self._bind_telemetry()
