"""Single-device execution backend: the step bodies under PyTorch eager.

Counterpart of ``repro/inference/backends/local.py`` for the contiguous
and the paged cache (speculative verify is not ported yet, ROADMAP Queue A,
"speculative decoding").  Every call runs the step body eagerly (plan label
``"eager"``): the reference's ``jit`` and launch-plan modes are not ported
yet (ROADMAP Queue A, "CUDA graph / launch plans"), and this backend does
not pretend to be either.  Each call's host time is measured around the
call without a device sync, as the reference measures its jit dispatch,
and the launches of the hand-written kernels in the call are read from
the wrappers' counts.
"""
from __future__ import annotations

import time

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.inference.backends.base import (AccountingMixin,
                                                 BackendInfo, CallAccount)
from repro_torch.inference.backends.bodies import make_step_bodies
from repro_torch.models import make_cache

NOT_PORTED = "not ported yet, see ROADMAP Queue A"


class LocalBackend(AccountingMixin):
    """One device, eager execution."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int,
                 max_len: int, plan: str = "eager", device="cuda"):
        if plan != "eager":
            raise ValueError(f"plan {plan!r} {NOT_PORTED}, \"CUDA graph / "
                             "launch plans\" (the port runs eager PyTorch)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"backend device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.T = max_len
        self.plan = plan
        self.info = BackendInfo(kind="local", tp=1,
                                devices=(str(self.device),))
        self._init_accounting()
        self._bodies = make_step_bodies(cfg)

    def init_contiguous_cache(self):
        """Fresh per-slot contiguous KV cache on this device."""
        return make_cache(self.cfg, self.B, self.T, device=self.device)

    def init_paged_cache(self, kv):
        """Fresh pooled KV pages for a ``PagedKVCache`` geometry (built for
        this backend's device)."""
        return kv.make_pages()

    def _run(self, body, *args):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out = body(self.params, *args)
        host = time.perf_counter() - t0
        after = kernels.launch_counts()
        self._charge(CallAccount(
            host_time_s=host,
            kernel_launches={k: after[k] - before[k] for k in after}))
        return out

    def prefill(self, cache, tokens, slot: int, plen: int):
        """Write one prompt into a slot; (last-position logits, cache)."""
        return self._run(self._bodies.prefill, cache, tokens, slot, plen)

    def decode(self, cache, tokens, lengths):
        """One batched decode step; ``lengths`` a host array."""
        return self._run(self._bodies.decode, cache, tokens, lengths)

    def prefill_chunk(self, cache, tokens, bt_row, t0):
        """Write one prompt chunk into the paged pool through the slot's
        block-table row (host array); (last-position logits, cache)."""
        return self._run(self._bodies.paged_prefill, cache, tokens, bt_row,
                         int(t0))

    def paged_decode(self, cache, tokens, lengths, block_tables):
        """One batched decode step over the paged pool; ``lengths`` and
        ``block_tables`` host arrays."""
        return self._run(self._bodies.paged_decode, cache, tokens, lengths,
                         block_tables)

    def verify(self, cache, tokens, lengths):
        raise ValueError(f"speculative verify {NOT_PORTED}, \"speculative "
                         "decoding\"")

    def paged_verify(self, cache, tokens, lengths, block_tables):
        raise ValueError(f"speculative verify {NOT_PORTED}, \"speculative "
                         "decoding\"")

    @property
    def planned_decode(self):
        """No launch-plan mode runs here."""
        return None
