"""Proximity-score kernel-fusion mining (paper §III-C, Eqs. 6-8).

Copy of ``repro/core/proximity.py``; the sequence is a trace's aten op
names (``core.tracing.Trace.kernel_names``).

PS(C) = f(C) / f(k_i): the likelihood that executing kernel k_i is followed
by exactly the chain C of length L.  PS == 1 chains are deterministic
patterns — ideal fusion candidates.  The idealized speedup from pure
launch-count reduction:

    K_fused  = K_eager - C_fused * (L - 1)        (Eq. 7)
    speedup  = K_eager / K_fused                  (Eq. 8)
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ChainStats:
    chain: tuple                   # kernel-name tuple, len L
    frequency: int                 # f(C)
    first_frequency: int           # f(k_i)

    @property
    def ps(self) -> float:         # Eq. 6
        return self.frequency / self.first_frequency


@dataclass
class MiningResult:
    length: int
    candidates: list               # all chains with PS >= threshold
    deterministic: list            # PS == 1 chains
    n_unique: int
    n_instances: int               # total occurrences of candidates
    k_eager: int
    c_fused: int                   # non-overlapping deterministic fusions
    k_fused: int                   # Eq. 7
    speedup: float                 # Eq. 8


def mine_chains(seq: Sequence[str], length: int,
                threshold: float = 1.0) -> MiningResult:
    """Mine chains of a given length from one kernel-name sequence.

    Degenerate cases are explicit: a sequence shorter than ``length`` (or
    empty, or ``length < 2``) has no mineable chains — every kernel stays
    an eager launch and the speedup is exactly 1.0, never a division by a
    zero/garbage ``k_fused``.
    """
    n = len(seq)
    if n == 0 or length < 2 or length > n:
        return MiningResult(length, [], [], 0, 0, n, 0, n, 1.0)
    first = Counter(seq)
    chains = Counter()
    for i in range(n - length + 1):
        chains[tuple(seq[i:i + length])] += 1

    cands = []
    for c, f in chains.items():
        st = ChainStats(c, f, first[c[0]])
        if st.ps >= threshold:
            cands.append(st)
    det = [c for c in cands if c.ps >= 1.0]

    # greedy non-overlapping cover with deterministic chains
    det_set = {c.chain for c in det}
    c_fused = 0
    i = 0
    while i <= n - length:
        if tuple(seq[i:i + length]) in det_set:
            c_fused += 1
            i += length
        else:
            i += 1
    k_eager = n
    k_fused = k_eager - c_fused * (length - 1)                 # Eq. 7
    speedup = k_eager / k_fused if k_fused > 0 else float("inf")  # Eq. 8
    return MiningResult(length, cands, det, len(cands),
                        sum(c.frequency for c in cands), k_eager,
                        c_fused, k_fused, speedup)


def fusion_segments(seq: Sequence[str], length: int,
                    mining: "MiningResult | None" = None) -> list[list[int]]:
    """Segment the kernel sequence for the chain-jit engine: greedy
    non-overlapping deterministic chains become multi-eqn segments, the rest
    stay singleton (eager).  Pass a precomputed ``mining`` result (for the
    same seq/length at threshold 1.0) to skip re-mining."""
    res = mining or mine_chains(seq, length, threshold=1.0)
    det = {c.chain for c in res.deterministic}
    segs, i, n = [], 0, len(seq)
    while i < n:
        if i <= n - length and tuple(seq[i:i + length]) in det:
            segs.append(list(range(i, i + length)))
            i += length
        else:
            segs.append([i])
            i += 1
    return segs


def sweep_lengths(seq: Sequence[str], lengths=(2, 4, 8, 16, 32, 64, 128, 256),
                  threshold: float = 1.0) -> list[MiningResult]:
    return [mine_chains(seq, L, threshold) for L in lengths
            if L <= max(len(seq), 1)]
