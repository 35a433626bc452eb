"""Roofline terms of one rank's step, from the dry run's counts.

Counterpart of ``repro/launch/roofline.py``'s ``model_flops``,
``ideal_times`` and ``Roofline`` (its ``to_dict()`` keys, ``dominant``,
``step_time``, ``useful_flops_frac``, ``roofline_frac``).  The reference
parses the compiled TPU HLO for its counts; the port takes them from the
traced rank body (``distributed.dry``): FLOPs and HBM bytes per aten op by
``core/costs.py``'s rules and each hand-written kernel's own ``costs``,
and the collectives' operand bytes, count and kind from the dry rank's
record.  Wire bytes follow the reference's ring model: an all-reduce
moves 2(p-1)/p of its operand, an all-gather (p-1)/p of its result, an
all-to-all (p-1)/p of its operand, a send its operand.

The machine is the card's data sheet (NVIDIA H100 SXM5 80 GB), not a
measurement: 989 TFLOP/s dense bf16 on the tensor cores (the rate
``core/device_model.py`` prices the GH200's H100 at), 67 TFLOP/s f32
(``PERF.md`` section 6), 3.35 TB/s HBM3.  The link: NVLink 4 at 450 GB/s
a direction for a group whose ranks all sit in one node of 8 GPUs, and
50 GB/s a GPU (one 400 Gb/s NIC) for a group that spans nodes.  Ranks
fill nodes in rank order, so on the production meshes every group spans
nodes.  The counts are per rank; ``model_flops_total`` is the whole
step's, over all ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_FLOPS_BF16 = 989e12          # a card, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12            # a card, f32
HBM_BW = 3.35e12                  # bytes/s a card
NVLINK_BW = 450e9                 # bytes/s a direction, inside a node
NET_BW = 50e9                     # bytes/s a GPU, across nodes
NODE_GPUS = 8
HBM_BYTES = 80e9                  # the card's memory

KIND_NAMES = {"all-reduce": "all-reduce", "all-gather": "all-gather",
              "all-to-all": "all-to-all", "send": "collective-permute",
              "broadcast": "broadcast"}


def wire_bytes(kind: str, nbytes: float, p: int) -> float:
    """Bytes a rank puts on the wire for one collective of ``nbytes``
    operand bytes over ``p`` ranks (ring model)."""
    if kind == "all-reduce":
        return 2 * nbytes * (p - 1) / max(p, 1)
    if kind == "all-gather":
        return nbytes * p * (p - 1) / max(p, 1)
    if kind == "all-to-all":
        return nbytes * (p - 1) / max(p, 1)
    return float(nbytes)


def group_in_node(mesh, axes) -> bool:
    """True when the group of rank 0 over ``axes`` lies in one node (its
    ranks, rank-major over the mesh's axes, share ``rank // 8``)."""
    strides, s = {}, 1
    for a in reversed(tuple(mesh.shape)):
        strides[a] = s
        s *= mesh.shape[a]
    span = sum((mesh.shape[a] - 1) * strides[a] for a in axes)
    return span < NODE_GPUS


def link_bw(mesh, axes) -> float:
    return NVLINK_BW if group_in_node(mesh, axes) else NET_BW


def ideal_times(kind: str, model_flops_total: float, params_bytes: float,
                cache_bytes: float, io_bytes: float, n_chips: int):
    """Lower-bound step times: compute term = useful model flops at peak;
    memory term = unavoidable HBM traffic (params re-read per pass -- 3x
    for train fwd/bwd, 1x otherwise -- plus KV cache and batch IO)."""
    t_c = model_flops_total / n_chips / PEAK_FLOPS_BF16
    passes = 3.0 if kind == "train" else 1.0
    min_bytes = params_bytes * passes + cache_bytes + io_bytes
    t_m = min_bytes / n_chips / HBM_BW
    return t_c, t_m


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    wire_bytes: float
    coll_count: int
    coll_by_kind: dict
    raw_cost_flops: float
    raw_cost_bytes: float
    model_flops_total: float          # 6*N*D (active) whole-step, all chips
    n_chips: int
    f32_flops: float = 0.0            # of ``flops``, at the f32 rate
    t_wire: float = 0.0               # the collectives' wire time

    @property
    def t_compute(self):
        return ((self.flops - self.f32_flops) / PEAK_FLOPS_BF16
                + self.f32_flops / PEAK_FLOPS_F32)

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.t_wire

    @property
    def dominant(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self):
        # optimistic overlap model: terms hide behind the max
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self):
        """MODEL_FLOPS / counted FLOPs (per chip)."""
        per_chip_model = self.model_flops_total / self.n_chips
        return per_chip_model / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self):
        """Useful model flops per chip over (step_time * bf16 peak)."""
        per_chip_model = self.model_flops_total / self.n_chips
        denom = self.step_time * PEAK_FLOPS_BF16
        return per_chip_model / denom if denom else 0.0

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "wire_bytes": self.wire_bytes,
            "coll_count": self.coll_count,
            "coll_by_kind": dict(self.coll_by_kind),
            "raw_cost_flops": self.raw_cost_flops,
            "raw_cost_bytes": self.raw_cost_bytes,
            "model_flops_total": self.model_flops_total,
            "n_chips": self.n_chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "step_time": self.step_time,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops(cfg, shape, n_active_params: int,
                n_embed_params: int) -> float:
    """6*N*D convention.  N = active non-embedding params + embedding
    matmul (unembed) treated as params once; D = tokens processed in the
    step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 3  # fwd + bwd(2x)
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 1
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 1
    n = n_active_params + n_embed_params
    return 2.0 * n * tokens * mult  # 2*N*D per fwd; x3 for train = 6*N*D


def build_roofline(recorder, calls, mesh, *, model_flops_total: float
                   ) -> Roofline:
    """The roofline of one rank's traced body: ``recorder`` its
    ``distributed.dry.OpRecorder``, ``calls`` its collectives (kind,
    bytes, group size, axes)."""
    by_kind: dict = {}
    coll_bytes = wire = t_wire = 0.0
    for kind, nbytes, p, axes in calls:
        name = KIND_NAMES.get(kind, kind)
        by_kind[name] = by_kind.get(name, 0.0) + nbytes
        coll_bytes += nbytes
        w = wire_bytes(kind, nbytes, p)
        wire += w
        t_wire += w / link_bw(mesh, axes)
    flops = recorder.flops["lowp"] + recorder.flops["f32"]
    return Roofline(
        flops=flops, hbm_bytes=recorder.bytes, coll_bytes=coll_bytes,
        wire_bytes=wire, coll_count=len(calls), coll_by_kind=by_kind,
        raw_cost_flops=flops, raw_cost_bytes=recorder.bytes,
        model_flops_total=model_flops_total,
        n_chips=math.prod(mesh.shape.values()),
        f32_flops=recorder.flops["f32"], t_wire=t_wire)
