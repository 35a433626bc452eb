"""Multi-pod dry run: trace one rank of every (arch x shape x mesh) cell.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's jitted step over 256 or 512 forced host devices; the
port builds the cell's ``StepBundle`` (``launch.steps``) over the
production mesh (``launch.mesh.make_production_mesh``, every rank on the
meta device) and traces ONE rank's body, rank 0, the same code the ranks
run, on meta tensors (no byte is allocated; each kernel wrapper runs its
custom op's fake implementation, ``kernels.build.dry_trace``) with a dry
rank context (``distributed.dry``: its collectives return tensors of the
right shape and record what they move; no process group exists).
Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per cell it writes the reference's JSON record: ``memory``
(``argument_bytes``: the rank's input slices; ``output_bytes``: its
results; ``temp_bytes``: the peak of the live storages above the
arguments over the trace, forward and backward; ``alias_bytes``: the
results that are arguments updated in place), ``roofline``
(``launch.roofline``, from the trace's counts and the card's data-sheet
peaks), ``t_lower_s`` (the trace's seconds; ``t_compile_s`` is 0: nothing
is compiled), ``options``, and ``fits``: argument + temp + the outputs
that are not arguments within the card's 80 GB.  A cell that fails is
printed with its traceback and makes the run exit 1.
"""
import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, SHAPES, applicable_shapes, \
    get_config
from repro_torch.distributed.dry import OpRecorder, dry_context, host_scalars
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_BYTES, build_roofline, \
    model_flops
from repro_torch.launch.steps import StepOptions, build_step
from repro_torch.models import active_param_count


def embed_param_count(cfg) -> int:
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def trace_rank(bundle, rank: int = 0, like: str = "cuda") -> dict:
    """Rank ``rank``'s body of ``bundle`` traced dry, the kernels' outputs
    laid out as on a ``like`` device: {"recorder", "calls", "memory",
    "seconds"}."""
    inputs = tuple(host_scalars(x) for x in bundle.rank_specs(rank))
    ctx, log = dry_context(bundle.mesh, rank, device="meta")
    rec = OpRecorder(memory=True)
    # the inputs' own bytes (a cache leaf's hidden scratch row is in the
    # live storages, not in the arguments)
    arg_bytes = sum(t.numel() * t.element_size() for t in _tensors(inputs))
    rec.register_arguments(inputs)
    t0 = time.perf_counter()
    with build.dry_trace(like), rec:
        out = bundle.fn(ctx, *inputs)
    seconds = time.perf_counter() - t0
    seen, out_bytes, alias = set(), 0, 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        out_bytes += st.nbytes()
        if rec.is_argument(t):
            alias += st.nbytes()
    memory = {"argument_bytes": int(arg_bytes),
              "output_bytes": int(out_bytes),
              "temp_bytes": int(rec.peak_bytes),
              "alias_bytes": int(alias)}
    return {"recorder": rec, "calls": log.calls, "memory": memory,
            "seconds": seconds}


def fits(memory: dict) -> bool:
    """Arguments, the peak of temporaries and the new outputs within the
    card's memory."""
    need = memory["argument_bytes"] + memory["temp_bytes"] + \
        memory["output_bytes"] - memory["alias_bytes"]
    return need <= HBM_BYTES


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             options: StepOptions | None = None, out_dir: str | None = None,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    bundle = build_step(cfg, shape, mesh, options=options)
    tr = trace_rank(bundle)
    t_lower = time.time() - t0
    mem_d = tr["memory"]
    n_active = active_param_count(bundle.in_specs[0], cfg)
    mf = model_flops(cfg, shape, n_active, embed_param_count(cfg))
    roof = build_roofline(tr["recorder"], tr["calls"], mesh,
                          model_flops_total=mf)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "ok",
        "t_lower_s": round(t_lower, 2), "t_compile_s": 0.0,
        "memory": mem_d,
        "roofline": roof.to_dict(),
        # the reference's keys: its donate is the port's in-place update
        "options": None if options is None else {**options.__dict__,
                                                 "donate": True},
        "fits": fits(mem_d),
    }
    if verbose:
        r = rec["roofline"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] ok "
              f"trace={t_lower:.0f}s "
              f"tC={r['t_compute']*1e3:.2f}ms tM={r['t_memory']*1e3:.2f}ms "
              f"tX={r['t_collective']*1e3:.2f}ms dom={r['dominant']} "
              f"useful={r['useful_flops_frac']:.2f} "
              f"roofline={r['roofline_frac']:.3f} "
              f"temp={mem_d['temp_bytes']/1e9:.1f}GB "
              f"args={mem_d['argument_bytes']/1e9:.1f}GB "
              f"fits={rec['fits']}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape_name}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for sh in applicable_shapes(get_config(arch)):
                cells.append((arch, sh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch, sh in cells:
        for mp in meshes:
            tag = f"{arch}__{sh}__{'2x16x16' if mp else '16x16'}"
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, tag + ".json")):
                print(f"[{tag}] exists, skipping", flush=True)
                continue
            try:
                run_cell(arch, sh, multi_pod=mp, out_dir=args.out)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((tag, repr(e)))
                print(f"[{tag}] FAILED: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells ok")


if __name__ == "__main__":
    main()
