"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

  1. build the hand-written kernels from ``src/repro_torch/csrc`` with nvcc
     for sm_90a (no kernel may spill registers), and time an empty kernel's
     launch;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (SmolLM-360M, max_batch 4, max_len 128, 16-token prefill
     bucket; the norms at both the decode rows (4 x 1) and a slot's
     prefill rows (1 x 16)) in f32 and bf16, and time kernel, plain
     version and, where one PyTorch call computes the same function, that
     call.  The paged kernels run at the paged path's shapes (block size
     16, 8 blocks per row, a 32-page bf16 pool and a 60-page int8 pool,
     permuted pages and sentinel table entries), and the bf16 one is also
     held against the contiguous kernel on the same logical KV;
     ``flash_attention`` also at causal prefills of S = T = 128 and 1024
     (``[t128]``, ``[t1024]``), each beside SDPA; ``decode_attention`` and
     ``paged_decode_attention`` also over a 1024-position cache
     (``[t1024]``: lengths 1024/768/512/256, block 16, 64 blocks a row, the
     contiguous one beside SDPA with a mask); ``rmsnorm_matmul`` beside the
     unfused pair it replaces (``F.rms_norm`` then ``torch.matmul``).  At
     the new configs' shapes too (``dense_cases``): the three decode
     entries at Gemma-2's (32/16 heads of 128, window 16, softcap 50),
     Llama-3.2-1B's, InternLM2's and CodeQwen's decode shapes, and at
     ``[gemma2_t1024]`` (window 256) beside SDPA with the windowed mask;
     ``flash_attention`` non-causal at BERT's prefill (B 4, 12 heads of
     64, S = T = 512) beside SDPA; the norms at D 2048, 4096, 4608 and
     6144; the three multi-query entries of the speculative verify
     (``decode_attention_mq``, ``paged_decode_attention_mq``,
     ``paged_decode_attention_quant_mq``) at S = 2, 5 and 9 queries a
     row at SmolLM's decode shape, at S = 5 over ``[t1024]`` and at
     Gemma-2's window-and-softcap shape, the contiguous one beside SDPA
     with the per-query mask (timed in bf16);
  3. full-width SmolLM-360M logits in f32, kernels against plain
     versions, for a prefill and batched decode steps; then the paged
     path (a chunked prefill in chunks of 8 and the same decode steps)
     against the contiguous path, both through the kernels;
  4. the first main path: ``repro_torch.launch.serve`` serving full-width
     SmolLM-360M in bf16 on the contiguous cache (8 requests, max_batch
     4), with every kernel's launch count reset just before and read just
     after;
  5. a profiler trace of decode steps (device time by kernel, the
     hand-written kernels' time per step, host ops by self time), then of a
     slot's prefill (the hand-written kernels' time per prefill);
  6. the second main path: the same serve command with ``--cache paged
     --block-size 16``, the launches checked per decode step and per
     prefill chunk, then a trace of its decode step as in phase 5;
  7. the third: ``ServeEngine`` on full-width SmolLM-360M with an int8
     paged pool too small for the load (prefix sharing, chunked prefill,
     host offload), which must preempt, offload, restore and share and
     serve the tokens the same requests get from a pool that never
     preempts, then a trace of its decode step;
  8. full-width RWKV-6 3B logits in f32 (after the SmolLM engines are
     freed), kernels against plain versions, for a 12-token prefill and 3
     batched decode steps at batch 4;
  9. the fourth main path: ``repro_torch.launch.serve --arch rwkv6-3b`` in
     bf16 (wkv6 and the legacy rmsnorm kernel), launches checked per decode
     step and per prefill, served first tokens against the plain bf16
     forward; then an f32 engine at full width and 2 layers whose whole
     token streams must equal an unpadded incremental forward's (the
     engine prefills a recurrent stack without bucket padding);
 10. a trace of the RWKV-6 decode step and prefill, as in phase 5;
 11. the four main paths again under ``--plan jit`` (the serve default:
     each step one CUDA graph replay), each beside its ``--plan eager`` run
     above: the same tokens request for request except where the plain
     versions' logits of the two tokens lie within LOGIT_TOL_BF16 (eager
     runs the norms as their plain bf16 versions, other arithmetic; each
     such tie is printed), one dispatch per decode step, the path's
     launches per decode step and per prefill; then per cell and plan the
     decode step's wall, host and device-busy time, idle share, tok/s,
     TTFT, ITL and the graphs captured (count, seconds, pool memory).
     The launch counts of these runs (reset just before each, read just
     after) are the main paths' launches in the ``kernels`` line;
 12. the launch-plan runtime: SmolLM contiguous under ``whole_graph``,
     ``chain``, ``auto`` and ``fused``, and SmolLM paged bf16, int8 under
     pool pressure and RWKV-6 3B under ``auto`` and ``fused`` (8 requests,
     16 new tokens): per row the dispatches and hand-written launches per
     decode step and per prefill, the fused rule hits per call, the
     modeled TKLQT (``Intel+H100``), the decode step traced as in phase 5,
     tok/s, TTFT, ITL, the graphs and the trace (nodes, seconds).  Checks:
     ``fused`` tokens equal ``jit``'s request for request in every cell;
     rule hits per SmolLM call rmsnorm_matmul 32, residual_rmsnorm 32,
     rmsnorm 1 (RWKV-6: 2L+1 windows); launches per decode step equal
     under whole_graph, chain and auto; dispatches per decode step eager >
     chain >= auto >= whole_graph = 1, with chain = auto only where auto
     chose a chain.  Then the measured Eq. 1 timeline
     of one SmolLM contiguous decode step at batch 1, 2 and 4 under
     ``eager`` and ``fused``: ``KernelEvent``s from ``torch.profiler``,
     each kernel joined to the runtime call that launched it by its
     correlation id (a kernel of a graph replay takes the
     ``cudaGraphLaunch``; a profile whose clocks put a kernel before its
     call is discarded and taken again, up to 6 profiles; the median of
     the (up to two) kept, or "not measured" if none is left), fed to
     ``core.metrics.report`` (TKLQT, AKD, IL, GPU idle) beside the
     modeled TKLQT of the same trace, and
     ``core.boundedness.find_inflection`` over the measured eager curve;
 13. Llama-3.2-1B, the paper's headline model, at full width and depth
     (16 layers, random bf16 weights): f32 logits kernels against plain
     versions (a prefill and 3 decode steps); ``serve --arch llama-3.2-1b``
     under eager and jit on the contiguous cache and with ``--cache paged
     --block-size 16``, checked and traced as in phase 11 (launches per
     decode step 16 / 16 / 17, one dispatch under jit, jit's tokens
     against eager's); then ``--plan fused`` on the contiguous cache (its
     tokens equal jit's, rule hits 16 / 16 / 1 per call);
 14. the other six: InternLM2-20B, CodeQwen1.5-7B (qkv biases drawn
     non-zero) and Gemma-2-27B (one local, one global layer) at full
     width and 2 layers, GPT-2 at full depth: f32 logits kernels against
     plain versions (Gemma-2 also with its window cut to 8, so that it
     bites), then an engine under eager and jit, jit's tokens against
     eager's; BERT and XLM-R at full depth: one f32 non-causal forward of
     4 x 512 tokens, kernels against plain versions.  Each model is freed
     before the next is built;
 15. the measured characterization and the plan autotuner on Llama-3.2-1B
     at full width, its depth cut to CHAR_LAYERS = 2 of 16 (random bf16
     weights; deeper, the script nears its time limit with phase 18): (a)
     ``telemetry.characterize`` over the closed-loop ``code-completion``
     scenario (64 requests, seed 0, prompts capped at 64 tokens, outputs at
     8, ``max_len`` 256) at batches 1-64 under ``eager`` and ``jit``,
     printing each point's row (decode step, launch tax, dispatches,
     TTFT/ITL p50/p99, tok/s, occupancy), its classification and each
     plan's inflection batch; every point must emit the workload's tokens,
     and a jit point one dispatch a decode step; then, at each batch, a jit
     decode step split into what the engine clock counts: the graph
     replay's device time and the logits' copy to the host (the host
     argmax follows the clock's stop); (b) ``runtime.autotune``
     from the eager sweep at batches 1, 4 and 16 (``Intel+H100``): the
     saved plan table (each entry's region, candidates and pick), then the
     workload served at each batch under ``plan="autotuned"``, whose
     tokens must equal an engine's built with the picked plan by name;
     (c) ``memory_pressure_sweep`` on paged SmolLM-360M at full width,
     4 of its 32 layers (SWEEP_LAYERS; each page moves an eighth of the
     bytes of a whole model's) (64 uncapped ``code-completion`` requests on 32 slots, ``max_len``
     512, pages of 16; ``Intel+H100`` and ``GH200``, pools at 1.0 / 0.5 /
     0.33 of the no-pressure size, bf16 and int8 pages), each row beside
     the offload tier's measured copy time; a 0.33 pool must preempt; (d)
     the merged Chrome trace of one eager point and the workload JSONL
     written by ``launch.characterize.write_artifacts``, read back as strict
     JSON with matched flow pairs and as the same requests;
 16. speculative decoding (k = 4, ``plan="jit"``): (a) ``serve
     --speculative --spec-k 4`` of full-width SmolLM-360M in bf16 on the
     contiguous cache and the paged pool, and the int8 pool under phase
     7's pressure with host offload, each beside its phase 11 plain jit
     run: tokens (equal, or parting at a printed near tie), accept rate,
     steps per emitted token, rounds, draft dispatches, ms a token and a
     round beside plain jit's, graphs and pool MiB, launches a round
     (the target's verify on the cache's ``_mq`` entry and the draft's
     catch-up step on ``decode_attention_mq``, counted); (b) the three
     cells again with the shifted-unembed draft that the target rejects
     nearly every round: the paged cells must roll blocks back and keep
     their peak pool within two pages a row of plain's; then contiguous
     and paged bf16 on an aligned target (its layers past the draft's add
     nothing to the residual stream) beside a plain jit run of the same
     weights: the draft must be accepted in more than half the proposals,
     so the draft's catch-up step carries two real tokens; (c) an f32
     engine at full width and 2 layers (TF32 off): whole streams of
     both drafts on both caches equal to plain greedy's; (d)
     Llama-3.2-1B: one ``serve --speculative`` run beside phase 13's jit
     tokens; (e) ``launch.characterize --spec-sweep`` over ks 0, 2, 4 and
     batches 1, 4, its ``spec_sweep.json`` read back;
 17. the serving tier around the engine, SmolLM-360M whole in bf16 under
     jit: (a) ``serve --metrics-out m.prom --trace-out t.json
     --slo-ttft-ms 200 --slo-itl-ms 50`` (the Prometheus text parses back
     to the report's ``engine_*`` fields, the critical-path triage
     conserves every request, the trace is strict JSON with one track a
     request and paired flows), then ``--metrics-out m.json`` (reads back
     as the registry snapshot); (b) ``serve --plan fused --attribution``
     (complete, its launches the decode step's dispatches, the fused
     pair's and the attention kernel's operators among its rows, the
     boundedness summary beside it) and ``--attribution --plan jit``
     (refused with the reference's error); (c) ``route --replicas 2
     --policy least-queue-depth`` over 16 chatbot requests, each replica
     warmed on its own graphs, against one engine of the same shape
     (tokens equal but at printed near ties, dispatches and queue waits
     16, conservation, ms a token); (d) the paged fleet with prefix
     sharing, replica 0 drained after the 4th dispatch and one added after
     the 8th, under ``prefix-affinity`` (adoptions) and
     ``least-queue-depth`` (where the added replica serves, its first
     captures printed); (e) ``characterize --tp-sweep --tps 1,2,4`` on
     Llama-3.2-1B whole at batches 1, 4, 16, ``tp_sweep.json`` held
     against the traced step;
 18. the mixture-of-experts and Mamba stacks at full width (random bf16
     weights; each model freed before the next is built): Moonlight-16B-
     A3B's f32 logits at 2 layers, kernels against plain versions (a
     prefill and 3 decode steps); Moonlight whole (48 layers, 57.8 GB)
     through ``serve --arch moonshot-v1-16b-a3b`` under jit, contiguous
     and ``--cache paged --block-size 16`` (launches 49 / 48 / 48 a decode
     step: the untied head's final norm is a ``rmsnorm_matmul`` with the
     unembed), and its eager cells at 8 of its 48 layers (tracing whole
     Moonlight's eager bodies took minutes), each checked and traced as
     phase 13's cells against jit on the same weights.  The bf16 routing through the kernels is held against the
     plain versions on the served prompts (every MoE layer's set of
     experts): the largest router-logit difference of the token-layers
     that route alike must stay within 2^-4 of the logits' rms, the
     kernels' logits regressed on the plain ones must have a slope within
     2^-8 of 1, and every flip must sit at a plain top-k margin below
     twice that largest difference, the tie.  Where
     jit's tokens part from eager's past a logit near tie, that request's
     own prefix, replayed alone through the kernels and through eager's
     arithmetic, must first route a token apart at a margin below the tie.
     Each jit cell's first tokens are held against the plain versions,
     the contiguous graph replays against the same bodies run directly
     (every token equal) and the paged jit tokens against the contiguous
     ones (every token equal); then the parameter bytes, the peak memory
     and one decode step's device time split by operator scope (moe /
     mamba / attention / ...); then Kimi K2 at full width and 1 layer (hd
     112, group 8) and Jamba at full width as one 8-layer superblock with
     4 of its 16 experts, each under jit over the serve CLI's requests
     with the same routing, first-token and split checks;
 19. the cross-attention stacks (random bf16 weights, every ``xgate`` set
     to 0.5: the init's 0 zeroes every vision cross layer): for
     Llama-3.2-Vision-11B (f32 at one 5-layer superblock of full width;
     bf16 whole, 40 layers) and SeamlessM4T-medium (whole, 12 encoder and
     12 decoder layers, in both): f32 logits of a prefill with the cross
     inputs (1601 patch embeddings, or 4096 frame embeddings through the
     encoder) and decode steps through the cross caches, kernels against
     plain versions, the last step against a full forward over the whole
     sequence; the bf16 model whole under jit over the serve CLI's
     requests (a one-row zero cross cache, as the reference serves it):
     launches, graph replays against the same bodies run directly (every
     token equal), first tokens against the plain versions; the image or
     frame path at batch 4 (a 12-token prompt, 16 greedy decode steps
     through the cross caches, held against a full forward and against the
     plain versions' greedy tokens); a decode step's device time by
     operator with the served one-row cross cache and with the 1601- or
     4096-row one; the encoder's time over 4096 frames; parameter bytes and
     peak memory; eager and fused cells at one superblock (Vision) and 2
     decoder layers (Seamless), and one ``speculative=True`` cell under
     jit (tokens equal plain jit's but at printed near ties);
 20. tensor-parallel serving, Llama-3.2-1B whole at tp=2 with both ranks
     on the one card (``ShardedBackend``: rank 0 this process, rank 1 a
     spawned worker, gloo through host memory; each step CUDA-graph
     segments cut at its all-reduces): f32 logits of a prefill into every
     slot and 8 decode steps against tp=1 within TP_LOGIT_TOL, the whole
     model; then bf16 on the contiguous cache, the paged pool and an int8
     paged pool (chunked prefill), each beside
     a tp=1 jit engine on the same weights over the serve CLI's requests:
     tokens equal tp=1's but at printed near ties, the launches a decode
     step on each rank those of the local config, 2L + 1 graph replays and
     2L all-reduces a decode step on each rank, ``collective_bytes_per_
     decode_step`` = 2L x batch x d x 2, both ranks' launches equal; the
     decode step timed on the serve clock and directly beside tp=1's, the
     seconds in the gloo exchange a step on each rank and the modeled
     ``Intel+H100`` collective tax (two ranks time-sharing one card: no
     tensor-parallel speed);
 21. training: each registered backward (``kernels/*/backward.py``) with
     the CUDA forward against ``torch.autograd`` through the op's plain
     version, at the training shapes (SmolLM-360M, B 8 x S 512: flash
     causal 15/5 heads of 64, the norms with and without a residual,
     ``rmsnorm_matmul`` at 960 x 960) in f32 (TF32 off) and bf16, each
     gradient within TOL x max(1, max |plain|); in bf16 the formula's
     device time beside its bound, the plain version's backward and, for
     flash, SDPA's backward; then whole SmolLM-360M (bf16 parameters, f32
     AdamW state, lr 1e-3, warmup 5) trained TRAIN_STEPS steps of 8 x 512
     tokens of the reference's n-gram data through ``Trainer``, with the
     launch counts reset just before and read just after (launches a
     step ``rmsnorm_matmul`` 32, ``residual_rmsnorm`` 33,
     ``flash_attention`` 32, or it fails; ``launches_by_path["train"]``
     holds them): the loss must fall; the median ms a step, tokens/s,
     TFLOP/s by 6 x params x tokens, peak memory, one step split by CUDA
     events into forward, backward and optimizer, one step profiled
     (device busy, the largest kernels), the final checkpoint's bytes,
     host copy and write seconds; the same steps with the n-grams over
     the whole vocabulary (printed); a crash after step 4 of 8 at 4
     layers and its restart, per-step losses against an uninterrupted
     run within RESUME_TOL.

 22. the multi-rank training pieces, on one pool of two rank processes
     that share the card over gloo through host memory (their times are
     no parallel speed): (a) whole SmolLM-360M (bf16) data parallel over
     the two ranks, 4 x 512 of phase 21's n-gram tokens a rank, MR_STEPS
     steps of ``make_compressed_dp_grad`` (int8 payloads, error feedback)
     plus AdamW, with the launch counts reset just before; the first
     step's compressed mean gradient within COMPRESS_TOL relative of the
     exact mean (an f32 all-reduce of the same local gradients, for the
     check only), the parameters bit-identical across the ranks after
     every step (a checksum), the loss falling, launches a step and rank
     ``rmsnorm_matmul`` 32, ``residual_rmsnorm`` 33, ``flash_attention``
     32 (``launches_by_path["dp_train"]``), or it fails; ms a step split
     into compute, exchange and AdamW, the wire bytes against an f32
     all-reduce's, both ranks' peak memory; (b) Moonlight-16B-A3B at full
     width cut to 2 of its 48 layers (whole, it does not fit one card with
     gradients), expert parallel at ep 2 in ``seq`` and ``rep`` against
     the local path over batch 2 x 256 at capacity factor 8: in bf16 at
     most EP_FLIP_MAX of the tokens routed to other experts than local's
     in some layer (a router near-tie that rounding flips), the logits of
     the others within LOGIT_TOL_BF16, and each leaf's gradient of
     ``loss_fn(aux_weight=0)`` within EP_GRAD_TOL_BF16 of the leaf's
     largest local magnitude, a bound that a misrouted reading (each
     rank's expert gradients against the other rank's experts') must
     exceed; the strict gate is f32 (TF32 off) at 1 layer, logits and
     gradients within EP_TOL_F32 relative; the per-shard aux beside
     local's; then Moonlight's own capacity factor and the assignments
     dropped per shard; (c) the GPipe schedule of SmolLM-360M's 32 blocks
     in 2 stages of 16 (``stage_forward`` over ``pipeline_stages``: each
     stage runs its layers under their own indices), 4 microbatches of 2
     x 512 in bf16, against ``reference_forward`` on one rank: max error,
     pipelined and sequential ms, the bubble (P - 1) / ticks.

 23. the step builders and the dry run: (a) ``build_train_step`` and
     ``build_serve_step`` bundles of whole Llama-3.2-1B (bf16) over a
     (data 1, model 2) mesh of two ranks sharing the card (heads, d_ff and
     the vocabulary split): ST_STEPS train steps of 2 x 256 tokens (loss
     falling), a prefill of 256 and ST_DECODES decode steps, launches
     reset before each and read after; on rank 0 the same bundles on a
     one-rank mesh from the same weights: the loss within ST_LOSS_BF16,
     the last position's logits within ST_LOGITS_BF16 of their largest;
     ms a call split into compute and the gloo exchange; then f32 at
     ST_F32_LAYERS layers (AdamW eps ST_F32_EPS), one step, loss, logits
     and every parameter on each rank within ST_F32 of the one-rank
     step's, the gradient norm within ST_GNORM of it (relative) and
     AdamW's first moment (0.1 x the clipped gradient) of every leaf
     within ST_MOMENT of the leaf's largest; (b) the dry run of
     the same bundles on the same mesh (rank 0's trace) against each
     rank: its arguments equal the rank's measured input bytes, its
     temporaries within ST_PEAK_REL x measured + ST_PEAK_ARG x the
     arguments of the measured peak (max_memory_allocated over the call
     less the allocation before it); (c) the dry run of
     DRY_CELLS on the 16 x 16 production mesh, one line a cell (the whole
     ``--all`` runs in a chip call of its own); (d) the wkv6 backward at
     B 8 x T 512 x 40 x 64 against autograd through the plain version,
     its device time beside a bound, and whole-width RWKV-6 3B cut to
     RWKV_TRAIN_LAYERS layers trained RWKV_TRAIN_STEPS steps of phase 21's
     n-grams (the loss falling; wkv6 and rmsnorm launched every step).

Phases 4, 6, 7 and 9 serve with ``--plan eager`` (``plan="eager"``): one
dispatch a node of the traced step, whose norms are their plain versions,
so only the attention kernels (or ``wkv6``) launch there; their traces (5,
6, 7, 10) are those of the eager step.

Phase 2 ends with the host time of one ``decode_attention`` call through
its wrapper, its op overload and its CUDA implementation called directly:
what the ``torch.library`` dispatcher adds to a launch.

Phase 2 also holds the RWKV-6 path's two kernels at its shapes: the norm
at (4, 1, 2560) and (1, 12, 2560) with and without a residual in f32 and
bf16, WKV6 (f32) at decode (B 4, T 1), a 12-token prefill, 64 and 1024
steps in one launch (``[t64]``, ``[t1024]``: B 1, H 40, hd 64) and the
reference's extreme-decay case, which must stay finite.

Phase 2 holds the kernels at phase 18's shapes too (``moe_cases``): the
decode entries at Moonlight's (16/16 heads of 128), Kimi K2's (64/8 of
112) and Jamba's (64/8 of 128) decode shapes, ``flash_attention`` over a
16-token prefill of each beside SDPA, ``rmsnorm_matmul`` at 7168 x 7168,
8192 x 32768 (Jamba's Mamba ``in_proj``) and each untied head's final norm
with the unembed (``[unembed_moonlight|kimi|jamba]``: 2048 x 163840, 7168
x 163840, 8192 x 65536), and ``residual_rmsnorm`` at D 7168 and 8192.

The ``kernels`` line's ``launches`` are the main paths' jit runs (phase
11); the multi-query entries', phase 16's speculative runs; phase 17's
and 18's runs are in each entry's ``launches_by_path``.

Phase 2 holds the kernels at phase 19's shapes too (``xattn_cases``):
``flash_attention`` non-causal at a prefill over Llama-3.2-Vision's 1601
patches (``[vision_x]``: B 4, 32/8 heads of 128, S 16), at Seamless's
encoder (``[seamless_enc]``: B 1, 16 heads of 64, S = T = 4096) and at the
served cross prefill (``[x_t1]``: B 1, S 16 over T 1, S > T), beside SDPA;
``decode_attention`` over a whole cross cache (``[vision_x1601]``,
``[seamless_x4096]``, B 4) beside SDPA; ``rmsnorm_matmul`` at the two
untied heads (``[unembed_vision]`` 4096 x 128256, ``[unembed_seamless]``
1024 x 256206).

Order: 1-3, then 21, 22, 20, 18 and 19 (the newest phases, so that a fault
there ends the run early), then 4-17.  Phase 2 also holds the six kernels of
phase 20's path at one tp=2 rank's shapes (``tp_cases``, ``[llama_tp2]``:
16/4 heads of 64, ``rmsnorm_matmul`` at 2048 x 1024).  Phase 2 times the kernels in
bf16 (f32 only for the f32-only ``wkv6``; the f32 cases check the error),
each time the median of 20 calls; a trace (phases 5-18) times and profiles
3 decode steps (Moonlight's eager step: 1).

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It needs the repository
(it adds ``src`` to ``sys.path``) and a CUDA device, and imports nothing of
JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
LOGIT_TOL_F32 = 1e-3               # full model, f32, other summation order
LOGIT_TOL_BF16 = 0.25              # full model, bf16 rounding at other points
ARCH, MAX_BATCH, MAX_LEN, BUCKET, N_REQ = "smollm-360m", 4, 128, 16, 8
RWKV_ARCH, PROMPT = "rwkv6-3b", 12   # the serve CLI's prompts: 12 tokens
BLOCK, CHUNK = 16, 8               # paged path: tokens per page, per chunk
POOL_PAGES = {"bf16": 32, "int8": 60}   # default_num_blocks at hd 64
KERNEL_INFO = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:228"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:211"),
    "paged_decode_attention_quant": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:170"),
    # the multi-query forms of the three (speculative verify): same kernels,
    # a template instance of their own each
    "decode_attention_mq": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:228"),
    "paged_decode_attention_mq": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:211"),
    "paged_decode_attention_quant_mq": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:170"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:91"),
    "residual_rmsnorm": ("src/repro_torch/csrc/residual_rmsnorm.cu",
                         "src/repro/kernels/fused/residual_rmsnorm/"
                         "kernel.py:59"),
    "rmsnorm_matmul": ("src/repro_torch/csrc/rmsnorm_matmul.cu",
                       "src/repro/kernels/fused/rmsnorm_matmul/kernel.py:53"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:36"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:77"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def setup():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from the repository")
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


torch = setup()
import numpy as np                                         # noqa: E402
import torch.nn.functional as F                            # noqa: E402

from repro_torch import kernels                            # noqa: E402
from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.core.boundedness import find_inflection   # noqa: E402
from repro_torch.core.device_model import (KernelEvent,   # noqa: E402
                                            PLATFORMS, allreduce_cost_s)
from repro_torch.core.metrics import report as skip_report  # noqa: E402
from repro_torch.runtime import Planner                    # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.inference.engine import Request, ServeEngine  # noqa: E402
from repro_torch.inference.backends import LocalBackend    # noqa: E402
from repro_torch.inference.backends.sharded import (       # noqa: E402
    ShardedBackend, local_config)
from repro_torch.inference.kv_quant import quantize_kv     # noqa: E402
from repro_torch.kernels.decode_attention.ops import _decode_launch  # noqa: E402,E501
from repro_torch.kernels.decode_attention.ref import (     # noqa: E402
    decode_attention_mq_ref, decode_attention_ref,
    paged_decode_attention_mq_ref, paged_decode_attention_quant_mq_ref,
    paged_decode_attention_quant_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused.residual_rmsnorm.ref import \
    residual_rmsnorm_ref                                   # noqa: E402
from repro_torch.kernels.fused.rmsnorm_matmul.ref import \
    rmsnorm_matmul_ref                                     # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref    # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_oracle, wkv6_ref  # noqa: E402
from repro_torch.launch import serve                       # noqa: E402
from repro_torch.launch.autotune import print_table        # noqa: E402
from repro_torch.launch.characterize import (              # noqa: E402
    print_memory_sweep, print_points, write_artifacts)
from repro_torch.launch.characterize import \
    main as characterize_main                              # noqa: E402
from repro_torch.launch.route import build_requests        # noqa: E402
from repro_torch.launch.route import main as route_main    # noqa: E402
from repro_torch.inference.speculative import (           # noqa: E402
    default_draft_config, draft_params_from_target)
from repro_torch.runtime.autotune import autotune          # noqa: E402
from repro_torch.telemetry.attribution import (           # noqa: E402
    parse_operator, segment_ops)
from repro_torch.telemetry.characterize import (           # noqa: E402
    _decode_trace, _requests, characterize, memory_pressure_sweep)
from repro_torch.workload import load_workload, sample_requests  # noqa: E402
from repro_torch.models import (attention_launches,       # noqa: E402
                                encode, forward, has_cross,
                                init_params, is_recurrent, loss_fn,
                                make_cache, make_paged_cache,
                                norm_launches, param_count)
from repro_torch.data import DataConfig, make_batch         # noqa: E402
from repro_torch.kernels.flash_attention.backward import \
    flash_attention_bwd                                    # noqa: E402
from repro_torch.kernels.fused.residual_rmsnorm.backward import \
    residual_rmsnorm_bwd                                   # noqa: E402
from repro_torch.kernels.fused.rmsnorm_matmul.backward import \
    rmsnorm_matmul_bwd                                     # noqa: E402
from repro_torch.training.loop import (TrainConfig,       # noqa: E402
                                       Trainer, to_device)
from repro_torch.training.optim import (OptConfig,        # noqa: E402
                                        opt_init, opt_update)
from repro_torch.distributed.collectives import raw_psum   # noqa: E402
from repro_torch.distributed.compression import (          # noqa: E402
    init_error_state, make_compressed_dp_grad, wire_bytes)
from repro_torch.distributed.pipeline import (             # noqa: E402
    bubble_fraction, pipeline_forward, reference_forward)
from repro_torch.distributed.ranks import RankPool         # noqa: E402
from repro_torch.distributed.sharding import (             # noqa: E402
    expert_param_specs, shard_for_rank)
from repro_torch.launch.mesh import Mesh, make_host_mesh   # noqa: E402
from repro_torch.launch import dryrun                      # noqa: E402
from repro_torch.launch.steps import (                     # noqa: E402
    StepOptions, build_serve_step, build_train_step, stack_blocks)
from repro_torch.configs import ShapeSpec                  # noqa: E402
from repro_torch.distributed.dry import dry_context       # noqa: E402
from repro_torch.kernels.rwkv6.backward import wkv6_bwd    # noqa: E402
from repro_torch.layers import moe as moe_layer            # noqa: E402
from repro_torch.layers.common import embed_tokens         # noqa: E402
from repro_torch.models import (pipeline_stages,         # noqa: E402
                                stage_forward)
from repro_torch.tree import leaves as tree_leaves         # noqa: E402
from repro_torch.tree import map_tree as tree_map          # noqa: E402
from repro_torch.tree import named_leaves                  # noqa: E402

DEV = torch.device("cuda", 0)
PLAINS = {"decode_attention": decode_attention_ref,
          "decode_attention_mq": decode_attention_mq_ref,
          "paged_decode_attention_mq": paged_decode_attention_mq_ref,
          "paged_decode_attention_quant_mq":
              paged_decode_attention_quant_mq_ref,
          "flash_attention": attention_ref,
          "paged_decode_attention": paged_decode_attention_ref,
          "paged_decode_attention_quant": paged_decode_attention_quant_ref,
          "residual_rmsnorm": residual_rmsnorm_ref,
          "rmsnorm_matmul": rmsnorm_matmul_ref,
          "rmsnorm": rmsnorm_ref,
          "wkv6": wkv6_ref}
# the eager plan runs the fused norms as their plain versions, the
# attention kernels as kernels
EAGER_PLAINS = ("residual_rmsnorm", "rmsnorm_matmul", "rmsnorm")


@contextlib.contextmanager
def plain_kernels(names=tuple(PLAINS)):
    """Route the model's kernel calls (those in ``names``) to the plain
    versions (on the card)."""
    saved = {name: getattr(kernels, name) for name in names}
    try:
        for name in names:
            setattr(kernels, name, PLAINS[name])
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


# ------------------------------------------------------------------ timing
_FLUSH = None


def time_ms(fn, iters: int = 20) -> tuple:
    """(device ms, host ms) of one call.

    Device: the median over ``iters`` calls, each with the L2 flushed first
    (weights and caches are cold when a 32-layer step reaches them) and the
    stream held busy for ~1 ms, so the call is fully enqueued before the
    device reaches it and the CUDA events around it time the device alone.
    Host: the mean enqueue time of ``4 * iters`` calls back to back (the
    wrapper's checks and launches, or the plain version's eager ops)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    dev = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * iters):
        fn()
    host = (time.perf_counter() - t0) / (4 * iters) * 1e3
    torch.cuda.synchronize()
    return float(np.median(dev)), host


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, what bounds it) on an H100 SXM at 700 W."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def randn(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(DEV, dtype)


def randn_on_card(shape, dtype, seed, scale=1.0):
    """``randn`` drawn on the card (a seeded CUDA generator), for weights of
    a billion elements that numpy would take seconds to draw."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def max_err(out, ref) -> float:
    torch.cuda.synchronize()
    if isinstance(out, tuple):
        return max(max_err(o, r) for o, r in zip(out, ref))
    return (out.float() - ref.float()).abs().max().item()


def rel_bound(ref, dtype) -> float:
    if isinstance(ref, tuple):
        return min(rel_bound(r, dtype) for r in ref)
    return TOL[str(dtype)] * max(1.0, ref.float().abs().max().item())


# ------------------------------------------------------------------ phase 1
def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    secs = time.perf_counter() - t0
    built = build.build_seconds is not None
    print(f"phase 1: kernels {'built' if built else 'found'} in {secs:.2f} s "
          f"({path.name}, sm_90a)")
    spills = 0
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found:
            spills += int(found.group(1)) + int(found.group(2))
    if spills:
        fail(f"the kernels spill {spills} bytes of registers (build.log)")
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for _ in range(100):
        build.null_launch(stream)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        build.null_launch(stream)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    dev_us = time_ms(lambda: build.null_launch(stream), iters=200)[0] * 1e3
    print(f"  empty kernel: host launch {host_us:.2f} us/launch "
          f"(ctypes call + cudaLaunchKernel, back to back), device "
          f"{dev_us:.2f} us between the events around it")


# ------------------------------------------------------------------ phase 2
def paged_table(lens, n_pages, seed, nb=MAX_LEN // BLOCK) -> torch.Tensor:
    """(B, nb) int32 block table: each row's pages drawn from a permutation
    of the pool, entries past a row's length the sentinel ``n_pages``, as
    the engine builds them."""
    perm = np.random.default_rng(seed).permutation(n_pages)
    table = np.full((len(lens), nb), n_pages, np.int32)
    nxt = 0
    for row, n in enumerate(lens):
        for i in range(-(-n // BLOCK)):
            table[row, i] = perm[nxt]
            nxt += 1
    return torch.from_numpy(table).to(DEV)


def main_path_cases(cfg, dtype):
    """Inputs of each kernel at the shapes the main path gives it, with the
    bytes and flops the call needs on these inputs.  A key ``name[variant]``
    is another call of kernel ``name``: without a residual, or at a slot's
    prefill rows (1, BUCKET, d), where ``rmsnorm_matmul`` runs two row
    tiles.  The paged kernels read the valid pages of each row; the bf16
    one is also held against the contiguous kernel on the same logical
    KV (``contiguous``)."""
    b, d, hq, hkv, hd = MAX_BATCH, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    scale = hd ** -0.5
    lens = torch.tensor([28, 21, 17, 13], dtype=torch.int32, device=DEV)
    n_kv = int(lens.sum())
    cache_k = randn((b, MAX_LEN, hkv, hd), dtype, 1)
    cache_v = randn((b, MAX_LEN, hkv, hd), dtype, 2)
    q_dec = randn((b, hq, hd), dtype, 3)
    kt, vt = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    q_pre = randn((1, BUCKET, hq, hd), dtype, 4).transpose(1, 2)
    k_pre = randn((1, BUCKET, hkv, hd), dtype, 5).transpose(1, 2)
    v_pre = randn((1, BUCKET, hkv, hd), dtype, 6).transpose(1, 2)
    x = randn((b, 1, d), dtype, 7)
    r = randn((b, 1, d), dtype, 8)
    w = randn((d,), dtype, 9) + 1.0
    wq = randn((d, hq * hd), dtype, 10, scale=0.02)
    xp = randn((1, BUCKET, d), dtype, 11)
    rp = randn((1, BUCKET, d), dtype, 12)
    pairs = BUCKET * (BUCKET + 1) // 2
    f = hq * hd
    nb = MAX_LEN // BLOCK
    lens_host = lens.tolist()
    bt = paged_table(lens_host, POOL_PAGES["bf16"], 13)
    kp = randn((POOL_PAGES["bf16"], BLOCK, hkv, hd), dtype, 14)
    vp = randn((POOL_PAGES["bf16"], BLOCK, hkv, hd), dtype, 15)
    # the same logical KV as a contiguous (B, T, HKV, hd) cache
    logical = bt.long().clamp(0, POOL_PAGES["bf16"] - 1)
    ck = kp[logical].reshape(b, nb * BLOCK, hkv, hd)
    cv = vp[logical].reshape(b, nb * BLOCK, hkv, hd)
    bt8 = paged_table(lens_host, POOL_PAGES["int8"], 16)
    kq, ks = quantize_kv(randn((POOL_PAGES["int8"], BLOCK, hkv, hd),
                               torch.float32, 17))
    vq, vs = quantize_kv(randn((POOL_PAGES["int8"], BLOCK, hkv, hd),
                               torch.float32, 18))
    table_bytes = 4 * b * nb + 4 * b
    return {
        "paged_decode_attention": dict(
            call=lambda: kernels.paged_decode_attention(q_dec, kp, vp, bt,
                                                        lens, scale=scale),
            plain=lambda: paged_decode_attention_ref(q_dec, kp, vp, bt, lens,
                                                     scale=scale),
            contiguous=lambda: kernels.decode_attention(
                q_dec, ck.transpose(1, 2), cv.transpose(1, 2), lens,
                scale=scale),
            library=None,
            bytes=(2 * b * hq * hd + 2 * n_kv * hkv * hd) * es + table_bytes,
            flops=4 * n_kv * hq * hd),
        "paged_decode_attention_quant": dict(
            call=lambda: kernels.paged_decode_attention_quant(
                q_dec, kq, vq, ks, vs, bt8, lens, scale=scale),
            plain=lambda: paged_decode_attention_quant_ref(
                q_dec, kq, vq, ks, vs, bt8, lens, scale=scale),
            library=None,
            bytes=(2 * b * hq * hd * es + 2 * n_kv * hkv * (hd + 4)
                   + table_bytes),
            flops=4 * n_kv * hq * hd),
        "decode_attention": dict(
            call=lambda: kernels.decode_attention(q_dec, kt, vt, lens,
                                                  scale=scale),
            plain=lambda: decode_attention_ref(q_dec, kt, vt, lens,
                                               scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q_dec[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True),
            bytes=(2 * b * hq * hd + 2 * n_kv * hkv * hd) * es + 4 * b,
            flops=4 * n_kv * hq * hd),
        "flash_attention": dict(
            call=lambda: kernels.flash_attention(q_pre, k_pre, v_pre,
                                                 scale=scale),
            plain=lambda: attention_ref(q_pre, k_pre, v_pre, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q_pre, k_pre, v_pre, is_causal=True, scale=scale,
                enable_gqa=True),
            bytes=(2 * BUCKET * hq * hd + 2 * BUCKET * hkv * hd) * es,
            flops=4 * pairs * hq * hd),
        "residual_rmsnorm": dict(
            call=lambda: kernels.residual_rmsnorm(x, w, r),
            plain=lambda: residual_rmsnorm_ref(x, w, r),
            library=None,
            bytes=(4 * b * d + d) * es, flops=5 * b * d),
        "residual_rmsnorm[no_residual]": dict(
            call=lambda: kernels.residual_rmsnorm(x, w),
            plain=lambda: residual_rmsnorm_ref(x, w),
            library=lambda: F.rms_norm(x, (d,), w, eps=cfg.norm_eps),
            bytes=(2 * b * d + d) * es, flops=4 * b * d),
        "residual_rmsnorm[prefill]": dict(
            call=lambda: kernels.residual_rmsnorm(xp, w, rp),
            plain=lambda: residual_rmsnorm_ref(xp, w, rp),
            library=None,
            bytes=(4 * BUCKET * d + d) * es, flops=5 * BUCKET * d),
        "residual_rmsnorm[prefill_no_residual]": dict(
            call=lambda: kernels.residual_rmsnorm(xp, w),
            plain=lambda: residual_rmsnorm_ref(xp, w),
            library=lambda: F.rms_norm(xp, (d,), w, eps=cfg.norm_eps),
            bytes=(2 * BUCKET * d + d) * es, flops=4 * BUCKET * d),
        "rmsnorm_matmul": dict(
            call=lambda: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda: torch.matmul(
                F.rms_norm(x, (d,), w, eps=cfg.norm_eps), wq),
            bytes=(2 * b * d + d + d * f + b * f) * es,
            flops=2 * b * d * f + 4 * b * d),
        "rmsnorm_matmul[prefill]": dict(
            call=lambda: kernels.rmsnorm_matmul(xp, w, wq),
            plain=lambda: rmsnorm_matmul_ref(xp, w, wq),
            library=None,
            unfused=lambda: torch.matmul(
                F.rms_norm(xp, (d,), w, eps=cfg.norm_eps), wq),
            bytes=(2 * BUCKET * d + d + d * f + BUCKET * f) * es,
            flops=2 * BUCKET * d * f + 4 * BUCKET * d),
    }


def flash_cases(cfg, dtype):
    """``flash_attention`` at longer causal prefills of the same heads: S =
    T = MAX_LEN (a prompt that fills the smoke's cache) and S = T = 1024,
    as ``name[t<S>]`` cases."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for n in (MAX_LEN, 1024):
        q, k, v = (randn((1, n, h, hd), dtype, seed).transpose(1, 2)
                   for h, seed in ((hq, 19), (hkv, 20), (hkv, 21)))
        cases[f"flash_attention[t{n}]"] = dict(
            call=lambda q=q, k=k, v=v: kernels.flash_attention(
                q, k, v, scale=hd ** -0.5),
            plain=lambda q=q, k=k, v=v: attention_ref(q, k, v,
                                                      scale=hd ** -0.5),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=hd ** -0.5, enable_gqa=True),
            bytes=(2 * n * hq * hd + 2 * n * hkv * hd) * es,
            flops=4 * (n * (n + 1) // 2) * hq * hd)
    return cases


T_LONG = 1024                      # the [t1024] decode cases' cache
LONG_LENS = [1024, 768, 512, 256]


def decode_long_cases(cfg, dtype):
    """The decode kernels over a T_LONG-position cache, split over
    positions: ``decode_attention[t1024]`` (beside SDPA with a mask) and
    ``paged_decode_attention[t1024]`` (block 16, 64 blocks a row)."""
    b, hq, hkv, hd = MAX_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    scale = hd ** -0.5
    lens = torch.tensor(LONG_LENS, dtype=torch.int32, device=DEV)
    n_kv = sum(LONG_LENS)
    q = randn((b, hq, hd), dtype, 60)
    kt = randn((b, T_LONG, hkv, hd), dtype, 61).transpose(1, 2)
    vt = randn((b, T_LONG, hkv, hd), dtype, 62).transpose(1, 2)
    mask = (torch.arange(T_LONG, device=DEV)[None, :]
            < lens[:, None])[:, None, None, :]
    nb = T_LONG // BLOCK
    n_pages = b * nb
    bt = paged_table(LONG_LENS, n_pages, 63, nb)
    kp = randn((n_pages, BLOCK, hkv, hd), dtype, 64)
    vp = randn((n_pages, BLOCK, hkv, hd), dtype, 65)
    kv_bytes = (2 * b * hq * hd + 2 * n_kv * hkv * hd) * es
    return {
        "decode_attention[t1024]": dict(
            call=lambda: kernels.decode_attention(q, kt, vt, lens,
                                                  scale=scale),
            plain=lambda: decode_attention_ref(q, kt, vt, lens, scale=scale),
            library=lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True),
            bytes=kv_bytes + 4 * b, flops=4 * n_kv * hq * hd),
        "paged_decode_attention[t1024]": dict(
            call=lambda: kernels.paged_decode_attention(q, kp, vp, bt, lens,
                                                        scale=scale),
            plain=lambda: paged_decode_attention_ref(q, kp, vp, bt, lens,
                                                     scale=scale),
            library=None,
            bytes=kv_bytes + 4 * b * nb + 4 * b, flops=4 * n_kv * hq * hd),
    }


# the new configs' decode shapes: (HQ, HKV, hd, window, softcap, scale)
DENSE_DECODE = {"gemma2": (32, 16, 128, 16, 50.0, 0.0625),
                "llama": (32, 8, 64, 0, 0.0, 64 ** -0.5),
                "internlm2": (48, 8, 128, 0, 0.0, 128 ** -0.5),
                "codeqwen": (32, 32, 128, 0, 0.0, 128 ** -0.5)}
# the new configs' norm widths (D, F = HQ * hd): Llama, CodeQwen, Gemma-2,
# InternLM2
DENSE_WIDTHS = ((2048, 2048), (4096, 4096), (4608, 4096), (6144, 6144))
BERT_SEQ = 512                     # the paper's PAPER_SEQ


def decode_entry_cases(tag, hq, hkv, hd, window, cap, scale, dtype, lens,
                       t_len, seed):
    """The three decode entries at one config's decode shape (B 4, a
    ``t_len``-position cache, block 16, the pools holding each row's valid
    pages), keyed ``name[tag]``; without a softcap the contiguous one beside
    SDPA with the (windowed) length mask, which then computes the same
    function (no single library call caps the scores)."""
    b = len(lens)
    es = torch.tensor([], dtype=dtype).element_size()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    # the keys a row attends: its last ``window`` of ``len`` positions
    n_kv = sum(min(n, window) if window else n for n in lens)
    q = randn((b, hq, hd), dtype, seed)
    kt = randn((b, t_len, hkv, hd), dtype, seed + 1).transpose(1, 2)
    vt = randn((b, t_len, hkv, hd), dtype, seed + 2).transpose(1, 2)
    pos = torch.arange(t_len, device=DEV)[None, :]
    mask = pos < lens_t[:, None]
    if window:
        mask &= pos > lens_t[:, None] - 1 - window
    mask = mask[:, None, None, :]
    nb = t_len // BLOCK
    n_pages = sum(-(-n // BLOCK) for n in lens) + 3
    bt = paged_table(lens, n_pages, seed + 3, nb)
    kp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 4)
    vp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 5)
    kq, ks = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 6))
    vq, vs = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 7))
    opts = dict(scale=scale, window=window, softcap=cap)
    io_bytes = 2 * b * hq * hd * es
    table_bytes = 4 * b * nb + 4 * b
    flops = 4 * n_kv * hq * hd
    return {
        f"decode_attention[{tag}]": dict(
            call=lambda: kernels.decode_attention(q, kt, vt, lens_t, **opts),
            plain=lambda: decode_attention_ref(q, kt, vt, lens_t, **opts),
            library=(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True)) if not cap else None,
            bytes=io_bytes + 2 * n_kv * hkv * hd * es + 4 * b, flops=flops),
        f"paged_decode_attention[{tag}]": dict(
            call=lambda: kernels.paged_decode_attention(q, kp, vp, bt, lens_t,
                                                        **opts),
            plain=lambda: paged_decode_attention_ref(q, kp, vp, bt, lens_t,
                                                     **opts),
            library=None,
            bytes=io_bytes + 2 * n_kv * hkv * hd * es + table_bytes,
            flops=flops),
        f"paged_decode_attention_quant[{tag}]": dict(
            call=lambda: kernels.paged_decode_attention_quant(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            plain=lambda: paged_decode_attention_quant_ref(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            library=None,
            bytes=io_bytes + 2 * n_kv * hkv * (hd + 4) + table_bytes,
            flops=flops),
    }


# the speculative verify's queries a row: k = 1, 4 and 8 (S = k + 1); S = 5
# (k = 4, phase 16's depth) is each multi-query entry's own row
MQ_S = (2, 5, 9)


def mq_entry_cases(tag, s, hq, hkv, hd, window, cap, scale, dtype, lens,
                   t_len, seed):
    """The three multi-query entries (``name_mq``, or ``name_mq[tag]``) at
    one shape: S queries a row, query j of row b at position lens[b] - S +
    j; the pools hold each row's valid pages.  The bound counts each row's
    keys once (the union of its queries' ranges) and each query's own
    products; without a softcap the contiguous entry beside SDPA with the
    per-query (windowed) length mask, which computes the same function.
    Timed in bf16 only (f32 checks the error)."""
    b = len(lens)
    es = torch.tensor([], dtype=dtype).element_size()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = randn((b, s, hq, hd), dtype, seed)
    kt = randn((b, t_len, hkv, hd), dtype, seed + 1).transpose(1, 2)
    vt = randn((b, t_len, hkv, hd), dtype, seed + 2).transpose(1, 2)
    qlen = (lens_t[:, None] - (s - 1)
            + torch.arange(s, device=DEV)[None, :])[:, :, None]
    pos = torch.arange(t_len, device=DEV)[None, None, :]
    mask = pos < qlen
    if window:
        mask &= pos > qlen - 1 - window
    mask = mask[:, None]                                   # (B,1,S,T)
    keys, pairs = 0, 0
    for n in lens:
        ql = [n - (s - 1) + j for j in range(s)]
        lo = max(0, ql[0] - window) if window else 0
        keys += min(n, t_len) - lo
        pairs += sum(min(x, t_len) - (max(0, x - window) if window else 0)
                     for x in ql)
    nb = t_len // BLOCK
    n_pages = sum(-(-n // BLOCK) for n in lens) + 3
    bt = paged_table(lens, n_pages, seed + 3, nb)
    kp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 4)
    vp = randn((n_pages, BLOCK, hkv, hd), dtype, seed + 5)
    kq, ks = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 6))
    vq, vs = quantize_kv(randn((n_pages, BLOCK, hkv, hd), torch.float32,
                               seed + 7))
    opts = dict(scale=scale, window=window, softcap=cap)
    io_bytes = 2 * b * s * hq * hd * es
    table_bytes = 4 * b * nb + 4 * b
    flops = 4 * pairs * hq * hd
    sfx = f"[{tag}]" if tag else ""
    common = dict(flops=flops)
    return {
        f"decode_attention_mq{sfx}": dict(
            call=lambda: kernels.decode_attention_mq(q, kt, vt, lens_t,
                                                     **opts),
            plain=lambda: decode_attention_mq_ref(q, kt, vt, lens_t, **opts),
            library=(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kt, vt, attn_mask=mask, scale=scale,
                enable_gqa=True)) if not cap else None,
            bytes=io_bytes + 2 * keys * hkv * hd * es + 4 * b, **common),
        f"paged_decode_attention_mq{sfx}": dict(
            call=lambda: kernels.paged_decode_attention_mq(
                q, kp, vp, bt, lens_t, **opts),
            plain=lambda: paged_decode_attention_mq_ref(q, kp, vp, bt,
                                                        lens_t, **opts),
            library=None,
            bytes=io_bytes + 2 * keys * hkv * hd * es + table_bytes,
            **common),
        f"paged_decode_attention_quant_mq{sfx}": dict(
            call=lambda: kernels.paged_decode_attention_quant_mq(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            plain=lambda: paged_decode_attention_quant_mq_ref(
                q, kq, vq, ks, vs, bt, lens_t, **opts),
            library=None,
            bytes=io_bytes + 2 * keys * hkv * (hd + 4) + table_bytes,
            **common),
    }


def mq_cases(cfg, dtype):
    """The multi-query entries at SmolLM's decode shape (B 4, lengths
    28/21/17/13) with S = 2, 5 and 9 (keys ``[s2]``, none, ``[s9]``), at
    S = 5 over ``[t1024]`` and at Gemma-2's window-and-softcap shape
    (``[gemma2]``)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cases = {}
    for i, s in enumerate(MQ_S):
        cases.update(mq_entry_cases("" if s == 5 else f"s{s}", s, hq, hkv,
                                    hd, 0, 0.0, hd ** -0.5, dtype,
                                    [28, 21, 17, 13], MAX_LEN, 150 + 10 * i))
    cases.update(mq_entry_cases("t1024", 5, hq, hkv, hd, 0, 0.0, hd ** -0.5,
                                dtype, LONG_LENS, T_LONG, 180))
    ghq, ghkv, ghd, window, cap, scale = DENSE_DECODE["gemma2"]
    cases.update(mq_entry_cases("gemma2", 5, ghq, ghkv, ghd, window, cap,
                                scale, dtype, [28, 21, 17, 13], MAX_LEN,
                                190))
    return cases


def dense_cases(dtype):
    """The kernels at the new configs' shapes (keys ``name[tag]``): the
    decode entries at Gemma-2's (window 16, softcap 50, lengths
    28/21/17/13; and ``[gemma2_t1024]``: window 256, no softcap, lengths
    1024/768/512/256, beside SDPA with the windowed mask), Llama's,
    InternLM2's and CodeQwen's decode shapes (the contiguous entry beside
    SDPA with the length mask where there is no softcap); ``flash_attention``
    non-causal at BERT's prefill (B 4, 12 heads of 64, S = T = 512) beside
    SDPA; ``rmsnorm_matmul`` and ``residual_rmsnorm`` at the decode rows (4
    x 1) of D 2048, 4096, 4608 and 6144."""
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for i, (tag, (hq, hkv, hd, window, cap, scale)) in enumerate(
            DENSE_DECODE.items()):
        cases.update(decode_entry_cases(tag, hq, hkv, hd, window, cap, scale,
                                        dtype, [28, 21, 17, 13], MAX_LEN,
                                        70 + 10 * i))
    hq, hkv, hd, _, _, scale = DENSE_DECODE["gemma2"]
    cases.update(decode_entry_cases("gemma2_t1024", hq, hkv, hd, 256, 0.0,
                                    scale, dtype, LONG_LENS, T_LONG, 120))
    b, h, hd, n = MAX_BATCH, 12, 64, BERT_SEQ
    q, k, v = (randn((b, n, h, hd), dtype, seed).transpose(1, 2)
               for seed in (130, 131, 132))
    cases["flash_attention[bert_s512]"] = dict(
        call=lambda: kernels.flash_attention(q, k, v, scale=hd ** -0.5,
                                             causal=False),
        plain=lambda: attention_ref(q, k, v, scale=hd ** -0.5,
                                    causal=False),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, scale=hd ** -0.5),
        bytes=4 * b * n * h * hd * es, flops=4 * b * n * n * h * hd)
    for d, f in DENSE_WIDTHS:
        x = randn((MAX_BATCH, 1, d), dtype, 140)
        r = randn((MAX_BATCH, 1, d), dtype, 141)
        w = randn((d,), dtype, 142) + 1.0
        wq = randn_on_card((d, f), dtype, 143, scale=0.02)
        rows = MAX_BATCH
        cases[f"rmsnorm_matmul[d{d}]"] = dict(
            call=lambda x=x, w=w, wq=wq: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda x=x, w=w, wq=wq: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda x=x, w=w, wq=wq, d=d: torch.matmul(
                F.rms_norm(x, (d,), w, eps=1e-5), wq),
            bytes=(2 * rows * d + d + d * f + rows * f) * es,
            flops=2 * rows * d * f + 4 * rows * d)
        cases[f"residual_rmsnorm[d{d}]"] = dict(
            call=lambda x=x, w=w, r=r: kernels.residual_rmsnorm(x, w, r),
            plain=lambda x=x, w=w, r=r: residual_rmsnorm_ref(x, w, r),
            library=None,
            bytes=(4 * rows * d + d) * es, flops=5 * rows * d)
    return cases


# phase 18's decode shapes: (HQ, HKV, hd, window, softcap, scale):
# Moonlight (group 1 at hd 128), Kimi K2 (group 8 at hd 112, not a power
# of two), Jamba's attention slot (group 8 at hd 128)
MOE_DECODE = {"moonlight": (16, 16, 128, 0, 0.0, 128 ** -0.5),
              "kimi": (64, 8, 112, 0, 0.0, 112 ** -0.5),
              "jamba": (64, 8, 128, 0, 0.0, 128 ** -0.5)}
# their fused-norm products (D, F): Kimi's wq, Jamba's Mamba in_proj (a
# superblock's first norm1); Moonlight's wq is 2048 x 2048 (``[d2048]``)
MOE_WIDTHS = ((7168, 7168), (8192, 32768))


def moe_cases(dtype):
    """The kernels at phase 18's shapes: the decode entries at Moonlight's,
    Kimi K2's and Jamba's decode shapes (lengths 28/21/17/13, the
    contiguous one beside SDPA with the length mask), ``flash_attention``
    over a slot's 16-token prefill of each (beside SDPA; hd 112 runs the
    hd-128 instance zero-padded), ``rmsnorm_matmul`` at Kimi's 7168 x 7168,
    Jamba's 8192 x 32768 and each head's final norm with the unembed
    (``[unembed_<model>]``, D x V) and ``residual_rmsnorm`` at D 7168 and
    8192, at the decode rows (4 x 1)."""
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for i, (tag, (hq, hkv, hd, window, cap, scale)) in enumerate(
            MOE_DECODE.items()):
        cases.update(decode_entry_cases(tag, hq, hkv, hd, window, cap, scale,
                                        dtype, [28, 21, 17, 13], MAX_LEN,
                                        200 + 10 * i))
        n = BUCKET
        q, k, v = (randn((1, n, h, hd), dtype, seed).transpose(1, 2)
                   for h, seed in ((hq, 205 + 10 * i), (hkv, 206 + 10 * i),
                                   (hkv, 207 + 10 * i)))
        cases[f"flash_attention[{tag}]"] = dict(
            call=lambda q=q, k=k, v=v, sc=scale: kernels.flash_attention(
                q, k, v, scale=sc),
            plain=lambda q=q, k=k, v=v, sc=scale: attention_ref(q, k, v,
                                                                scale=sc),
            library=lambda q=q, k=k, v=v, sc=scale:
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=sc, enable_gqa=True),
            bytes=(2 * n * hq * hd + 2 * n * hkv * hd) * es,
            flops=4 * (n * (n + 1) // 2) * hq * hd)
    heads = {"moonlight": MOONLIGHT, "kimi": KIMI, "jamba": JAMBA}
    widths = [(f"d{d}x{f}", d, f) for d, f in MOE_WIDTHS] + [
        (f"unembed_{tag}", get_config(a).d_model, get_config(a).vocab_size)
        for tag, a in heads.items()]
    for tag, d, f in widths:
        x = randn((MAX_BATCH, 1, d), dtype, 240)
        r = randn((MAX_BATCH, 1, d), dtype, 241)
        w = randn((d,), dtype, 242) + 1.0
        wq = randn_on_card((d, f), dtype, 243, scale=0.02)
        rows = MAX_BATCH
        cases[f"rmsnorm_matmul[{tag}]"] = dict(
            call=lambda x=x, w=w, wq=wq: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda x=x, w=w, wq=wq: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda x=x, w=w, wq=wq, d=d: torch.matmul(
                F.rms_norm(x, (d,), w, eps=1e-5), wq),
            bytes=(2 * rows * d + d + d * f + rows * f) * es,
            flops=2 * rows * d * f + 4 * rows * d)
        if tag.startswith("unembed"):
            continue
        cases[f"residual_rmsnorm[d{d}]"] = dict(
            call=lambda x=x, w=w, r=r: kernels.residual_rmsnorm(x, w, r),
            plain=lambda x=x, w=w, r=r: residual_rmsnorm_ref(x, w, r),
            library=None,
            bytes=(4 * rows * d + d) * es, flops=5 * rows * d)
    return cases


def wkv_inputs(b, t, h, hd, seed) -> tuple:
    """r, k, v, logw (B,T,H,hd), u, s0 in f32 at the scales of the
    reference's WKV6 test (``tests/test_kernels.py::test_wkv6``)."""
    f32 = torch.float32
    return (randn((b, t, h, hd), f32, seed, 0.5),
            randn((b, t, h, hd), f32, seed + 1, 0.5),
            randn((b, t, h, hd), f32, seed + 2),
            -torch.exp(randn((b, t, h, hd), f32, seed + 3, 0.5) - 2.0),
            randn((h, hd), f32, seed + 4, 0.3),
            randn((b, h, hd, hd), f32, seed + 5, 0.1))


def rwkv_cases(cfg, dtype):
    """The RWKV-6 path's kernels at its shapes, keyed as in
    ``main_path_cases``.  The norm at the decode rows (4, 1, D) and a
    prefill's (1, PROMPT, D), with and without a residual.  WKV6 only in
    f32 (the layer calls it so): decode (B 4, T 1), a PROMPT-token
    prefill, T 64 and T 1024 (many chunks in one launch), and the
    reference's extreme-decay case (decays exp(-50) and exp(-1e-4) in
    turn), which must stay finite and is held against the literal float64
    recurrence."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    es = torch.tensor([], dtype=dtype).element_size()
    w = randn((d,), dtype, 30) + 1.0
    cases = {}
    for tag, (b, t) in (("", (MAX_BATCH, 1)), ("prefill", (1, PROMPT))):
        x = randn((b, t, d), dtype, 31)
        res = randn((b, t, d), dtype, 32)
        n = b * t
        for res_tag, r in (("", res), ("no_residual", None)):
            sub = "_".join(p for p in (tag, res_tag) if p)
            cases["rmsnorm" + (f"[{sub}]" if sub else "")] = dict(
                call=lambda x=x, r=r: kernels.rmsnorm(x, w, r),
                plain=lambda x=x, r=r: rmsnorm_ref(x, w, r),
                library=(None if r is not None else
                         lambda x=x: F.rms_norm(x, (d,), w,
                                                eps=cfg.norm_eps)),
                bytes=((4 if r is not None else 2) * n * d + d) * es,
                flops=(5 if r is not None else 4) * n * d)
    if dtype != torch.float32:
        return cases
    for tag, (b, t, hh, dd, seed) in (
            ("", (MAX_BATCH, 1, h, hd, 40)),
            ("prefill", (1, PROMPT, h, hd, 46)),
            ("t64", (1, 64, h, hd, 52)),
            ("t1024", (1, 1024, h, hd, 64)),
            ("extreme_decay", (1, 32, 1, 8, 58))):
        args = wkv_inputs(b, t, hh, dd, seed)
        plain = wkv6_ref
        if tag == "extreme_decay":
            even = (torch.arange(t, device=DEV) % 2 == 0)[None, :, None,
                                                         None]
            args = (*args[:3],
                    torch.where(even, -50.0, -1e-4).expand(
                        b, t, hh, dd).contiguous(),
                    torch.zeros_like(args[4]), torch.zeros_like(args[5]))
            plain = wkv6_oracle
        cases["wkv6" + (f"[{tag}]" if tag else "")] = dict(
            call=lambda a=args: kernels.wkv6(*a),
            plain=lambda a=args, p=plain: p(*a),
            library=None, f32_only=True, finite=True,
            # r, k, v, logw and o per token, u, the state read and written
            bytes=4 * (5 * b * t * hh * dd + hh * dd + 2 * b * hh * dd * dd),
            # per token and head: r S (2 hd^2), the state update (3 hd^2),
            # the bonus (3 hd) and exp (hd)
            flops=b * t * hh * (5 * dd * dd + 4 * dd))
    return cases


# phase 20's local shapes: Llama-3.2-1B at tp=2, one rank's 16/4 heads of
# 64 and its 1024 columns of wq
TP_DECODE = (16, 4, 64, 0, 0.0, 64 ** -0.5)
TP_WIDTH = (2048, 1024)


def tp_cases(dtype):
    """The six kernels of phase 20's path at one tp=2 rank's shapes of
    Llama-3.2-1B (keys ``name[llama_tp2]``): the three decode entries over
    16/4 heads of 64 (lengths 28/21/17/13), ``flash_attention`` over a
    16-token prefill of the same heads beside SDPA, ``rmsnorm_matmul`` at
    the local wq (2048 x 1024) at the decode rows (4 x 1) and a slot's
    prefill rows (``[llama_tp2_prefill]``), and ``residual_rmsnorm`` on
    the replicated stream (D 2048)."""
    hq, hkv, hd, window, cap, scale = TP_DECODE
    d, f = TP_WIDTH
    es = torch.tensor([], dtype=dtype).element_size()
    cases = decode_entry_cases("llama_tp2", hq, hkv, hd, window, cap, scale,
                               dtype, [28, 21, 17, 13], MAX_LEN, 200)
    q, k, v = (randn((1, BUCKET, h, hd), dtype, seed).transpose(1, 2)
               for h, seed in ((hq, 210), (hkv, 211), (hkv, 212)))
    cases["flash_attention[llama_tp2]"] = dict(
        call=lambda: kernels.flash_attention(q, k, v, scale=scale),
        plain=lambda: attention_ref(q, k, v, scale=scale),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True),
        bytes=(2 * BUCKET * hq * hd + 2 * BUCKET * hkv * hd) * es,
        flops=4 * (BUCKET * (BUCKET + 1) // 2) * hq * hd)
    w = randn((d,), dtype, 213) + 1.0
    wq = randn((d, f), dtype, 214, scale=0.02)
    for tag, rows in (("llama_tp2", MAX_BATCH), ("llama_tp2_prefill",
                                                 BUCKET)):
        x = randn((MAX_BATCH, 1, d) if rows == MAX_BATCH else (1, rows, d),
                  dtype, 215)
        cases[f"rmsnorm_matmul[{tag}]"] = dict(
            call=lambda x=x: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda x=x: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda x=x: torch.matmul(
                F.rms_norm(x, (d,), w, eps=1e-5), wq),
            bytes=(2 * rows * d + d + d * f + rows * f) * es,
            flops=2 * rows * d * f + 4 * rows * d)
    x = randn((MAX_BATCH, 1, d), dtype, 216)
    r = randn((MAX_BATCH, 1, d), dtype, 217)
    cases["residual_rmsnorm[llama_tp2]"] = dict(
        call=lambda: kernels.residual_rmsnorm(x, w, r),
        plain=lambda: residual_rmsnorm_ref(x, w, r),
        library=None,
        bytes=(4 * MAX_BATCH * d + d) * es, flops=5 * MAX_BATCH * d)
    return cases


def phase_kernels(cfg, rcfg) -> dict:
    """Kernel vs plain version at each main path's shapes (SmolLM-360M
    ``cfg``, RWKV-6 ``rcfg``); returns the bf16 rows (with the f32 error;
    an f32-only kernel's f32 rows), keyed as the cases are."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = {**main_path_cases(cfg, dtype), **flash_cases(cfg, dtype),
                 **decode_long_cases(cfg, dtype), **rwkv_cases(rcfg, dtype),
                 **dense_cases(dtype), **mq_cases(cfg, dtype),
                 **moe_cases(dtype), **xattn_cases(dtype),
                 **tp_cases(dtype)}
        for name, c in cases.items():
            out, ref = c["call"](), c["plain"]()
            err = max_err(out, ref)
            bound = rel_bound(ref, dtype)
            if not err <= bound:
                fail(f"{name} {dtype}: max |kernel - plain| {err:.3g} > "
                     f"{bound:.3g}")
            if c.get("finite") and not all(
                    torch.isfinite(o).all().item() for o in out):
                fail(f"{name} {dtype}: the kernel's output is not finite")
            if "contiguous" in c:
                c_err = max_err(out, c["contiguous"]())
                if not c_err <= bound:
                    fail(f"{name} {dtype}: max |paged - contiguous kernel| "
                         f"{c_err:.3g} > {bound:.3g}")
                print(f"phase 2: {name} {str(dtype)[6:]}: max |paged - "
                      f"contiguous kernel| on the same logical KV {c_err:.3g}"
                      f" (<= {bound:.3g})")
                rows.setdefault(name, {})[
                    f"vs_contiguous_max_abs_err_{str(dtype)[6:]}"] = c_err
            # f32: the error only (the rows keep bf16 times), unless the
            # kernel is f32 only
            if dtype == torch.float32 and not c.get("f32_only"):
                print(f"phase 2: {name:38s} float32   max_err {err:.3g} "
                      f"(<= {bound:.3g})")
                rows.setdefault(name, {})["max_abs_err_f32"] = err
                continue
            k_ms, k_host = time_ms(c["call"])
            p_ms, p_host = time_ms(c["plain"])
            lib_ms = time_ms(c["library"])[0] if c["library"] else None
            b_ms, by = bound_ms(c["bytes"], c["flops"], dtype)
            lib = "null" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
            # the pair of PyTorch calls a fused kernel replaces: not one
            # call, so not the library time
            unf_ms = time_ms(c["unfused"])[0] if "unfused" in c else None
            unf = ("" if unf_ms is None else
                   f"  unfused pair (F.rms_norm + torch.matmul) "
                   f"{unf_ms * 1e3:.2f} us")
            print(f"phase 2: {name:38s} {str(dtype)[6:]:9s} max_err "
                  f"{err:.3g} (<= {bound:.3g})  device: kernel "
                  f"{k_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  library "
                  f"{lib}{unf}  bound {b_ms * 1e3:.4f} us ({by});  host: "
                  f"kernel {k_host * 1e3:.2f} us  plain {p_host * 1e3:.2f} us")
            row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                       host_ms=k_host, plain_host_ms=p_host)
            if unf_ms is not None:
                row["unfused_pair_ms"] = unf_ms
            rows.setdefault(name, {})
            if dtype == torch.float32:
                rows[name]["max_abs_err_f32"] = err
            if dtype != torch.float32 or c.get("f32_only"):
                rows[name].update(row)
    return rows


def phase_dispatch_cost(cfg) -> dict:
    """What a wrapper's host time holds since the wrappers became
    ``torch.library`` custom ops: ``decode_attention`` at the decode step's
    shapes (bf16, B 4, lengths 28/21/17/13) through its wrapper, through
    its op overload (the dispatcher, no wrapper checks) and through its
    CUDA implementation called directly (no dispatcher); host µs a call,
    back to back, as phase 2 times them."""
    b, hq, hkv, hd = MAX_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch.bfloat16
    q = randn((b, hq, hd), dt, 3)
    k = randn((b, MAX_LEN, hkv, hd), dt, 1).transpose(1, 2)
    v = randn((b, MAX_LEN, hkv, hd), dt, 2).transpose(1, 2)
    lens = torch.tensor([28, 21, 17, 13], dtype=torch.int32, device=DEV)
    scale = hd ** -0.5
    calls = {
        "wrapper": lambda: kernels.decode_attention(q, k, v, lens,
                                                    scale=scale),
        "op_overload": lambda: kernels.decode_attention.op(
            q, k, v, lens, -1, scale, 0, 0.0),
        "cuda_implementation": lambda: _decode_launch(q, k, v, lens, -1,
                                                      scale, 0, 0.0),
    }
    ref = calls["cuda_implementation"]()
    for name, fn in calls.items():
        if not torch.equal(fn(), ref):
            fail(f"dispatch cost: decode_attention by {name} differs from "
                 "its CUDA implementation called directly")
    host = {name: time_ms(fn)[1] * 1e3 for name, fn in calls.items()}
    dispatcher = host["op_overload"] - host["cuda_implementation"]
    print("phase 2: decode_attention host us a call: "
          + ", ".join(f"{n} {t:.2f}" for n, t in host.items())
          + f"; the dispatcher's share {dispatcher:.2f} us, the wrapper's "
          f"own {host['wrapper'] - host['op_overload']:.2f} us")
    return host


# ------------------------------------------------------------------ phase 3
def compare_logits(a, b, tol, what):
    """max |a - b| <= tol, and argmax agrees except where b's top-2 gap is
    below tol.  Returns the max abs difference."""
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        fail(f"{what}: max |kernel - plain| logits {err:.3g} > {tol}")
    top2 = b.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flip = (a.argmax(-1) != b.argmax(-1)) & (gap >= tol)
    if flip.any():
        fail(f"{what}: {int(flip.sum())} argmax flips where the top-2 gap "
             f">= {tol}")
    return err


def kernel_vs_plain_logits(cfg, params, prompt, steps, label,
                           lens0=None) -> tuple:
    """f32 logits of ``prompt`` (B x S: a prefill into a fresh cache, then
    one batched decode step per entry of ``steps``, step i at the rows'
    lengths ``lens0 + i``, S by default; with ``steps`` None one forward
    without cache) through the kernels and through their plain versions;
    fails unless each call agrees within LOGIT_TOL_F32 (argmax too,
    outside near ties).  Returns (the largest difference, the kernels'
    logits of each call)."""
    b, n = prompt.shape
    lens0 = np.full(b, n) if lens0 is None else lens0
    out = {}
    for mode in ("kernel", "plain"):
        ctx = plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            if steps is None:
                out[mode] = [forward(params, prompt, cfg)[0]]
                continue
            cache = make_cache(cfg, b, MAX_LEN, device=DEV)
            logits, cache = forward(params, prompt, cfg, cache=cache)
            got = [logits]
            for i, tok in enumerate(steps):
                lg, cache = forward(params, tok, cfg, cache=cache,
                                    lengths=lens0 + i)
                got.append(lg)
            out[mode] = got
            del cache
    errs = [compare_logits(a, b_, LOGIT_TOL_F32, f"{label} call {i}")
            for i, (a, b_) in enumerate(zip(out["kernel"], out["plain"]))]
    got = out["kernel"]
    del out
    torch.cuda.empty_cache()
    return max(errs), got


def phase_logits_f32(cfg) -> None:
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg32, gen, device=DEV)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAX_BATCH, BUCKET)).astype(np.int64))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (MAX_BATCH, 1)))
             for _ in range(3)]
    lens0 = np.array([16, 9, 12, 5])       # ragged rows, as after prefills
    err, kernel_logits = kernel_vs_plain_logits(cfg32, params, prompt, steps,
                                                "f32 logits", lens0)
    print(f"phase 3: full-width {cfg.name} f32 ({cfg.n_layers} layers), "
          f"prefill (4 x {BUCKET}) + 3 decode steps: max |kernel - plain| "
          f"logits {err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees")

    # the paged path through its kernels against the contiguous one: each
    # row's prompt in chunks of CHUNK, then the same ragged decode steps
    n_pages = MAX_BATCH * (MAX_LEN // BLOCK)
    cache = make_paged_cache(cfg32, n_pages, BLOCK, device=DEV)
    tables = np.full((MAX_BATCH, MAX_LEN // BLOCK), n_pages, np.int32)
    tables[:, :2] = np.random.default_rng(1).permutation(n_pages)[
        :2 * MAX_BATCH].reshape(MAX_BATCH, 2)          # 32 positions a row
    n0 = kernels.launch_counts()
    pre = torch.empty_like(kernel_logits[0])
    for r in range(MAX_BATCH):
        for t0 in range(0, BUCKET, CHUNK):
            lg, cache = forward(params, prompt[r:r + 1, t0:t0 + CHUNK], cfg32,
                                cache=cache, cache_index=t0,
                                block_tables=tables[r:r + 1])
            pre[r, t0:t0 + CHUNK] = lg[0]
    got = [pre]
    for i, tok in enumerate(steps):
        lg, cache = forward(params, tok, cfg32, cache=cache,
                            lengths=lens0 + i, block_tables=tables)
        got.append(lg)
    n1 = kernels.launch_counts()
    L = cfg.n_layers
    if (n1["paged_decode_attention"] - n0["paged_decode_attention"] != 3 * L
            or n1["flash_attention"] - n0["flash_attention"]
            != MAX_BATCH * (BUCKET // CHUNK) * L):
        fail(f"phase 3 paged path launches {n0} -> {n1}")
    errs = [compare_logits(a, b, LOGIT_TOL_F32,
                           f"f32 paged vs contiguous logits call {i}")
            for i, (a, b) in enumerate(zip(got, kernel_logits))]
    print(f"phase 3: paged path (block {BLOCK}, chunks of {CHUNK}, then the "
          f"same 3 decode steps) vs the contiguous path, both with kernels: "
          f"max |paged - contiguous| logits {max(errs):.3g} "
          f"(<= {LOGIT_TOL_F32}), argmax agrees")
    del params, cache
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 4
def want_launches(cfg, attention: str = "", plan: str = "jit") -> tuple:
    """Hand-written kernel launches per decode step (``attention`` is the
    decode attention kernel of the path) and per prefill call under
    ``plan``.  ``jit`` launches the norms where the model calls them;
    ``fused`` too, its rules lowering RWKV-6's legacy-norm windows to
    ``residual_rmsnorm``; the other plans run the norms as their plain
    versions.  RWKV-6: ``wkv6`` L and 2L+1 norms in both."""
    L = cfg.n_layers
    zero = {name: 0 for name in kernels.WRAPPERS}
    norms = plan in ("jit", "fused")
    if tuple(cfg.block_pattern) == ("rwkv6",):
        name = "rmsnorm" if plan == "jit" else "residual_rmsnorm"
        per = {**zero, "wkv6": L, **({name: 2 * L + 1} if norms else {})}
        return per, dict(per)
    fused = norm_launches(cfg) if norms else {}
    n_attn = attention_launches(cfg)
    return ({**zero, **fused, attention: n_attn},
            {**zero, **fused, "flash_attention": n_attn})


def check_first_tokens(eng, done, cfg, route_tie=None) -> int:
    """The served first tokens against the plain versions on the same bf16
    weights: they may differ only where the plain top-2 gap is below
    LOGIT_TOL_BF16.  A MoE stack's capacity couples the tokens of a call,
    so there each prompt runs alone, as the engine's prefill row (padded to
    its bucket unless the stack prefills exactly); a wider gap is allowed
    there only where that row's prefill first routes a token to other
    experts at a plain top-k margin below ``route_tie`` (``check_routing``).
    Returns how many agree."""
    order = sorted(done, key=lambda r: r.rid)
    first = torch.tensor([r.generated[0] for r in order], device=DEV)
    last = torch.tensor([len(r.prompt) - 1 for r in order], device=DEV)
    if cfg.moe is None:
        width = max(len(r.prompt) for r in done)
        rows = [np.zeros(width, np.int64) for _ in order]
        groups = [list(range(len(order)))]
    else:
        rows = [np.zeros(len(r.prompt) if eng.exact_prefill
                         else eng._bucket(len(r.prompt)), np.int64)
                for r in order]
        groups = [[i] for i in range(len(order))]
    for row, r in zip(rows, order):
        row[:len(r.prompt)] = r.prompt
    plain = []
    with plain_kernels():
        for g in groups:
            toks = torch.from_numpy(np.stack([rows[i] for i in g]))
            logits, _ = forward(eng.params, toks, cfg, cache=served_cache(
                cfg, *toks.shape))
            plain.append(logits[torch.arange(len(g), device=DEV), last[g]])
    plain = torch.cat(plain)
    top2 = plain.topk(2, dim=-1).values
    flips = (plain.argmax(-1) != first) & (top2[:, 0] - top2[:, 1]
                                           >= LOGIT_TOL_BF16)
    for i in flips.nonzero().flatten().tolist() if cfg.moe else ():
        # routing is discontinuous: a set flip at a near tie in the row's
        # prefill moves its logits past any logit tolerance
        row = torch.from_numpy(rows[i][None])
        hit = first_set_flip(routed_experts(eng.params, cfg, row),
                             routed_experts(eng.params, cfg, row,
                                            tuple(PLAINS)))
        if hit is not None and hit[2] < route_tie:
            print(f"  routing near tie: request {order[i].rid}'s first "
                  f"token; its prefill routes position {hit[1]} of MoE call "
                  f"{hit[0]} to experts {hit[3]} through the kernels and "
                  f"{hit[4]} through the plain versions, plain top-k margin "
                  f"{hit[2]:.3g} < {route_tie:.3g}")
            flips[i] = False
    if flips.any():
        fail(f"{int(flips.sum())} served first tokens disagree with the "
             f"plain bf16 forward where its top-2 gap >= {LOGIT_TOL_BF16}")
    return int((plain.argmax(-1) == first).sum())


def serve_argv(cfg, extra, plan: str) -> list:
    return ["--arch", cfg.name, "--requests", str(N_REQ), "--max-batch",
            str(MAX_BATCH), "--max-len", str(MAX_LEN), "--device", "cuda",
            "--plan", plan, *extra]


def phase_serve(cfg, phase: int, extra=()) -> tuple:
    """``repro_torch.launch.serve --plan eager`` at full width in bf16
    (warmup + measured run), with every launch count reset just before and
    read just after.  ``extra`` selects the cache; the launches must match
    the path's table per decode step and per prefill call (a prefill chunk
    when paged).  Returns (counts, report, engine, finished requests)."""
    argv = serve_argv(cfg, extra, "eager")
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase {phase}: serve {' '.join(argv)}")
    print(f"  report {json.dumps(rep)}")
    print(f"  launches (warmup + measured run) {counts}")
    st = eng.stats
    if len(done) != N_REQ or any(r.status != "done" for r in done):
        fail(f"serve finished {len(done)} of {N_REQ} requests")
    for r in done:
        if len(r.generated) != 16 or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"request {r.rid} generated {r.generated}")
    paged = eng.kv is not None
    want_step, want_pre = want_launches(
        cfg, "paged_decode_attention" if paged else "decode_attention",
        "eager")
    if st.kernel_launches_per_decode_step != want_step:
        fail(f"launches per decode step {st.kernel_launches_per_decode_step}"
             f" != {want_step}")
    n_pre = st.prefill_chunks if paged else st.prefills
    if st.prefill_kernel_launches != n_pre * sum(want_pre.values()):
        fail(f"prefill launches {st.prefill_kernel_launches} != "
             f"{n_pre} x {sum(want_pre.values())}")
    runs = 2                               # warmup + measured, same schedule
    want = {name: runs * (st.decode_steps * want_step[name]
                          + n_pre * want_pre[name]) for name in want_step}
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    agree = check_first_tokens(eng, done, cfg)
    print(f"  served first tokens agree with the plain bf16 forward: "
          f"{agree}/{N_REQ}")
    return counts, rep, eng, done


# ------------------------------------------------------------------ phase 5
# decode steps (and prefills) a trace times and profiles: the per-step
# numbers are means over them, and an eager step's profile (thousands of
# kernels and host ops) takes seconds to collect and read back
TRACE_STEPS = 3
# device kernel names of the hand-written kernels (csrc/*.cu)
HAND_KERNELS = ("flash_attention", "residual_rmsnorm_kernel",
                "rmsnorm_matmul", "decode_attention", "wkv6")


def device_times(run):
    """Profile ``run``: ({kernel name: (device us, launches)} over the run,
    or None when the profiler saw no device events; the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None, prof
    by = {}
    for e in kern:
        t, n = by.get(e.name, (0.0, 0))
        by[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return by, prof


def print_hand_kernels(by, calls: int, per: str) -> None:
    """The hand-written kernels' device time inside the profiled run."""
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        if any(h in name for h in HAND_KERNELS):
            print(f"  in {per}: {name[:60]} {n / calls:.0f} calls, "
                  f"{t / calls:.1f} us/{per}, {t / n:.2f} us/call")


def events_busy_ms(step, steps: int) -> float:
    """Device ms per call of ``step`` between CUDA events around it (each
    call waited for), where the profiler sees no device events."""
    total = 0.0
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / steps


def phase_trace(eng, label: str, prefill: bool = False,
                steps: int = TRACE_STEPS) -> dict:
    """Decode-step wall time, device time by kernel from torch.profiler
    (kernels run in order on one stream, so their sum is the busy time) and
    the host ops with the most self time, for the engine's cache (a paged
    engine steps rows that own two pages each).  With ``prefill``, also the
    device time of a slot's prefill (the serve CLI's 12-token prompt, padded
    to its bucket for attention), with the hand-written kernels' share.
    Returns the step's wall, host (the backend call) and device-busy ms,
    its device kernels and how busy was measured.  Under ``plan="jit"``
    each call replays the engine's captured graph for its signature."""
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                         (MAX_BATCH, 1)))
    lens = np.array([20, 20, 20, 20])
    if eng.kv is None:
        def step():
            return eng.backend.decode(eng.cache, toks, lens)
    else:
        bt = np.full((MAX_BATCH, eng.kv.nb_per_slot), eng.kv.sentinel,
                     np.int32)
        bt[:, :2] = np.arange(2 * MAX_BATCH).reshape(MAX_BATCH, 2)

        def step():
            return eng.backend.paged_decode(eng.cache, toks, lens, bt)

    host = []

    def run():
        for _ in range(steps):
            logits, _ = step()
            host.append(eng.backend.last.host_time_s)
            logits.cpu()                   # the engine's host argmax sync

    run()
    torch.cuda.synchronize()
    host.clear()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    out = dict(wall_ms=wall_ms, host_ms=float(np.mean(host)) * 1e3)
    by, prof = device_times(run)
    if by is None:
        out.update(busy_ms=events_busy_ms(lambda: step()[0].cpu(), steps),
                   kernels=None, busy_by="CUDA events")
        print(f"{label}: decode step wall {wall_ms:.3f} ms; the profiler "
              "reported no device events; CUDA events around each call: "
              f"{out['busy_ms']:.3f} ms")
        return out
    busy_ms = sum(t for t, _ in by.values()) / steps / 1e3
    n_kern = sum(n for _, n in by.values()) / steps
    out.update(busy_ms=busy_ms, kernels=n_kern, busy_by="profiler")
    print(f"{label}: decode step (batch {MAX_BATCH}, kv len 20): wall "
          f"{wall_ms:.3f} ms/step unprofiled, host {out['host_ms']:.3f} "
          f"ms/step (the backend call); profiled: device busy "
          f"{busy_ms:.3f} ms/step ({busy_ms / wall_ms:.1%} of the unprofiled "
          f"wall), {n_kern:.0f} device kernels/step")
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / steps:9.1f} us/step {n / steps:6.1f}x  {name[:90]}")
    print_hand_kernels(by, steps, "step")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print("  host ops by profiled self time: " + ", ".join(
        f"{a.key} {a.self_cpu_time_total / steps:.0f} us/step "
        f"({a.count / steps:.0f}x)" for a in ops[:8]))
    if not prefill:
        return out
    width = PROMPT if is_recurrent(eng.cfg) else BUCKET
    prompt = torch.from_numpy(rng.integers(0, eng.cfg.vocab_size,
                                           (1, width)))

    def prefills():
        for _ in range(steps):
            logits, _ = eng.backend.prefill(eng.cache, prompt, 0, PROMPT)
            logits.cpu()

    prefills()
    by, _ = device_times(prefills)
    if by is None:
        print(f"{label} prefill: the profiler reported no device events")
        return out
    busy_ms = sum(t for t, _ in by.values()) / steps / 1e3
    out["prefill_busy_ms"] = busy_ms
    print(f"{label} prefill (1 x {width}, slot 0): device busy "
          f"{busy_ms:.3f} ms/prefill, "
          f"{sum(n for _, n in by.values()) / steps:.0f} device kernels")
    print_hand_kernels(by, steps, "prefill")
    return out


# ------------------------------------------------------------------ phase 7
PRESSURE_BLOCKS = 8        # int8 pool of 8 x 16 tokens for 4 slots of 128


def pressure_requests(vocab: int) -> list:
    """Eight requests, four of which share a 32-token prompt prefix: the
    first decodes long, so its pages are live when the other three arrive;
    the rest have 20-token prompts of their own."""
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(0, vocab, 32)]
    shapes = [(True, 48), (False, 8), (False, 8), (False, 8),
              (True, 16), (True, 16), (True, 16), (False, 16)]
    reqs = []
    for rid, (shared, budget) in enumerate(shapes):
        own = [int(t) for t in rng.integers(0, vocab, 8 if shared else 20)]
        reqs.append(Request(rid, prompt=(prefix if shared else []) + own,
                            max_new_tokens=budget))
    return reqs


def plain_int8_logits(params, cfg, toks) -> torch.Tensor:
    """Next-token logits after ``toks`` through the plain versions over an
    int8 paged pool of one row, prefilled in chunks of CHUNK as the engine
    does."""
    n_pages = -(-len(toks) // BLOCK)
    cache = make_paged_cache(cfg, n_pages, BLOCK, kv_dtype="int8",
                             device=DEV)
    table = np.full((1, MAX_LEN // BLOCK), n_pages, np.int32)
    table[0, :n_pages] = np.arange(n_pages)
    with plain_kernels():
        for t0 in range(0, len(toks), CHUNK):
            chunk = torch.tensor([toks[t0:t0 + CHUNK]])
            logits, cache = forward(params, chunk, cfg, cache=cache,
                                    cache_index=t0, block_tables=table)
    return logits[0, -1]


def served_cache(cfg, b: int, n: int):
    """The cache a plain forward of ``b`` x ``n`` served tokens needs: none,
    or for a cross stack one holding the served one-row zero cross cache
    (the engine's ``src_len=1``)."""
    return make_cache(cfg, b, n, src_len=1, device=DEV) if has_cross(cfg) \
        else None


def plain_logits(params, cfg, toks) -> torch.Tensor:
    """Next-token logits after ``toks`` through the plain versions, the
    whole sequence in one forward (bf16; no cache, or a cross stack's
    served one)."""
    with plain_kernels():
        logits, _ = forward(params, torch.tensor([toks]), cfg,
                            cache=served_cache(cfg, 1, len(toks)))
    return logits[0, -1]


def check_near_ties(done, ref_done, params, cfg, names,
                    plain=plain_int8_logits, route_tie=None,
                    ref_plains=tuple(PLAINS)) -> int:
    """One run's tokens against another's of the same requests (the
    pressured int8 run against an unpressured one; jit against eager).  A
    request may diverge only where the plain versions (``plain``: over
    int8 pages by default) put the two tokens within LOGIT_TOL_BF16 of
    each other, or, in a MoE stack, where that request's own prefix (its
    prompt and the tokens both runs served) replayed alone routes a token
    to other experts through the kernels than with ``ref_plains`` run as
    their plain versions (the other run's arithmetic), its first such flip
    at a plain top-k margin below ``route_tie`` (``check_routing``):
    routing is discontinuous, so one flip moves the logits past any logit
    tolerance.  Its later tokens are then not compared.  ``names`` label
    the two runs.  Returns how many requests agree entirely."""
    ref = {r.rid: r for r in ref_done}
    same = 0
    for r in done:
        want = ref[r.rid].generated
        i = next((i for i, (a, b) in enumerate(zip(r.generated, want))
                  if a != b), None)
        if i is None:
            same += 1
            continue
        logits = plain(params, cfg, r.prompt + want[:i])
        gap = (logits[want[i]] - logits[r.generated[i]]).abs().item()
        if cfg.moe is not None and not gap < LOGIT_TOL_BF16:
            prefix = torch.tensor([r.prompt + want[:i]], device=DEV)
            hit = first_set_flip(
                routed_experts(params, cfg, prefix),
                routed_experts(params, cfg, prefix, ref_plains))
            if hit is None or not hit[2] < route_tie:
                fail(f"{names}: request {r.rid} token {i} is "
                     f"{r.generated[i]} {names[0]} and {want[i]} {names[1]} "
                     f"(plain logits {gap:.3g} apart), and its prefix "
                     "replayed alone "
                     + ("routes every token alike" if hit is None else
                        f"first routes position {hit[1]} of MoE call "
                        f"{hit[0]} apart at a plain top-k margin "
                        f"{hit[2]:.3g} >= {route_tie:.3g}"))
            print(f"  routing near tie: request {r.rid} token {i} is "
                  f"{r.generated[i]} {names[0]} and {want[i]} {names[1]} "
                  f"(plain logits {gap:.3g} apart); its {len(r.prompt) + i}"
                  f"-token prefix replayed alone first routes position "
                  f"{hit[1]} of MoE call {hit[0]} to experts {hit[3]} "
                  f"through the kernels and {hit[4]} through the other "
                  f"run's arithmetic, plain top-k margin {hit[2]:.3g} < "
                  f"{route_tie:.3g}")
            continue
        if not gap < LOGIT_TOL_BF16:
            fail(f"{names}: request {r.rid} token {i} is "
                 f"{r.generated[i]} {names[0]} and {want[i]} {names[1]}; "
                 f"their plain int8 logits differ by {gap:.3g} >= "
                 f"{LOGIT_TOL_BF16}")
        print(f"  near tie: request {r.rid} token {i} is {r.generated[i]} "
              f"{names[0]} and {want[i]} {names[1]}; their plain "
              f"logits differ by {gap:.3g} < {LOGIT_TOL_BF16}")
    return same


PRESSURE_OPTS = dict(max_batch=MAX_BATCH, max_len=MAX_LEN, device=DEV,
                     cache="paged", kv_dtype="int8", block_size=BLOCK,
                     prefill_chunk=CHUNK, share_prefix=True)


def serve_pressured(cfg, params, plan: str, phase: int) -> tuple:
    """The pool-pressure engine under ``plan``: a warmup run, then the
    measured run with the launch counts reset just before; it must
    preempt, offload, restore and share.  Returns (engine, finished
    requests, counts, report)."""
    eng = ServeEngine(cfg, params, offload="host", plan=plan,
                      num_blocks=PRESSURE_BLOCKS, **PRESSURE_OPTS)
    eng.run(pressure_requests(cfg.vocab_size))
    eng.reset()
    reqs = pressure_requests(cfg.vocab_size)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats
    rep = serve.report(eng, done, wall)
    print(f"phase {phase}: pool pressure, int8 pages, {PRESSURE_BLOCKS} "
          f"blocks of {BLOCK}, chunks of {CHUNK}, prefix sharing, host "
          f"offload, plan {plan}")
    print(f"  report {json.dumps(rep)}")
    print(f"  launches (measured run) {counts}")
    if len(done) != len(reqs) or any(
            r.status != "done" or len(r.generated) != r.max_new_tokens
            for r in done):
        fail(f"pool pressure finished {len(done)} of {len(reqs)} requests")
    if not (st.preemptions > 0 and st.prefix_adoptions > 0
            and st.offload_bytes == st.restore_bytes > 0):
        fail(f"pool pressure: preemptions {st.preemptions}, adoptions "
             f"{st.prefix_adoptions}, offload {st.offload_bytes} B, restore "
             f"{st.restore_bytes} B")
    return eng, done, counts, rep


def phase_pool_pressure(cfg, params) -> tuple:
    """``ServeEngine(plan="eager")`` at full width with an int8 paged pool
    too small for the load, chunked prefill, prefix sharing and host
    offload (``serve_pressured``).  Its tokens are then held against the
    same requests served from the default int8 pool, where nothing is
    preempted or offloaded."""
    eng, done, counts, rep = serve_pressured(cfg, params, "eager", 7)
    st, tier = eng.stats, eng.offload_tier
    want_step, want_pre = want_launches(cfg, "paged_decode_attention_quant",
                                        "eager")
    if st.kernel_launches_per_decode_step != want_step:
        fail(f"launches per decode step {st.kernel_launches_per_decode_step}"
             f" != {want_step}")
    if st.prefill_kernel_launches != st.prefill_chunks * sum(
            want_pre.values()):
        fail(f"prefill launches {st.prefill_kernel_launches} != "
             f"{st.prefill_chunks} x {sum(want_pre.values())}")
    want = {name: st.decode_steps * want_step[name]
            + st.prefill_chunks * want_pre[name] for name in want_step}
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    roomy = ServeEngine(cfg, params, plan="eager", **PRESSURE_OPTS)
    free_done = roomy.run(pressure_requests(cfg.vocab_size))
    if roomy.stats.preemptions or len(free_done) != len(done):
        fail(f"the unpressured int8 run preempted {roomy.stats.preemptions} "
             f"times and finished {len(free_done)} of {len(done)} requests")
    same = check_near_ties(done, free_done, params, cfg,
                           ("under pressure", "without"))
    print(f"  tokens agree with the same requests in the default "
          f"{roomy.kv.num_blocks}-block int8 pool (no preemption, no "
          f"offload): {same}/{len(done)} requests token for token")
    del roomy
    copy_s = tier.measured_copy_s
    if not copy_s > 0:
        fail(f"{tier.timed_copies} offload copies timed at {copy_s} s")
    print(f"  {rep['tok_per_s']:.2f} tok/s, mean TTFT "
          f"{rep['mean_ttft_ms']:.2f} ms, mean ITL {rep['mean_itl_ms']:.2f} "
          f"ms, launch tax {rep['measured_launch_tax_per_step_us']:.1f} "
          f"us/step; {st.preemptions} preemptions, {st.prefix_adoptions} "
          f"prefix adoptions ({st.shared_prefix_tokens} tokens), "
          f"{eng.kv.pool.cow_copies_total} copy-on-write copies")
    print(f"  offload: {st.offload_bytes} B out, {st.restore_bytes} B back "
          f"in {st.offload_transfers} block transfers; measured copy time "
          f"{copy_s * 1e6:.1f} us over {tier.timed_copies} copies (one "
          f"pinned buffer per eviction or restore, CUDA events), "
          f"{(st.offload_bytes + st.restore_bytes) / copy_s / 1e9:.2f} GB/s,"
          f" vs modeled tax {st.modeled_offload_tax_s * 1e6:.1f} us "
          f"({eng.platform} link)")
    return counts, rep, eng, done


# ------------------------------------------------------------------ phase 8
RWKV_LOGIT_LAYERS = 4      # depth of the free-running f32 logits check


@contextlib.contextmanager
def checked_rwkv_kernels():
    """Run every ``wkv6`` and ``rmsnorm`` call through its kernel and its
    plain version on the same inputs (the plain one first, before the
    kernel writes the state in place); fail unless they agree within TOL;
    return the kernel's result.  Yields {name: [calls, max error]}."""
    saved = {name: getattr(kernels, name) for name in ("wkv6", "rmsnorm")}
    seen = {name: [0, 0.0] for name in saved}

    def note(name, out, ref):
        err, bound = max_err(out, ref), rel_bound(ref, torch.float32)
        if not err <= bound:
            fail(f"phase 8: {name} call {seen[name][0]} on the model's "
                 f"activations: max |kernel - plain| {err:.3g} > "
                 f"{bound:.3g}")
        seen[name] = [seen[name][0] + 1, max(seen[name][1], err)]

    def rmsnorm(x, weight, residual=None, *, eps):
        out = saved["rmsnorm"](x, weight, residual, eps=eps)
        note("rmsnorm", out, rmsnorm_ref(x, weight, residual, eps))
        return out

    def wkv6(r, k, v, logw, u, s0, *, s_out=None):
        ref = wkv6_ref(r, k, v, logw, u, s0)
        out = saved["wkv6"](r, k, v, logw, u, s0, s_out=s_out)
        note("wkv6", out, ref)
        return out

    kernels.rmsnorm, kernels.wkv6 = rmsnorm, wkv6
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def rwkv_run(params, cfg, prompt, steps, ctx) -> list:
    """Logits of a prefill of ``prompt`` and one decode step per entry of
    ``steps``, from a fresh cache, under ``ctx``."""
    with ctx:
        cache = make_cache(cfg, prompt.shape[0], MAX_LEN, device=DEV)
        logits, cache = forward(params, prompt, cfg, cache=cache)
        got = [logits]
        for i, tok in enumerate(steps):
            lg, cache = forward(params, tok, cfg, cache=cache,
                                lengths=np.full(tok.shape[0],
                                                prompt.shape[1] + i))
            got.append(lg)
    return got


def phase_logits_rwkv(cfg) -> None:
    """Full-width RWKV-6 3B in f32: a PROMPT-token prefill of MAX_BATCH
    rows and 3 batched decode steps.  (a) At full depth, every kernel call
    is held against its plain version on the model's own activations.  (b)
    Free-running logits, kernels against plain versions, within
    LOGIT_TOL_F32 at RWKV_LOGIT_LAYERS layers.  With these random weights
    the f32 function is ill-conditioned in depth: a rounding difference of
    one ulp grows layer by layer, so (c) prints, unchecked, the 32-layer
    logits of kernels against plain and of the plain versions at batch
    MAX_BATCH against the same rows one at a time (other GEMM kernels)."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(1),
                         device=DEV)
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, PROMPT)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, 1)))
             for _ in range(3)]
    n0 = kernels.launch_counts()
    with checked_rwkv_kernels() as seen:
        full = rwkv_run(params, cfg32, prompt, steps,
                        contextlib.nullcontext())
    n1 = kernels.launch_counts()
    want_step, _ = want_launches(cfg32)
    if {k: n1[k] - n0[k] for k in n1} != {k: 4 * v
                                          for k, v in want_step.items()}:
        fail(f"phase 8 launches {n0} -> {n1}")
    print(f"phase 8: full-width {cfg.name} f32, {cfg.n_layers} layers, "
          f"prefill ({MAX_BATCH} x {PROMPT}) + 3 decode steps: every "
          f"kernel call against its plain version on the same activations:"
          f" " + ", ".join(f"{n} {c} calls, max err {e:.3g}"
                           for n, (c, e) in seen.items())
          + f" (<= {TOL['torch.float32']} x max(1, |plain|))")
    small = cfg32.replace(n_layers=RWKV_LOGIT_LAYERS)
    sub = {**params, "blocks": params["blocks"][:RWKV_LOGIT_LAYERS]}
    got = rwkv_run(sub, small, prompt, steps, contextlib.nullcontext())
    ref = rwkv_run(sub, small, prompt, steps, plain_kernels())
    errs = [compare_logits(a, b, LOGIT_TOL_F32, f"rwkv f32 logits call {i}")
            for i, (a, b) in enumerate(zip(got, ref))]
    print(f"  {RWKV_LOGIT_LAYERS} layers, free running: max |kernel - "
          f"plain| logits {max(errs):.3g} (<= {LOGIT_TOL_F32}), argmax "
          f"agrees")
    plain_full = rwkv_run(params, cfg32, prompt, steps, plain_kernels())
    with plain_kernels():
        rows = torch.cat([forward(params, prompt[i:i + 1], cfg32)[0]
                          for i in range(MAX_BATCH)])
    torch.cuda.synchronize()
    drift = max((a - b).abs().max().item() for a, b in zip(full, plain_full))
    print(f"  {cfg.n_layers} layers, free running (not checked): max "
          f"|kernel - plain| logits {drift:.3g}; plain at batch {MAX_BATCH}"
          f" vs the same rows one at a time, prefill "
          f"{(plain_full[0] - rows).abs().max().item():.3g}")
    del params, full, plain_full, got, ref, rows
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
def first_difference(params, cfg, prompt, served: list) -> tuple:
    """Run the unpadded incremental forward (the prompt in one call, then
    one token per call, batch 1) greedily beside the ``served`` tokens.
    Returns (index of the first token that differs, or None; the
    incremental logits' gap between the two tokens there)."""
    cache = make_cache(cfg, 1, MAX_LEN, device=DEV)
    logits, cache = forward(params, torch.tensor([prompt]), cfg, cache=cache)
    for i, tok in enumerate(served):
        row = logits[0, -1]
        mine = int(row.argmax())
        if mine != tok:
            return i, (row[mine] - row[tok]).abs().item()
        logits, cache = forward(params, torch.tensor([[tok]]), cfg,
                                cache=cache,
                                lengths=np.array([len(prompt) + i]))
    return None, 0.0


def check_rwkv_streams(cfg) -> None:
    """An f32 engine at full width and 2 layers serves the CLI's requests
    (PROMPT-token prompts, 16 new tokens, max_batch 4); every request's
    whole token stream must equal the unpadded incremental forward's.  A
    prompt padded to its bucket (16) would run 4 pad tokens through the
    recurrence and diverge.  Batched decode and batch-1 decode may round
    differently, so a stream may part only where the incremental logits of
    the two tokens lie within LOGIT_TOL_F32; it is not compared further."""
    cfg2 = cfg.replace(n_layers=2, param_dtype="float32",
                       compute_dtype="float32")
    params = init_params(cfg2, torch.Generator(device=DEV).manual_seed(2),
                         device=DEV)
    eng = ServeEngine(cfg2, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan="eager", device=DEV)
    done = eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    if len(done) != N_REQ or any(len(r.generated) != 16 for r in done):
        fail(f"phase 9 f32 streams: {len(done)} requests finished")
    same = 0
    for r in done:
        i, gap = first_difference(params, cfg2, r.prompt, r.generated)
        if i is None:
            same += 1
        elif not gap < LOGIT_TOL_F32:
            fail(f"phase 9 f32 streams: request {r.rid} token {i} is "
                 f"{r.generated[i]} served and differs from the unpadded "
                 f"incremental forward by {gap:.3g} >= {LOGIT_TOL_F32}")
    print(f"phase 9: f32 {cfg.name} at 2 layers, {N_REQ} requests of "
          f"{PROMPT}-token prompts, 16 new tokens: {same}/{N_REQ} whole "
          f"streams equal the unpadded incremental forward")
    del eng, params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
PAGED = ["--cache", "paged", "--block-size", str(BLOCK)]
# cell -> (config: "smollm" or "rwkv", serve flags, trace a prefill too)
JIT_CELLS = {"contiguous": ("smollm", [], True),
             "paged_bf16": ("smollm", PAGED, False),
             "paged_int8_pressure": ("smollm", None, False),
             "rwkv": ("rwkv", [], True)}


def cell_row(rep, trace) -> dict:
    """One plan's numbers in a cell: the measured serve run's (decode step
    wall and host ms, tok/s, TTFT, ITL, graphs) and the trace's."""
    return dict(
        step_ms=rep["mean_decode_step_ms"],
        host_ms=rep["measured_launch_tax_per_decode_step_us"] / 1e3,
        trace_wall_ms=trace["wall_ms"], trace_host_ms=trace["host_ms"],
        busy_ms=trace["busy_ms"], busy_by=trace["busy_by"],
        idle=1.0 - trace["busy_ms"] / trace["wall_ms"],
        kernels=trace["kernels"],
        prefill_busy_ms=trace.get("prefill_busy_ms"),
        tok_per_s=rep["tok_per_s"], mean_ttft_ms=rep["mean_ttft_ms"],
        p50_itl_ms=rep["p50_itl_ms"], p99_itl_ms=rep["p99_itl_ms"],
        dispatches=rep["dispatches_per_decode_step"],
        graphs=rep["graphs_captured"], capture_s=rep["graph_capture_s"],
        graph_mb=rep["graph_memory_bytes"] / 2 ** 20,
        peak_pool=rep["block_pool_utilization"]["peak"])


def attention_of(eng) -> str:
    if eng.kv is None:
        return "decode_attention"
    return ("paged_decode_attention_quant" if eng.kv_dtype == "int8"
            else "paged_decode_attention")


def check_launches(cell, plan, eng, rep) -> None:
    """The path's hand-written launches per decode step and per prefill
    call (a prefill chunk when paged) under ``plan``."""
    want_step, want_pre = want_launches(eng.cfg, attention_of(eng), plan)
    got = {k: v for k, v in rep["kernel_launches_per_decode_step"].items()
           if v}
    if got != {k: v for k, v in want_step.items() if v}:
        fail(f"{cell} {plan}: launches per decode step {got} != "
             f"{want_step}")
    n_pre = rep["prefill_chunks"] if eng.kv is not None else rep["prefills"]
    if rep["prefill_kernel_launches"] != n_pre * sum(want_pre.values()):
        fail(f"{cell} {plan}: prefill launches "
             f"{rep['prefill_kernel_launches']} != {n_pre} x "
             f"{sum(want_pre.values())}")


def check_jit(cell, rep, erep, done, edone, params, cfg,
              route_tie=None) -> None:
    """The jit run against the eager run of the same cell: the same
    requests finished, one dispatch per decode step, the jit path's
    launches; tokens equal eager's except at a near tie (eager runs the
    norms as their plain bf16 versions: other arithmetic; in a MoE stack
    a routing near tie below ``route_tie``)."""
    if len(done) != len(edone) or any(r.status != "done" for r in done):
        fail(f"{cell} jit: finished {len(done)} of {len(edone)} requests")
    if rep["dispatches_per_decode_step"] != 1.0:
        fail(f"{cell} jit: {rep['dispatches_per_decode_step']} dispatches "
             "per decode step, not 1")
    if rep["decode_steps"] != erep["decode_steps"]:
        fail(f"{cell} jit: {rep['decode_steps']} decode steps, eager "
             f"{erep['decode_steps']}")
    plain = (plain_int8_logits if cell == "paged_int8_pressure"
             else plain_logits)
    same = check_near_ties(done, edone, params, cfg,
                           ("under jit", "under eager"), plain, route_tie,
                           EAGER_PLAINS)
    print(f"  {cell}: jit tokens equal eager's in {same}/{len(done)} "
          f"requests (the rest part at a printed near tie); 1 dispatch per "
          f"decode step (eager {erep['dispatches_per_decode_step']:.0f}); "
          "launches per decode step and per prefill as the jit path's")


def serve_cell(cell, c, params, plan: str, phase: int) -> tuple:
    """Serve ``cell`` under ``plan`` (warmup + measured run) with the
    launch counts reset just before and read just after.  Returns
    (engine, finished requests, report, counts)."""
    extra = JIT_CELLS[cell][1]
    if extra is None:
        eng, done, counts, rep = serve_pressured(c, params, plan, phase)
        return eng, done, rep, counts
    return serve_flags(c, extra, plan, phase)


def serve_flags(c, extra, plan: str, phase: int) -> tuple:
    """``repro_torch.launch.serve`` of ``c`` with the cache flags ``extra``
    under ``plan``, counted as ``serve_cell`` does."""
    argv = serve_argv(c, extra, plan)
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        eng, done = serve.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase {phase}: serve {' '.join(argv)}")
    print(f"  report {json.dumps(rep)}")
    return eng, done, rep, counts


def print_row(phase: int, cell: str, plan: str, r: dict) -> None:
    pre = ("" if r["prefill_busy_ms"] is None else
           f", prefill busy {r['prefill_busy_ms']:.3f} ms")
    print(f"phase {phase}: {cell} {plan}: decode step {r['step_ms']:.3f}"
          f" ms wall, {r['host_ms']:.3f} ms host (serve); trace: "
          f"{r['trace_wall_ms']:.3f} ms wall, {r['trace_host_ms']:.3f}"
          f" ms host, {r['busy_ms']:.3f} ms device busy "
          f"({r['busy_by']}), idle {r['idle']:.1%}{pre}; "
          f"{r['tok_per_s']:.1f} tok/s, mean TTFT "
          f"{r['mean_ttft_ms']:.2f} ms, ITL p50 {r['p50_itl_ms']:.3f}"
          f" / p99 {r['p99_itl_ms']:.3f} ms; {r['dispatches']:.0f} "
          f"dispatches/step; {r['graphs']} graphs, "
          f"{r['capture_s']:.3f} s capture, {r['graph_mb']:.1f} MiB")


def phase_jit(cfg, rcfg, eager: dict) -> tuple:
    """Phase 11: each cell served again under ``--plan jit`` (the int8
    pool-pressure engine under ``plan="jit"``, with the paged run's
    weights), checked against its eager run (``eager[cell]``: report,
    finished requests, trace) and traced as in phases 5-10.  Returns
    ({cell: {plan: numbers}}, {cell: finished jit requests}, {cell: launch
    counts of the jit run})."""
    rows, jit_done, counts, params = {}, {}, {}, None
    for cell, (arch, extra, prefill) in JIT_CELLS.items():
        c = cfg if arch == "smollm" else rcfg
        erep, edone, etrace = eager[cell]
        eng, done, rep, counts[cell] = serve_cell(cell, c, params, "jit", 11)
        check_jit(cell, rep, erep, done, edone, eng.params, c)
        check_launches(cell, "jit", eng, rep)
        trace = phase_trace(eng, f"phase 11 {cell} jit trace", prefill)
        rows[cell] = {"eager": cell_row(erep, etrace),
                      "jit": cell_row(rep, trace)}
        jit_done[cell] = done
        for plan, r in rows[cell].items():
            print_row(11, cell, plan, r)
        params = eng.params if cell == "paged_bf16" else None
        del eng
        torch.cuda.empty_cache()
    print("phase 11: " + json.dumps(rows))
    return rows, jit_done, counts


# ------------------------------------------------------------------ phase 12
# cell -> the launch plans phase 12 serves it under
PLAN_CELLS = {"contiguous": ("whole_graph", "chain", "auto", "fused"),
              "paged_bf16": ("auto", "fused"),
              "paged_int8_pressure": ("auto", "fused"),
              "rwkv": ("auto", "fused")}
EQ1_BATCHES = (1, 2, 4)
# profiles per point of the Eq. 1 timeline (the median is kept), and
# profiles tried: the profiler's host and device clocks sometimes disagree
# by microseconds to milliseconds (kernels then seem to start before their
# launch call), and such a profile is discarded.  How often varies from
# process to process on an H100, from a few profiles to nearly all; a
# point with no profile left is printed as not measured
# cut in depth for the script's time limit (PERF.md section 4)
EQ1_PROFILES, EQ1_ATTEMPTS = 2, 6


def planned(eng, decode: bool) -> list:
    """The engine's planned bodies: its decode step(s) or its prefills."""
    kinds = ("decode", "paged_decode") if decode else ("prefill",
                                                       "paged_prefill")
    return [pf for key, pf in eng.backend._planned_fns.items()
            if key[0] in kinds]


def rule_hits_per_call(pfs) -> list:
    """Each planned body's fused rule hits, one call's worth."""
    return [{n: pf.rule_names.count(n) for n in sorted(set(pf.rule_names))}
            for pf in pfs]


def plan_row(rep, trace, eng) -> dict:
    dec, pre = planned(eng, True), planned(eng, False)
    pf = eng.backend.planned_decode
    n_pre = rep["prefill_chunks"] if eng.kv is not None else rep["prefills"]
    return dict(
        cell_row(rep, trace),
        prefill_dispatches=sorted({p.n_launches for p in pre}),
        launches_per_step={k: v for k, v in
                           rep["kernel_launches_per_decode_step"].items()
                           if v},
        launches_per_prefill=rep["prefill_kernel_launches"] / max(n_pre, 1),
        rule_hits_per_call=rule_hits_per_call(dec + pre),
        modeled_tklqt_us=pf.modeled_tklqt_s * 1e6,
        trace_nodes=len(pf.trace.kernels), trace_s=pf.trace.seconds,
        plan_s=rep["trace_s"])


def auto_candidates(eng) -> list:
    """The plans ``auto`` chose from for the decode step (the cost-aware
    partition and each chain length), with their modeled TKLQT and IL on
    the ``Intel+H100`` row; printed, the chosen one first."""
    choice = Planner(eng.backend.planned_decode.trace, "Intel+H100").auto()
    out = [dict(strategy=e.plan.strategy, length=e.plan.length,
                dispatches=e.plan.n_launches, tklqt_us=e.tklqt * 1e6,
                il_us=e.il * 1e6) for e in choice.evaluated]
    print("  auto's candidates for the decode step (modeled, Intel+H100): "
          + "; ".join(f"{c['strategy']}"
                      + (f" L={c['length']}" if c["length"] else "")
                      + f" {c['dispatches']} dispatches, TKLQT "
                      f"{c['tklqt_us']:.1f} us, IL {c['il_us']:.1f} us"
                      for c in out))
    return out


def check_fused(cell, eng, done, jit_done) -> None:
    """fused serves jit's tokens (the same kernels on the same inputs) and
    finds the model's norm windows in every call."""
    want = {r.rid: r.generated for r in jit_done}
    bad = [r.rid for r in done if r.generated != want[r.rid]]
    if bad or len(done) != len(jit_done):
        fail(f"{cell} fused: requests {bad} served other tokens than "
             f"under jit ({len(done)} of {len(jit_done)} finished)")
    L = eng.cfg.n_layers
    want = norm_launches(eng.cfg)
    if eng.cfg.tie_embeddings:      # the final norm bare: no product reads
        want = {"rmsnorm_matmul": want["rmsnorm_matmul"], "rmsnorm": 1,
                "residual_rmsnorm": want["residual_rmsnorm"] - 1}
    for hits in rule_hits_per_call(planned(eng, True) + planned(eng, False)):
        ok = (sum(hits.values()) == 2 * L + 1
              if tuple(eng.cfg.block_pattern) == ("rwkv6",) else hits == want)
        if not ok:
            fail(f"{cell} fused: rule hits per call {hits}")


def profiled_kernels(run) -> tuple:
    """``run`` under torch.profiler: each device kernel event paired with
    the runtime call that launched it, joined by correlation id (a kernel
    of a CUDA graph replay carries the ``cudaGraphLaunch``'s; should an id
    recur in one trace, the call nearest in time; None where the trace has
    no such call), and the ``user_annotation`` spans (the operator
    scopes).  Returns ([(kernel, call)], [span]); no pairs where the
    profiler recorded no device kernel (it loses the device activity of
    some profiles, as it misplaces the device clock of others)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    calls, kern, spans = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "user_annotation":
            spans.append(e)
        elif corr is None:
            continue
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls.setdefault(corr, []).append(e)
        elif e.get("cat") == "kernel":
            kern.append(e)
    pairs = [(k, min(calls.get(k["args"]["correlation"], ()),
                     key=lambda c, k=k: abs(k["ts"] - c["ts"]),
                     default=None))
             for k in kern]
    return pairs, spans


def measured_events(run) -> list:
    """The Eq. 1 timeline of ``run`` from torch.profiler: each device
    kernel joined to its launch call (``profiled_kernels``) as
    ``KernelEvent``s, in seconds from the first launch; an event's
    ``operator`` names its launch call.  Returns (events, how many kernels
    start before the call joined to them began); no events where the
    profiler recorded no device kernel."""
    pairs, _ = profiled_kernels(run)
    if not pairs:
        return [], 0
    out = []
    for k, c in pairs:
        if c is None:
            fail(f"Eq. 1 timeline: kernel {k['name'][:60]} has no launch "
                 "call in the trace")
        out.append(KernelEvent(k["name"], c["ts"] * 1e-6,
                               (c["ts"] + c["dur"]) * 1e-6, k["ts"] * 1e-6,
                               (k["ts"] + k["dur"]) * 1e-6,
                               operator=c["name"]))
    out.sort(key=lambda e: (e.kernel_start, e.launch_begin))
    t0 = min(e.launch_begin for e in out)
    for e in out:
        e.launch_begin -= t0
        e.launch_end -= t0
        e.kernel_start -= t0
        e.kernel_end -= t0
    return out, sum(e.kernel_start < e.launch_begin for e in out)


def phase_eq1(cfg, params) -> dict:
    """One SmolLM contiguous decode step (kv len 20) at batch 1, 2 and 4
    under eager and fused: the measured Eq. 1 timeline's TKLQT, AKD, IL
    and GPU idle (of the median kept profile by TKLQT) beside
    the modeled TKLQT of the same trace, then the boundedness inflection
    of the measured eager curve."""
    rows = {}
    for plan in ("eager", "fused"):
        for b in EQ1_BATCHES:
            eng = ServeEngine(cfg, params, max_batch=b, max_len=MAX_LEN,
                              plan=plan, device=DEV)
            rng = np.random.default_rng(2)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
            lens = np.full(b, 20)

            def step():
                eng.backend.decode(eng.cache, toks, lens)[0].cpu()

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            reps, tried = [], 0
            while len(reps) < EQ1_PROFILES and tried < EQ1_ATTEMPTS:
                tried += 1
                ev, early = measured_events(step)
                if not ev:
                    print(f"phase 12: Eq. 1 timeline, {plan} batch {b}: "
                          "the profiler recorded no device kernel in this "
                          "profile; discarded")
                    continue
                if early:
                    print(f"phase 12: Eq. 1 timeline, {plan} batch {b}: "
                          f"{early} of {len(ev)} kernels start before "
                          "their launch call in this profile (its device "
                          "clock is off); discarded")
                    continue
                reps.append((skip_report(ev, "H100 (measured)", 0.0), ev))
            pf = eng.backend.planned_decode
            if not reps:
                # the profiler, not the step: nothing to measure
                rows.setdefault(plan, {})[b] = dict(
                    tklqt_us=None, discarded=tried,
                    dispatches=pf.n_launches,
                    modeled_tklqt_us=pf.modeled_tklqt_s * 1e6)
                print(f"phase 12: Eq. 1 timeline, {plan} decode step, batch "
                      f"{b}: not measured, every one of {tried} profiles has "
                      "a kernel before its launch call or none; modeled "
                      f"TKLQT {pf.modeled_tklqt_s * 1e6:.1f} us (Intel+H100 "
                      "row)")
                del eng
                continue
            reps.sort(key=lambda re: re[0].tklqt)
            rep, ev = reps[len(reps) // 2]       # the median profile
            by_call = {}
            for e in ev:
                by_call[e.operator] = by_call.get(e.operator, 0) + 1
            r = dict(kernels=rep.n_kernels, tklqt_us=rep.tklqt * 1e6,
                     akd_us=rep.akd * 1e6, il_us=rep.il * 1e6,
                     gpu_idle_us=rep.gpu_idle * 1e6,
                     queue_share=rep.queue_share,
                     dispatches=pf.n_launches, launched_by=by_call,
                     profiles_tklqt_us=[x.tklqt * 1e6 for x, _ in reps],
                     discarded=tried - len(reps),
                     modeled_tklqt_us=pf.modeled_tklqt_s * 1e6)
            rows.setdefault(plan, {})[b] = r
            print(f"phase 12: Eq. 1 timeline, {plan} decode step, batch {b}"
                  f": {r['kernels']} kernels from {r['dispatches']} "
                  f"dispatches (kernels by launch call {by_call}); "
                  f"measured TKLQT over filtered profiles, the median of "
                  f"the {len(reps)} kept "
                  f"{[round(t, 1) for t in r['profiles_tklqt_us']]} "
                  f"({r['discarded']} of {tried} discarded with a kernel "
                  f"before its launch call or none): "
                  f"{r['tklqt_us']:.1f} us (queue share "
                  f"{r['queue_share']:.1%}), AKD "
                  f"{r['akd_us']:.2f} us, IL {r['il_us']:.1f} us, GPU idle "
                  f"{r['gpu_idle_us']:.1f} us; modeled TKLQT "
                  f"{r['modeled_tklqt_us']:.1f} us (Intel+H100 row)")
            del eng
    curve = [rows["eager"][b]["tklqt_us"] for b in EQ1_BATCHES]
    if None in curve:
        print("phase 12: find_inflection not run: an eager point of the Eq. "
              "1 timeline was not measured")
        rows["inflection"] = None
        return rows
    infl = find_inflection(list(EQ1_BATCHES), curve)
    print(f"phase 12: find_inflection over the measured eager TKLQT of the "
          f"filtered profiles "
          f"{[round(t, 1) for t in curve]} us at batch "
          f"{list(EQ1_BATCHES)}: {infl}"
          + (" (no GPU-bound batch up to 4: every step is CPU-bound)"
             if infl is None else ""))
    rows["inflection"] = infl
    return rows


def phase_plans(cfg, rcfg, eager: dict, jit_done: dict) -> tuple:
    """Phase 12: the cells under the launch plans of ``PLAN_CELLS``,
    checked and traced; then the measured Eq. 1 timeline.  Returns
    ({cell: {plan: numbers}}, {"cell:plan": launch counts})."""
    t0 = time.perf_counter()
    rows, counts, params, keep = {}, {}, None, None
    for cell, plans in PLAN_CELLS.items():
        arch, _, prefill = JIT_CELLS[cell]
        c = cfg if arch == "smollm" else rcfg
        rows[cell] = {}
        for plan in plans:
            eng, done, rep, counts[f"{cell}:{plan}"] = serve_cell(
                cell, c, params, plan, 12)
            check_launches(cell, plan, eng, rep)
            if plan == "fused":
                check_fused(cell, eng, done, jit_done[cell])
            trace = phase_trace(eng, f"phase 12 {cell} {plan} trace",
                                prefill)
            r = rows[cell][plan] = plan_row(rep, trace, eng)
            if plan == "auto":
                r["auto_candidates"] = auto_candidates(eng)
            print_row(12, cell, plan, r)
            print(f"  {cell} {plan}: dispatches per prefill "
                  f"{r['prefill_dispatches']}; launches per decode step "
                  f"{r['launches_per_step']}, per prefill "
                  f"{r['launches_per_prefill']:.0f}; rule hits per call "
                  f"{(r['rule_hits_per_call'] or [{}])[0]}; modeled TKLQT "
                  f"{r['modeled_tklqt_us']:.1f} us a decode step "
                  f"(Intel+H100); the decode step's trace "
                  f"{r['trace_nodes']} nodes in {r['trace_s']:.2f} s; "
                  f"planning {r['plan_s']:.2f} s")
            nxt = eng.params if cell == "paged_bf16" else None
            if cell == "contiguous":
                keep = eng.params
            del eng
            torch.cuda.empty_cache()
        params = nxt
    disp = {p: rows["contiguous"][p]["dispatches"]
            for p in PLAN_CELLS["contiguous"]}
    disp["eager"] = eager["contiguous"][0]["dispatches_per_decode_step"]
    # auto takes the lowest modeled TKLQT of the cost-aware partition and
    # every chain(L).  At full width a chain wins, as it does for the
    # reference's planner over its own trace (tests/test_torch_runtime.py,
    # test_auto_picks_the_plan_kind_the_reference_picks_at_full_width),
    # and then auto is that chain: equal dispatches, from a chain only
    chosen = rows["contiguous"]["auto"]["auto_candidates"][0]
    if not (disp["eager"] > disp["chain"] >= disp["auto"]
            >= disp["whole_graph"] == 1) or (
            disp["chain"] == disp["auto"] and chosen["strategy"] != "chain"):
        fail(f"dispatches per decode step out of order: {disp}, auto chose "
             f"{chosen}")
    steps = {p: rows["contiguous"][p]["launches_per_step"]
             for p in ("whole_graph", "chain", "auto")}
    if len({json.dumps(v, sort_keys=True) for v in steps.values()}) != 1:
        fail(f"launches per decode step differ across plans: {steps}")
    print(f"phase 12: contiguous dispatches per decode step {disp} (chain "
          f"{'>' if disp['chain'] > disp['auto'] else '=='} auto); launches"
          f" per decode step equal under whole_graph, chain and auto")
    eq1 = phase_eq1(cfg, keep)
    del keep
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 12: {secs:.1f} s")
    print("phase 12: " + json.dumps({"rows": rows, "eq1": eq1,
                                     "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 13
LLAMA = "llama-3.2-1b"
# cell -> serve flags; the contiguous cell's prefill is traced too
LLAMA_CELLS = {"llama_contiguous": [], "llama_paged_bf16": PAGED}


def f32_logits_check(cfg, phase: int, seed: int, biases=False,
                     steps: int = 3) -> list:
    """``kernel_vs_plain_logits`` of ``cfg`` in f32 with random weights:
    a MAX_BATCH x BUCKET prefill and ``steps`` decode steps.  Returns the
    kernels' logits of each call."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = model_params(cfg32, seed, biases)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, BUCKET)))
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (MAX_BATCH, 1)))
            for _ in range(steps)]
    label = f"phase {phase} {cfg.name} f32 logits"
    err, got = kernel_vs_plain_logits(cfg32, params, prompt, toks, label)
    print(f"phase {phase}: {cfg.name} f32 at full width, {cfg.n_layers} "
          f"layers, window {cfg.sliding_window}: prefill ({MAX_BATCH} x "
          f"{BUCKET}) + {steps} decode steps: max |kernel - plain| logits "
          f"{err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees")
    del params
    torch.cuda.empty_cache()
    return got


def model_params(cfg, seed: int, biases: bool = False) -> dict:
    """Random weights drawn on the card; with ``biases`` a qkv bias drawn
    non-zero (the init's zeros would hide a dropped one)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(cfg, gen, device=DEV)
    if biases:
        for blk in params["blocks"]:
            for b in ("bq", "bk", "bv"):
                t = blk["mixer"][b]
                t.copy_(torch.randn(t.shape, generator=gen, device=DEV)
                        * 0.5)
    return params


def serve_eager_then_jit(cell, cfg, extra, phase, prefill, params=None,
                         after_jit=None, trace_steps: int = TRACE_STEPS):
    """A cell under eager, then jit (``serve_flags``, or with ``params`` an
    engine on them over ``serve.make_requests``), each checked (launches,
    jit: one dispatch and eager's tokens up to near ties) and its decode
    step traced; ``after_jit(engine, finished requests)`` runs on the jit
    engine before its tokens are held against eager's, and returns the
    routing tie for that check (a MoE stack's, ``check_routing``) or None.
    Returns ({plan: row}, jit's finished requests, jit's launch counts,
    eager's)."""
    runs = {}
    for plan in ("eager", "jit"):
        t_plan = time.perf_counter()
        if params is None:
            eng, done, rep, counts = serve_flags(cfg, extra, plan, phase)
        else:
            eng, done, rep, counts = serve_engine(cfg, params, plan, phase)
        t_served = time.perf_counter() - t_plan
        check_launches(cell, plan, eng, rep)
        if plan == "jit":
            tie = None if after_jit is None else after_jit(eng, done)
            erep, edone = runs["eager"][1:3]
            check_jit(cell, rep, erep, done, edone, eng.params, cfg, tie)
        t_trace = time.perf_counter()
        trace = phase_trace(eng, f"phase {phase} {cell} {plan} trace",
                            prefill, trace_steps)
        trace_s = time.perf_counter() - t_trace
        runs[plan] = (cell_row(rep, trace), rep, done, counts)
        print_row(phase, cell, plan, runs[plan][0])
        print(f"  {cell} {plan}: {time.perf_counter() - t_plan:.1f} s "
              f"(served in {t_served:.1f} s, traced in {trace_s:.1f} s)")
        del eng
        torch.cuda.empty_cache()
    return ({p: r[0] for p, r in runs.items()}, runs["jit"][2],
            runs["jit"][3], runs["eager"][3])


def serve_engine(cfg, params, plan: str, phase: int, **cache_kw) -> tuple:
    """``ServeEngine`` on ``params`` under ``plan`` (and the cache options
    ``cache_kw``) over the serve CLI's requests (warmup + measured run),
    counted as ``serve_cell`` does."""
    eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan=plan, device=DEV, **cache_kw)
    eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    eng.reset()
    reqs = serve.make_requests(N_REQ, cfg.vocab_size, 16)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rep = serve.report(eng, done, wall)
    print(f"phase {phase}: ServeEngine({cfg.name}, {cfg.n_layers} layers, "
          f"plan {plan}) over the serve CLI's {N_REQ} requests")
    print(f"  report {json.dumps(rep)}")
    if len(done) != N_REQ or any(r.status != "done" or len(r.generated)
                                 != 16 for r in done):
        fail(f"phase {phase} {cfg.name} {plan}: finished {len(done)} of "
             f"{N_REQ} requests")
    return eng, done, rep, counts


def phase_llama() -> tuple:
    """Phase 13: Llama-3.2-1B, the paper's headline model, at full width
    and depth: f32 logits kernels against plain versions, then bf16
    serving under eager and jit on the contiguous cache and the paged
    pool, then fused on the contiguous cache.  Returns ({cell: {plan:
    numbers}}, {cell:plan: launch counts}, {cell: jit's finished
    requests})."""
    t0 = time.perf_counter()
    cfg = get_config(LLAMA)
    f32_logits_check(cfg, 13, 13)
    rows, counts, jit_done = {}, {}, {}
    for cell, extra in LLAMA_CELLS.items():
        rows[cell], jit_done[cell], counts[f"{cell}:jit"], \
            counts[f"{cell}:eager"] = serve_eager_then_jit(
                cell, cfg, extra, 13, prefill=cell == "llama_contiguous")
    cell = "llama_contiguous"
    eng, done, rep, counts[f"{cell}:fused"] = serve_flags(cfg, [], "fused",
                                                          13)
    check_launches(cell, "fused", eng, rep)
    check_fused(cell, eng, done, jit_done[cell])
    trace = phase_trace(eng, f"phase 13 {cell} fused trace")
    r = rows[cell]["fused"] = plan_row(rep, trace, eng)
    print_row(13, cell, "fused", r)
    print(f"  {cell} fused: tokens equal jit's in {N_REQ}/{N_REQ} requests; "
          f"rule hits per call {r['rule_hits_per_call']}; modeled TKLQT "
          f"{r['modeled_tklqt_us']:.1f} us a decode step (Intel+H100)")
    del eng
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 13: {secs:.1f} s")
    print("phase 13: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts, jit_done


# ------------------------------------------------------------------ phase 14
# decoder -> layers served (None: full depth); Gemma-2's two are one local
# and one global layer
PHASE14_DECODERS = {"internlm2-20b": 2, "codeqwen1.5-7b": 2,
                    "gemma2-27b": 2, "gpt2": None}
PHASE14_ENCODERS = ("bert-base-uncased", "xlm-roberta-base")
GEMMA_CUT_WINDOW = 8       # the f32 check's window, so it bites in 19 tokens


def window_in_graphs(cfg, seed: int) -> None:
    """``cfg`` in f32 with its window cut to GEMMA_CUT_WINDOW under
    ``plan="jit"``: a BUCKET-token prefill into each slot and one batched
    decode step, each a CUDA graph replay, give the plain forward's logits
    with the cut window within LOGIT_TOL_F32; the plain forward with the
    full window parts from them by more (with random tied embeddings the
    greedy tokens barely depend on attention, so the logits are held)."""
    cut = cfg.replace(sliding_window=GEMMA_CUT_WINDOW,
                      param_dtype="float32", compute_dtype="float32")
    params = model_params(cut, seed, cfg.qkv_bias)
    eng = ServeEngine(cut, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      plan="jit", device=DEV)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (MAX_BATCH, BUCKET),
                           dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (MAX_BATCH, 1), dtype=np.int32)
    got = []
    for slot in range(MAX_BATCH):
        logits, eng.cache = eng.backend.prefill(
            eng.cache, torch.from_numpy(prompts[slot:slot + 1]), slot,
            BUCKET)
        got.append(logits[0].clone())      # the graph's output buffer
    logits, eng.cache = eng.backend.decode(eng.cache, torch.from_numpy(nxt),
                                           np.full(MAX_BATCH, BUCKET))
    if eng.backend.last.dispatches != 1 or not eng.backend.graph_stats \
            .captured:
        fail(f"phase 14 {cfg.name} window {GEMMA_CUT_WINDOW}: the decode "
             f"step took {eng.backend.last.dispatches} dispatches, "
             f"{eng.backend.graph_stats.captured} graphs captured")
    got += list(logits.clone())
    seqs = [[int(t) for t in p] for p in prompts]
    seqs += [p + [int(t[0])] for p, t in zip(seqs, nxt)]
    err = bite = 0.0
    for i, (g, toks) in enumerate(zip(got, seqs)):
        err = max(err, compare_logits(
            g, plain_logits(params, cut, toks), LOGIT_TOL_F32,
            f"phase 14 {cfg.name} window {GEMMA_CUT_WINDOW} jit call {i}"))
        full = plain_logits(params, cut.replace(
            sliding_window=cfg.sliding_window), toks)
        bite = max(bite, (g - full).abs().max().item())
    if not bite > LOGIT_TOL_F32:
        fail(f"phase 14 {cfg.name}: the jit logits with the window of "
             f"{GEMMA_CUT_WINDOW} are within {bite:.3g} of the full "
             "window's: it did not bite inside the graphs")
    print(f"phase 14: {cfg.name} f32 under jit, window "
          f"{GEMMA_CUT_WINDOW}: {MAX_BATCH} prefills ({BUCKET} tokens) and "
          f"one decode step, graph replays ({eng.backend.graph_stats.captured}"
          f" graphs): max |jit - plain| logits {err:.3g} (<= "
          f"{LOGIT_TOL_F32}); the full window's plain logits part by "
          f"{bite:.3g}")
    del eng, params
    torch.cuda.empty_cache()


def phase_others() -> tuple:
    """Phase 14: InternLM2-20B, CodeQwen1.5-7B (qkv biases drawn non-zero)
    and Gemma-2-27B at full width and 2 layers, GPT-2 at full depth: f32
    logits kernels against plain versions (Gemma-2 also with its window cut
    to GEMMA_CUT_WINDOW, so that it bites), then a bf16 engine under eager
    and jit, jit's tokens against eager's (Gemma-2 again with the cut
    window, then ``window_in_graphs``); BERT and XLM-R at full depth:
    one f32 non-causal forward of MAX_BATCH x BERT_SEQ tokens, kernels
    against plain versions.  Each model is freed before the next is
    built.  Returns ({cell: {plan: numbers}}, {cell:plan: launch
    counts})."""
    t0 = time.perf_counter()
    rows, counts = {}, {}
    for i, (name, layers) in enumerate(PHASE14_DECODERS.items()):
        base = get_config(name)
        cfg = base.replace(n_layers=layers) if layers else base
        biases = cfg.qkv_bias
        full = f32_logits_check(cfg, 14, 20 + i, biases)
        if cfg.sliding_window:
            cut = f32_logits_check(
                cfg.replace(sliding_window=GEMMA_CUT_WINDOW), 14, 20 + i,
                biases)
            bite = max((a - b).abs().max().item() for a, b in zip(cut, full))
            if not bite > LOGIT_TOL_F32:
                fail(f"phase 14 {name}: the window of {GEMMA_CUT_WINDOW} "
                     f"moved the logits by {bite:.3g} only")
            print(f"  the window of {GEMMA_CUT_WINDOW} bites: max |logits "
                  f"(window {GEMMA_CUT_WINDOW}) - logits (window "
                  f"{cfg.sliding_window})| {bite:.3g}")
        del full
        params = model_params(cfg, 30 + i, biases)
        rows[name], done, counts[f"{name}:jit"], counts[f"{name}:eager"] = \
            serve_eager_then_jit(name, cfg, None, 14, prefill=True,
                                 params=params)
        if cfg.sliding_window:
            # the full window never bites under MAX_LEN: serve the cut one
            # too, so a biting window runs inside the captured graphs
            cell = f"{name}_window{GEMMA_CUT_WINDOW}"
            rows[cell], _, counts[f"{cell}:jit"], \
                counts[f"{cell}:eager"] = serve_eager_then_jit(
                    cell, cfg.replace(sliding_window=GEMMA_CUT_WINDOW),
                    None, 14, prefill=False, params=params)
        del params, done
        torch.cuda.empty_cache()
        if cfg.sliding_window:
            window_in_graphs(cfg, 50 + i)
        torch.cuda.empty_cache()
    for i, name in enumerate(PHASE14_ENCODERS):
        cfg = get_config(name)
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        params = model_params(cfg32, 40 + i)
        prompt = torch.from_numpy(np.random.default_rng(40 + i).integers(
            0, cfg.vocab_size, (MAX_BATCH, BERT_SEQ)))
        kernels.reset_launch_counts()
        err, _ = kernel_vs_plain_logits(cfg32, params, prompt, None,
                                        f"phase 14 {name} f32 logits")
        counts[f"{name}:forward"] = kernels.launch_counts()
        want = {"flash_attention": cfg.n_layers, **norm_launches(cfg)}
        got = {k: v for k, v in counts[f"{name}:forward"].items() if v}
        if got != want:
            fail(f"phase 14 {name}: launches {got} != {want}")
        print(f"phase 14: {name} f32 at full width and depth ("
              f"{cfg.n_layers} layers), one non-causal forward of "
              f"{MAX_BATCH} x {BERT_SEQ} tokens: max |kernel - plain| logits "
              f"{err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees; launches {got}")
        del params
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 14: {secs:.1f} s")
    print("phase 14: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 15
CHAR_BATCHES = (1, 2, 4, 8, 16, 32, 64)
# of Llama-3.2-1B's 16: each layer costs the phase ~13 s on a slow host
# (whole 277 s, 8 layers 187 s), and with phase 18 the script at 8 layers
# already took 1156 s of its 1200 s limit there
CHAR_LAYERS = 2
# cut in depth for the script's time limit (PERF.md section 4)
CHAR_KW = dict(scenario="code-completion", n_requests=32, seed=0,
               prompt_cap=64, output_cap=8, max_len=256,
               platform="Intel+H100")
TUNE_BATCHES = (1, 4, 16)
SWEEP_LAYERS = 4           # of SmolLM-360M's 32: the sweep serves 12 pools
# the pool at a serving size: 64 uncapped code-completion requests (prompts
# 31-128 tokens) on 32 slots, pages of 16, so the full pool is 288 bf16
# pages (23.6 MB at 4 layers) and a preemption moves a sequence's pages (up
# to 9, 0.74 MB)
SWEEP_KW = dict(scenario="code-completion", n_requests=64, max_batch=32,
                max_len=512, block_size=16, prompt_cap=None, output_cap=None,
                platforms=("Intel+H100", "GH200"),
                pool_fracs=(1.0, 0.5, 0.33), kv_dtypes=("bf16", "int8"))
# the kernels each phase-15 path must launch
CHAR_KERNELS = {
    "characterize:eager": ("decode_attention", "flash_attention"),
    "characterize:jit": ("decode_attention", "flash_attention",
                         "residual_rmsnorm", "rmsnorm_matmul"),
    "autotuned": ("decode_attention", "flash_attention"),
    "memory_sweep": ("paged_decode_attention",
                     "paged_decode_attention_quant", "flash_attention")}


def check_path_launched(path: str, counts: dict) -> None:
    idle = [k for k in CHAR_KERNELS[path] if counts[k] <= 0]
    if idle:
        fail(f"phase 15 {path}: {idle} launched no time")


def characterize_sweeps(cfg, params, counts: dict) -> dict:
    """(a): the eager and jit sweeps, checked and printed."""
    results = {}
    for plan in ("eager", "jit"):
        kernels.reset_launch_counts()
        res = characterize(cfg, params, batches=CHAR_BATCHES, plan=plan,
                           device=DEV, **CHAR_KW)
        torch.cuda.synchronize()
        counts[f"characterize:{plan}"] = kernels.launch_counts()
        check_path_launched(f"characterize:{plan}",
                            counts[f"characterize:{plan}"])
        want = sum(r.max_new_tokens for r in res.workload.requests)
        print(f"phase 15: characterize {cfg.name} plan {plan}, "
              f"{res.workload.n} {res.scenario} requests ({want} tokens), "
              f"batches {list(CHAR_BATCHES)}:")
        print_points(res)
        for p in res.points:
            print(f"  row {json.dumps(p.row())}")
            if p.tokens_out < want:
                fail(f"phase 15 {plan} batch {p.batch}: {p.tokens_out} "
                     f"tokens of the workload's {want}")
            if plan == "jit" and p.dispatches_per_decode_step != 1:
                fail(f"phase 15 jit batch {p.batch}: "
                     f"{p.dispatches_per_decode_step} dispatches per decode "
                     "step, not 1")
        print(f"phase 15: {plan} inflection batch "
              f"{res.boundedness.inflection_batch}; classification "
              f"{json.dumps(res.summary()['classification'])}")
        results[plan] = res
        torch.cuda.empty_cache()
    return results


def jit_step_split(cfg, params, kv_len: int = 60) -> dict:
    """(a'): what the engine clock counts in a jit decode step at each sweep
    batch: the graph replay's device time (CUDA events around it, each
    waited for), the f32 logits' copy to the host, and the two back to
    back, as ``ServeEngine.step`` times them (its host argmax of each row
    follows the clock's stop)."""
    rng = np.random.default_rng(3)
    out = {}
    for b in CHAR_BATCHES:
        eng = ServeEngine(cfg, params, max_batch=b,
                          max_len=CHAR_KW["max_len"], device=DEV)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
        lens = np.full(b, kv_len, np.int32)

        def call():
            return eng.backend.decode(eng.cache, toks, lens)[0]

        call()
        torch.cuda.synchronize()
        device_ms = events_busy_ms(call, 20)
        copy = []
        for _ in range(20):
            logits = call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits.cpu().numpy()
            copy.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(20):
            call().cpu().numpy()
        step_ms = (time.perf_counter() - t0) / 20 * 1e3
        out[b] = dict(device_ms=device_ms,
                      copy_ms=float(np.median(copy)) * 1e3, step_ms=step_ms)
        r = out[b]
        print(f"phase 15: jit decode step, batch {b}, kv len {kv_len}: "
              f"device {r['device_ms']:.3f} ms (CUDA events around the "
              f"replay), logits copy {r['copy_ms']:.3f} ms ({b} x "
              f"{cfg.vocab_size} f32 to the host), replay and copy back to "
              f"back {r['step_ms']:.3f} ms (the engine clock's step)")
        del eng
        torch.cuda.empty_cache()
    return out


def serve_tokens(cfg, params, workload, batch: int, **kw) -> list:
    eng = ServeEngine(cfg, params, max_batch=batch, max_len=CHAR_KW[
        "max_len"], device=DEV, **kw)
    done = eng.run(_requests(workload))
    tokens = [r.generated for r in sorted(done, key=lambda r: r.rid)]
    if len(tokens) != workload.n:
        fail(f"phase 15 {kw}: finished {len(tokens)} of {workload.n}")
    del eng
    torch.cuda.empty_cache()
    return tokens


def autotuned_serving(cfg, params, eager, tmp: str, counts: dict) -> dict:
    """(b): the plan table from the eager sweep, then each batch served
    under ``plan="autotuned"`` against the picked plan by name."""
    result = autotune(cfg, params, batches=TUNE_BATCHES,
                      platform="Intel+H100", characterization=eager,
                      max_len=CHAR_KW["max_len"], device=DEV)
    path = result.table.save(f"{tmp}/plan_table.json")
    print(f"phase 15: autotune from the eager sweep, plan table {path}:")
    print_table(result.table)
    auto = counts["autotuned"] = {k: 0 for k in kernels.launch_counts()}
    for b in TUNE_BATCHES:
        kernels.reset_launch_counts()
        got = serve_tokens(cfg, params, eager.workload, b, plan="autotuned",
                           plan_table=path)
        for k, v in kernels.launch_counts().items():
            auto[k] += v
        picked = result.table.lookup(b)
        want = serve_tokens(cfg, params, eager.workload, b, plan=picked)
        if got != want:
            fail(f"phase 15 batch {b}: autotuned tokens differ from plan "
                 f"{picked}'s")
        print(f"  batch {b}: autotuned:{picked} tokens equal plan {picked}'s "
              f"in {len(got)}/{len(got)} requests")
    check_path_launched("autotuned", auto)
    return result.table.to_dict()


def pressure_sweep(counts: dict) -> dict:
    """(c): the paged memory-pressure sweep on full-width SmolLM-360M at
    SWEEP_LAYERS."""
    cfg = get_config(ARCH).replace(n_layers=SWEEP_LAYERS)
    params = model_params(cfg, 15)
    kernels.reset_launch_counts()
    sweep = memory_pressure_sweep(cfg, params, device=DEV, **SWEEP_KW)
    torch.cuda.synchronize()
    counts["memory_sweep"] = kernels.launch_counts()
    check_path_launched("memory_sweep", counts["memory_sweep"])
    print(f"phase 15: memory_pressure_sweep {cfg.name} (block "
          f"{sweep['block_size']}, full pool {sweep['full_pool_blocks']} "
          f"blocks, block bytes {sweep['block_bytes']}):")
    print_memory_sweep(sweep)
    for r in sweep["points"]:
        if r["pool_frac"] == 0.33 and r["preemptions"] == 0:
            fail(f"phase 15 memory sweep {r['platform']} {r['kv_dtype']}: "
                 "no preemption at pool fraction 0.33")
    del params
    torch.cuda.empty_cache()
    return sweep


def strict_json(text: str, what: str, phase: int = 15):
    def bad(const):
        fail(f"phase {phase}: {what} holds {const}, not strict JSON")
    return json.loads(text, parse_constant=bad)


def check_artifacts(eager, tmp: str) -> dict:
    """(d): one merged trace and the workload JSONL, read back."""
    point = eager.points[-1]
    paths = write_artifacts(dataclasses.replace(eager, points=[point]), tmp)
    trace = strict_json(Path(paths[f"trace_b{point.batch}"]).read_text(),
                        "the merged trace")
    starts, finishes = {}, {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "dispatch_flow":
            side = starts if ev["ph"] == "s" else finishes
            if ev["id"] in side:
                fail(f"phase 15: flow id {ev['id']} twice")
            side[ev["id"]] = ev
    n_flows = len(point.modeled_events) * len(point.decode_anchors)
    if set(starts) != set(finishes) or len(starts) != n_flows or not n_flows:
        fail(f"phase 15: {len(starts)} flow starts, {len(finishes)} "
             f"finishes, want {n_flows} pairs")
    wl = load_workload(paths["workload"])
    if [r.to_json() for r in wl.requests] != \
            [r.to_json() for r in eager.workload.requests] or \
            wl.meta() != eager.workload.meta():
        fail("phase 15: the workload JSONL reloads into other requests")
    strict_json(Path(paths["summary"]).read_text(), "characterize.json")
    print(f"phase 15: artifacts {sorted(Path(tmp).iterdir())}: the trace "
          f"of batch {point.batch} is strict JSON with {len(starts)} matched "
          f"flow pairs ({len(point.decode_anchors)} decode anchors x "
          f"{len(point.modeled_events)} modeled kernels), "
          f"{len(trace['traceEvents'])} events; the JSONL reloads into the "
          f"same {wl.n} requests")
    return {k: Path(v).name for k, v in paths.items()}


def phase_characterize() -> tuple:
    """Phase 15: the measured characterization, the plan autotuner, the
    memory-pressure sweep and the trace artifacts (see the module
    docstring).  Returns ({part: numbers}, {path: launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(LLAMA).replace(n_layers=CHAR_LAYERS)
    params = model_params(cfg, 15)
    counts = {}
    results = characterize_sweeps(cfg, params, counts)
    split = jit_step_split(cfg, params)
    print(f"phase 15: (a) {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        table = autotuned_serving(cfg, params, results["eager"], tmp,
                                  counts)
        print(f"phase 15: (a)-(b) {time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()
        artifacts = check_artifacts(results["eager"], tmp)
    sweep = pressure_sweep(counts)
    secs = time.perf_counter() - t0
    out = {"characterize": {p: r.summary() for p, r in results.items()},
           "jit_step_split": split, "plan_table": table, "memory_sweep": sweep,
           "artifacts": artifacts, "seconds": secs}
    print(f"phase 15: {secs:.1f} s")
    print("phase 15: " + json.dumps(out))
    return out, counts


# ------------------------------------------------------------------ phase 16
SPEC_K = 4
SPEC = ["--speculative", "--spec-k", str(SPEC_K)]
SPEC_SWEEP = ["--spec-sweep", "--spec-ks", "0,2,4", "--batches", "1,4",
              "--model-batches", "16", "--requests", "6"]


def shifted_draft(cfg, params):
    """The reference tests' adversarial draft: the target's first half
    with an untied unembed shifted by one token, which the target rejects
    nearly every round."""
    dcfg = default_draft_config(cfg).replace(tie_embeddings=False)
    dparams = dict(draft_params_from_target(params, dcfg))
    dparams["lm_head"] = torch.roll(params["embed"], 1, 0).T.contiguous()
    return dict(draft_config=dcfg, draft_params=dparams)


def aligned_target(cfg, params, draft_layers: int) -> dict:
    """``params`` with every layer past the draft's adding nothing to the
    residual stream (its attention and MLP output projections zeroed, new
    tensors): the target then computes the default draft's function, so
    the draft is accepted nearly every round and each round after the
    first starts with the draft's width-2 catch-up step."""
    blocks = []
    for i, blk in enumerate(params["blocks"]):
        if i >= draft_layers:
            blk = dict(blk, mixer=dict(blk["mixer"]), mlp=dict(blk["mlp"]))
            blk["mixer"]["wo"] = torch.zeros_like(blk["mixer"]["wo"])
            blk["mlp"]["w_out"] = torch.zeros_like(blk["mlp"]["w_out"])
        blocks.append(blk)
    return dict(params, blocks=blocks)


def spec_engine(cell, cfg, params, draft: dict,
                speculative: bool = True) -> tuple:
    """A speculative ``ServeEngine`` (k = SPEC_K, plan jit; plain jit
    without ``speculative``) of ``cell`` on ``params`` with the draft
    options ``draft``: warmup, reset, then the measured run with the
    launch counts reset just before and read just after, and the blocks
    the rollback frees counted.  Returns (engine, finished requests,
    report, counts, rolled-back blocks)."""
    kw = dict(speculative=True, spec_k=SPEC_K, plan="jit", **draft) \
        if speculative else dict(plan="jit")
    pressure = cell == "paged_int8_pressure"
    if pressure:
        eng = ServeEngine(cfg, params, offload="host",
                          num_blocks=PRESSURE_BLOCKS, **PRESSURE_OPTS, **kw)
    else:
        paged = dict(cache="paged", block_size=BLOCK) if "paged" in cell \
            else {}
        eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          device=DEV, **paged, **kw)

    def make():
        return (pressure_requests(cfg.vocab_size) if pressure
                else serve.make_requests(N_REQ, cfg.vocab_size, 16))
    eng.run(make())
    eng.reset()
    trimmed = [0]
    if eng.kv is not None and speculative:
        trim = eng.kv.pool.trim

        def counted_trim(owner, n_tokens):
            freed = trim(owner, n_tokens)
            trimmed[0] += len(freed)
            return freed
        eng.kv.pool.trim = counted_trim
    reqs = make()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rep = serve.report(eng, done, wall)
    if len(done) != len(reqs) or any(
            r.status != "done" or len(r.generated) != r.max_new_tokens
            for r in done):
        fail(f"phase 16 {cell}: finished {len(done)} of {len(reqs)} requests")
    return eng, done, rep, counts, trimmed[0]


def plain_row(rep) -> dict:
    """The numbers ``spec_row`` reads from a plain jit run's report (as
    phase 11's ``cell_row`` holds them)."""
    return dict(tok_per_s=rep["tok_per_s"], step_ms=rep["mean_decode_step_ms"],
                graph_mb=rep["graph_memory_bytes"] / 2 ** 20,
                peak_pool=rep["block_pool_utilization"]["peak"])


def spec_row(cell, draft_name, eng, rep, trimmed, plain) -> dict:
    """One speculative cell's numbers beside plain jit's (``plain``: the
    cell's phase 11 row) and its check that the mq entries launched in
    every round of the measured run: the target's verify (L launches of
    the cache's ``_mq`` entry) and the draft's width-2 catch-up step (its
    L launches of ``decode_attention_mq``)."""
    st = eng.stats
    verify = attention_of(eng) + "_mq"
    rounds = st.spec_rounds
    n, nd = eng.cfg.n_layers, eng.draft_cfg.n_layers
    want = {verify: n}
    want["decode_attention_mq"] = want.get("decode_attention_mq", 0) + nd
    per_round = {k: v for k, v in
                 rep["kernel_launches_per_decode_step"].items() if v}
    got = {k: per_round.get(k, 0) for k in want}
    if rounds <= 0 or rounds != rep["decode_steps"] or got != want:
        fail(f"phase 16 {cell} {draft_name}: {rounds} rounds of "
             f"{rep['decode_steps']} decode steps, multi-query launches a "
             f"round {got} != {want}")
    decode_tokens = rep["tokens_out"] - rep["prefills"]
    row = dict(
        accept_rate=st.accept_rate,
        steps_per_emitted_token=st.steps_per_emitted_token,
        spec_rounds=rounds, draft_dispatches=st.draft_dispatches,
        proposed=st.proposed, accepted=st.accepted,
        corrections=st.corrections, tokens_out=rep["tokens_out"],
        ms_per_token=1e3 / rep["tok_per_s"],
        plain_ms_per_token=1e3 / plain["tok_per_s"],
        round_ms=rep["mean_decode_step_ms"],
        plain_step_ms=plain["step_ms"],
        decode_ms_per_token=(rep["mean_decode_step_ms"] * rounds
                             / decode_tokens),
        graphs=rep["graphs_captured"],
        graph_mb=rep["graph_memory_bytes"] / 2 ** 20,
        plain_graph_mb=plain["graph_mb"],
        launches_per_round=per_round,
        peak_pool=rep["block_pool_utilization"]["peak"],
        rolled_back_blocks=trimmed)
    print(f"phase 16: {cell} {draft_name}: accept_rate "
          f"{row['accept_rate']:.3f}, steps/emitted token "
          f"{row['steps_per_emitted_token']:.3f}, {rounds} rounds, "
          f"{row['draft_dispatches']} draft dispatches; "
          f"{row['ms_per_token']:.3f} ms a token (plain jit "
          f"{row['plain_ms_per_token']:.3f}), round {row['round_ms']:.3f} "
          f"ms (plain decode step {row['plain_step_ms']:.3f}), decode "
          f"{row['decode_ms_per_token']:.3f} ms a decode token; "
          f"{row['graphs']} graphs, {row['graph_mb']:.1f} MiB pool (plain "
          f"jit {row['plain_graph_mb']:.1f}); launches a round "
          f"{row['launches_per_round']}"
          + ("" if eng.kv is None else
             f"; peak pool {row['peak_pool']:.3f}, " + (
                 "blocks rolled back not counted (serve CLI)"
                 if trimmed is None else f"{trimmed} blocks rolled back")))
    return row


def spec_tokens(cell, done, plain_done, params, cfg, draft_name) -> int:
    """Speculative tokens against plain jit's of the same requests: equal,
    or parting at a printed near tie (verify multiplies at B * (k+1)
    rows, where cuBLAS may take other algorithms)."""
    plain = plain_int8_logits if cell == "paged_int8_pressure" \
        else plain_logits
    same = check_near_ties(done, plain_done, params, cfg,
                           (f"speculative ({draft_name})", "plain jit"),
                           plain)
    print(f"  {cell} {draft_name}: speculative tokens equal plain jit's in "
          f"{same}/{len(done)} requests token for token (the rest part at "
          "a printed near tie)")
    return same


def spec_f32_streams() -> dict:
    """Phase 16 (c): full-width SmolLM at 2 layers in f32 (TF32 off):
    speculative whole streams, both drafts, contiguous and paged, equal to
    plain jit greedy's exactly."""
    cfg = get_config(ARCH).replace(n_layers=2, param_dtype="float32",
                                   compute_dtype="float32")
    params = model_params(cfg, 16)
    out = {}
    for cell, extra in (("contiguous", {}),
                        ("paged", dict(cache="paged", block_size=BLOCK))):
        def run(**kw):
            eng = ServeEngine(cfg, params, max_batch=MAX_BATCH,
                              max_len=MAX_LEN, device=DEV, **extra, **kw)
            done = eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 24))
            return {r.rid: r.generated for r in done}, eng
        plain, _ = run()
        for name, draft in (("truncated", {}),
                            ("shifted", shifted_draft(cfg, params))):
            toks, eng = run(speculative=True, spec_k=SPEC_K, **draft)
            if toks != plain:
                bad = [rid for rid in plain if toks.get(rid) != plain[rid]]
                fail(f"phase 16 f32 {cell} {name}: whole streams differ from "
                     f"plain greedy in requests {bad}")
            out[f"{cell}:{name}"] = eng.stats.accept_rate
            print(f"phase 16: f32 2 layers {cell} {name} draft: "
                  f"{len(plain)}/{len(plain)} whole streams equal plain jit "
                  f"greedy's (accept_rate {eng.stats.accept_rate:.3f}, "
                  f"{eng.stats.spec_rounds} rounds)")
    return out


def phase_speculative(jit_rows, jit_done, llama_rows, llama_done) -> tuple:
    """Phase 16: speculative decoding (k = SPEC_K, plan jit) at full width:
    (a) SmolLM-360M bf16 through ``serve --speculative`` on the contiguous
    cache and the paged pool, and the int8 pool under phase 7's pressure
    with host offload; (b) the same cells with the shifted-unembed draft;
    then an aligned target (its layers past the draft's zeroed out of the
    residual stream) whose draft is accepted nearly every round; (c) f32
    whole streams; (d) Llama-3.2-1B; (e) ``characterize --spec-sweep``.
    Returns ({part: numbers}, {path: launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    rows, counts = {}, {}
    for cell in ("contiguous", "paged_bf16"):
        extra = (PAGED if cell == "paged_bf16" else []) + SPEC
        eng, done, rep, c = serve_flags(cfg, extra, "jit", 16)
        counts[f"spec_{cell}"] = c
        spec_tokens(cell, done, jit_done[cell], eng.params, cfg, "truncated")
        rows[f"{cell}:truncated"] = spec_row(cell, "truncated", eng, rep,
                                             None, jit_rows[cell]["jit"])
        params = eng.params                # the serve CLI's weights
        del eng
        torch.cuda.empty_cache()
    for cell in ("paged_int8_pressure", "contiguous", "paged_bf16"):
        for name in (("truncated", "shifted")
                     if cell == "paged_int8_pressure" else ("shifted",)):
            draft = shifted_draft(cfg, params) if name == "shifted" else {}
            eng, done, rep, c, trimmed = spec_engine(cell, cfg, params, draft)
            if name == "truncated":
                counts[f"spec_{cell}"] = c
            spec_tokens(cell, done, jit_done[cell], params, cfg, name)
            plain = jit_rows[cell]["jit"]
            rows[f"{cell}:{name}"] = row = spec_row(cell, name, eng, rep,
                                                    trimmed, plain)
            if eng.kv is not None and name == "shifted":
                # k = 4 grows at most 2 pages of 16 a row past what the
                # emitted tokens need; the rollback returns them
                slack = 2 * MAX_BATCH / eng.kv.num_blocks
                plain_peak = jit_rows[cell]["jit"]["peak_pool"]
                if not (trimmed > 0
                        and row["peak_pool"] <= plain_peak + slack):
                    fail(f"phase 16 {cell} shifted: {trimmed} blocks rolled "
                         f"back, peak pool {row['peak_pool']:.3f} vs plain "
                         f"{plain_peak:.3f} + {slack:.3f}")
            if cell == "paged_int8_pressure":
                st = eng.stats
                if not (st.preemptions > 0
                        and st.offload_bytes == st.restore_bytes > 0):
                    fail(f"phase 16 {cell} {name}: preemptions "
                         f"{st.preemptions}, offload {st.offload_bytes} B, "
                         f"restore {st.restore_bytes} B")
                print(f"  {cell} {name}: {st.preemptions} preemptions, "
                      f"{st.offload_bytes} B offloaded and restored, the "
                      "draft's cache rebuilt at each resume")
            del eng
            torch.cuda.empty_cache()
    # the aligned target: the default draft accepted nearly every round,
    # so the catch-up step carries two real tokens; beside a plain jit run
    # of the same weights
    aligned = aligned_target(cfg, params,
                             default_draft_config(cfg).n_layers)
    for cell in ("contiguous", "paged_bf16"):
        eng, pdone, prep, _, _ = spec_engine(cell, cfg, aligned, {},
                                             speculative=False)
        del eng
        eng, done, rep, _, trimmed = spec_engine(cell, cfg, aligned, {})
        spec_tokens(cell, done, pdone, aligned, cfg, "aligned")
        rows[f"{cell}:aligned"] = row = spec_row(cell, "aligned", eng, rep,
                                                 trimmed, plain_row(prep))
        if not row["accept_rate"] > 0.5:
            fail(f"phase 16 {cell} aligned: accept rate "
                 f"{row['accept_rate']:.3f}: the catch-up step rarely ran")
        del eng
        torch.cuda.empty_cache()
    del params, aligned
    torch.cuda.empty_cache()
    rows["f32"] = spec_f32_streams()
    torch.cuda.empty_cache()
    lcfg = get_config(LLAMA)
    eng, done, rep, counts["spec_llama"] = serve_flags(lcfg, SPEC, "jit", 16)
    spec_tokens("llama_contiguous", done, llama_done["llama_contiguous"],
                eng.params, lcfg, "truncated")
    rows["llama_contiguous:truncated"] = spec_row(
        "llama_contiguous", "truncated", eng, rep, None,
        llama_rows["llama_contiguous"]["jit"])
    del eng
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            sweep = characterize_main(["--arch", ARCH, *SPEC_SWEEP,
                                       "--out-dir", tmp])
        counts["spec_sweep"] = kernels.launch_counts()
        back = strict_json(Path(tmp, "spec_sweep.json").read_text(),
                           "spec_sweep.json")
    if back != json.loads(json.dumps(sweep)):
        fail("phase 16: spec_sweep.json does not read back as the sweep")
    print(f"phase 16: characterize {' '.join(SPEC_SWEEP)} (device "
          f"{sweep['device']}, {sweep['n_draft_kernels']} draft kernels a "
          "step); spec_sweep.json read back equal")
    for line in buf.getvalue().strip().splitlines()[:-1]:
        print(f"  {line}")
    rows["spec_sweep"] = {"measured": sweep["measured"],
                          "win_batches": sweep["win_batches"]}
    secs = time.perf_counter() - t0
    print(f"phase 16: {secs:.1f} s")
    print("phase 16: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 17
FLEET_ARGV = ["--arch", ARCH, "--device", "cuda", "--scenario", "chatbot",
              "--requests", "16", "--seed", "0", "--prompt-cap", "24",
              "--output-cap", "8", "--time-scale", "100", "--max-batch", "2",
              "--max-len", str(MAX_LEN), "--plan", "jit"]
TP_SWEEP = ["--tp-sweep", "--tps", "1,2,4", "--batches", "1,4,16"]


def parse_prom(text: str) -> dict:
    """Sample lines of Prometheus text -> {(name, labels): value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            head, val = line.rsplit(" ", 1)
            name, _, labels = head.partition("{")
            out[(name, labels.rstrip("}"))] = float(val)
    return out


def check_request_trace(path: str, n: int, what: str) -> int:
    """A ``--trace-out`` file: strict JSON, one track per request at pid
    1, and every request flow a matched s/f pair from pid 1 into pid 0.
    Returns the flow pairs."""
    trace = strict_json(Path(path).read_text(), what, 17)
    evs = trace["traceEvents"]
    tracks = {e["tid"] for e in evs if e.get("pid") == 1 and e["ph"] == "X"}
    flows = {}
    for e in evs:
        if e.get("cat") == "request_flow":
            flows.setdefault(e["id"], []).append((e["ph"], e["pid"]))
    if len(tracks) != n or not flows or any(
            sorted(v) != [("f", 0), ("s", 1)] for v in flows.values()):
        fail(f"phase 17: {what}: {len(tracks)} request tracks for {n} "
             f"requests, {len(flows)} flows, unpaired "
             f"{[k for k, v in flows.items() if len(v) != 2][:4]}")
    return len(flows)


def check_triage(tri: dict, n: int, what: str) -> dict:
    """Conservation per request (the reference's exact-by-construction
    check) and the aggregate shares, printed."""
    bad = [w["rid"] for w in tri["waterfall"] if not w["conserved"]]
    if tri["n_requests"] != n or bad or not tri["conservation"]["ok"]:
        fail(f"phase 17: {what}: triage of {tri['n_requests']} requests, "
             f"not conserved: {bad}")
    share = {k: v for k, v in tri["aggregate"]["share"].items() if v}
    print(f"  {what}: conservation holds for {n}/{n} requests (max error "
          f"{tri['conservation']['max_error_s']:.3g} s); shares "
          + ", ".join(f"{k} {v:.1%}" for k, v in share.items())
          + f"; p{tri['tail']['quantile']:.0f} TTFT tail dominant "
          f"{tri['tail']['dominant']}")
    return share


def export_flags(cfg, tmp: str, counts: dict) -> dict:
    """(a) ``serve --plan jit --metrics-out m.prom --trace-out t.json
    --slo-ttft-ms 200 --slo-itl-ms 50``, then ``--metrics-out m.json``."""
    prom, tpath = str(Path(tmp, "m.prom")), str(Path(tmp, "t.json"))
    eng, done, rep, counts["serve_export"] = serve_flags(
        cfg, ["--metrics-out", prom, "--trace-out", tpath, "--slo-ttft-ms",
              "200", "--slo-itl-ms", "50"], "jit", 17)
    samples = parse_prom(Path(prom).read_text())
    for field in ("tokens_out", "decode_steps", "prefills",
                  "decode_dispatches", "rejected", "preemptions"):
        if samples.get((f"engine_{field}", "")) != rep[field]:
            fail(f"phase 17: m.prom engine_{field} "
                 f"{samples.get((f'engine_{field}', ''))} != report "
                 f"{rep[field]}")
    ttft = samples[("engine_ttft_seconds_count", "")]
    if ttft != N_REQ or ("goodput_ratio", "") not in samples:
        fail(f"phase 17: m.prom counts {ttft} first tokens, goodput "
             f"{samples.get(('goodput_ratio', ''))}")
    share = check_triage(rep["triage"], N_REQ, "serve jit triage")
    flows = check_request_trace(tpath, N_REQ, "serve t.json")
    slo = rep["triage"]["slo_report"]
    print(f"  m.prom: {len(samples)} samples parse back, engine_* equal to "
          f"the report; goodput {slo['goodput_ratio']:.3f} under TTFT 200 "
          f"ms / ITL 50 ms (verdicts {slo['verdicts']}); t.json strict "
          f"JSON, {N_REQ} request tracks, {flows} matched flow pairs")
    del eng
    jpath = str(Path(tmp, "m.json"))
    eng, done, rep2, _ = serve_flags(cfg, ["--metrics-out", jpath], "jit",
                                     17)
    snap = strict_json(Path(jpath).read_text(), "m.json", 17)
    if snap != json.loads(json.dumps(eng.registry.snapshot())) or \
            snap["engine_tokens_out"]["series"][0]["value"] != \
            rep2["tokens_out"]:
        fail("phase 17: m.json does not read back as the registry snapshot")
    print(f"  m.json reads back as the registry snapshot ({len(snap)} "
          "families)")
    del eng
    torch.cuda.empty_cache()
    return {"shares": share, "goodput": slo["goodput_ratio"],
            "verdicts": slo["verdicts"], "flows": flows,
            "tok_per_s": rep["tok_per_s"],
            "mean_ttft_ms": rep["mean_ttft_ms"]}


def attribution_flags(cfg, counts: dict) -> dict:
    """(b) ``serve --plan fused --attribution``; ``--attribution --plan
    jit`` is refused with the reference's error."""
    eng, done, rep, counts["serve_fused_attribution"] = serve_flags(
        cfg, ["--attribution"], "fused", 17)
    att = rep["attribution"]
    if not (att and att["complete"] and att["accounted_launches"]
            == att["total_events"] == rep["dispatches_per_decode_step"]):
        fail(f"phase 17: attribution {att and {k: att[k] for k in ('complete', 'total_events', 'accounted_launches')}}"
             f" vs {rep['dispatches_per_decode_step']} dispatches a step")
    if not rep.get("boundedness"):
        fail("phase 17: no boundedness summary beside the attribution")
    pd = eng._planned_decode
    rows = {r["operator"] for r in att["rows"]}
    named = {}
    for si, rule in pd.plan.rules:
        named.setdefault(rule, set()).update(segment_ops(
            pd.trace.kernels, pd.plan.segments[si]))
    named["decode_attention"] = {
        parse_operator(k.operator, k.name).op for k in pd.trace.kernels
        if "decode_attention" in k.name}
    for wrapper in ("rmsnorm_matmul", "residual_rmsnorm", "decode_attention"):
        if not named.get(wrapper) or not named[wrapper] <= rows:
            fail(f"phase 17: {wrapper}'s operators {named.get(wrapper)} "
                 f"are not rows of the attribution {sorted(rows)}")
    print(f"phase 17: fused attribution complete: {att['total_events']} "
          f"dispatches a decode step accounted, modeled TKLQT "
          f"{att['tklqt_us']:.1f} us; rows "
          + ", ".join(f"{r['operator']} {float(r['launches']):.2f} launches "
                      f"{r['tklqt_pct']:.1f}%" for r in att["rows"]))
    print("  wrappers by attribution row: " + ", ".join(
        f"{w} -> {sorted(o)}" for w, o in named.items())
          + f"; boundedness {json.dumps(rep['boundedness'])}")
    del eng
    torch.cuda.empty_cache()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(
            io.StringIO()):
        try:
            serve.main(serve_argv(cfg, ["--attribution"], "jit"))
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    if code == 0 or "--attribution needs a launch-plan mode" not in \
            err.getvalue():
        fail(f"phase 17: --attribution --plan jit exited {code}: "
             f"{err.getvalue()[-200:]}")
    print(f"  --attribution --plan jit exits {code}: "
          f"{err.getvalue().strip().splitlines()[-1]}")
    return {"rows": att["rows"], "total_events": att["total_events"],
            "tklqt_us": att["tklqt_us"]}


def run_route(argv, what: str) -> tuple:
    """``repro_torch.launch.route`` with the launch counts reset just
    before and read just after; (fleet, router report, JSON report,
    counts)."""
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        fleet, report, out = route_main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"phase 17: {what}: route {' '.join(argv)}")
    print(f"  report {json.dumps({k: v for k, v in out.items() if k != 'triage'})}")
    for rid, r in out["per_replica"].items():
        print(f"  replica {rid} ({r['state']}): {r['dispatched']} "
              f"dispatched, {r['tokens_out']} tokens, clock "
              f"{r['clock_s']:.4f} s; warm-up {r['warmup_graphs']} graphs "
              f"{r['warmup_capture_s']:.3f} s capture; in the drain "
              f"{r['drain_graphs']} graphs {r['drain_capture_s']:.3f} s")
    return fleet, report, out, counts


def fleet_two(cfg, tmp: str, counts: dict) -> dict:
    """(c) two replicas under least-queue-depth against one engine."""
    tpath, mpath = str(Path(tmp, "route.json")), str(Path(tmp, "fleet.json"))
    argv = FLEET_ARGV + ["--replicas", "2", "--policy", "least-queue-depth",
                         "--trace-out", tpath, "--metrics-out", mpath]
    fleet, report, out, counts["route_jit"] = run_route(argv, "(c)")
    n = 16
    disp = sum(r["dispatched"] for r in out["per_replica"].values())
    if out["requests_done"] != n or disp != n:
        fail(f"phase 17 (c): {out['requests_done']} of {n} done, "
             f"{disp} dispatches")
    snap = strict_json(Path(mpath).read_text(), "fleet.json", 17)
    waits = sum(s["value"]["count"] for s in
                snap["fleet"]["router_queue_wait_seconds"]["series"])
    if waits != n:
        fail(f"phase 17 (c): router_queue_wait_seconds counts {waits}")
    share = check_triage(out["triage"], n, "fleet triage")
    flows = check_request_trace(tpath, n, "route.json")
    for name in ("decode_attention", "flash_attention"):
        if counts["route_jit"][name] <= 0:
            fail(f"phase 17 (c): {name} not launched by the fleet")
    # one engine of the same shape on the same requests
    params = fleet.params
    wl = sample_requests("chatbot", n, seed=0, vocab_size=cfg.vocab_size,
                         prompt_cap=24, output_cap=8, time_scale=100.0)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=MAX_LEN, device=DEV)
    eng.run(build_requests(wl))
    eng.reset()
    reqs = build_requests(wl)
    t0 = time.perf_counter()
    eng.run(reqs)
    single_wall = time.perf_counter() - t0
    same = check_near_ties(report.completed, reqs, params, cfg,
                           ("in the fleet", "on one engine"), plain_logits)
    tok = out["fleet_tokens_out"]
    row = {"fleet_wall_ms_per_tok": out["wall_s"] / tok * 1e3,
           "fleet_makespan_ms_per_tok": out["makespan_s"] / tok * 1e3,
           "single_wall_ms_per_tok": single_wall / eng.stats.tokens_out
           * 1e3,
           "single_clock_ms_per_tok": eng.now / eng.stats.tokens_out * 1e3,
           "tokens": tok, "same": same, "shares": share, "flows": flows,
           "warmup_capture_s": {k: r["warmup_capture_s"] for k, r in
                                out["per_replica"].items()},
           "drain_capture_s": {k: r["drain_capture_s"] for k, r in
                               out["per_replica"].items()},
           "ttft_ms": out["ttft_ms"]}
    print(f"  fleet tokens equal one engine's in {same}/{n} requests (the "
          f"rest part at a printed near tie); {tok} tokens: fleet "
          f"{row['fleet_wall_ms_per_tok']:.3f} ms a token of wall "
          f"(replicas serialized on one card), "
          f"{row['fleet_makespan_ms_per_tok']:.3f} ms a token of makespan "
          f"(the simulated two-device clock); one engine "
          f"{row['single_wall_ms_per_tok']:.3f} ms wall, "
          f"{row['single_clock_ms_per_tok']:.3f} ms clock; "
          f"router_queue_wait_seconds counts {waits}; route.json "
          f"{flows} matched flow pairs")
    del fleet, eng, report
    torch.cuda.empty_cache()
    return row


def fleet_elastic(cfg, tmp: str, counts: dict, policy: str,
                  key: str) -> dict:
    """(d) the paged fleet with prefix sharing, replica 0 drained after
    the 4th dispatch and a replica added after the 8th."""
    mpath = str(Path(tmp, f"{key}.json"))
    argv = FLEET_ARGV + ["--cache", "paged", "--block-size", str(BLOCK),
                         "--share-prefix", "--policy", policy,
                         "--shared-prefix-tokens", "16", "--replicas", "2",
                         "--remove-at", "4", "--add-at", "8",
                         "--metrics-out", mpath]
    fleet, report, out, counts[key] = run_route(argv, f"(d) {policy}")
    snap = strict_json(Path(mpath).read_text(), f"{key}.json", 17)["fleet"]
    added = snap["fleet_replicas_added_total"]["series"][0]["value"]
    retired = snap["fleet_replicas_retired_total"]["series"][0]["value"]
    if out["requests_done"] != 16 or added != 3 or retired != 1:
        fail(f"phase 17 (d) {policy}: {out['requests_done']} of 16 done, "
             f"{added} added, {retired} retired")
    if policy == "prefix-affinity" and out["prefix_adoptions"] <= 0:
        fail("phase 17 (d): no prefix adoption")
    check_triage(out["triage"], 16, f"{policy} elastic triage")
    new = out["per_replica"].get("2", {})
    print(f"  (d) {policy}: 16/16 requests done, requeued "
          f"{out['requeued']}; fleet_replicas_added_total {added:.0f}, "
          f"retired {retired:.0f}; {out['prefix_adoptions']} prefix "
          f"adoptions; the added replica 2: {new.get('dispatched', 0)} "
          f"dispatched, {new.get('drain_graphs', 0)} graphs captured in the "
          f"drain in {new.get('drain_capture_s', 0.0):.3f} s (charged to its "
          "clock)")
    del fleet, report
    torch.cuda.empty_cache()
    return {"adoptions": out["prefix_adoptions"], "requeued": out["requeued"],
            "added_replica": new, "ttft_ms": out["ttft_ms"]}


def tp_sweep_check(tmp: str) -> dict:
    """(e) ``characterize --tp-sweep --tps 1,2,4`` on Llama-3.2-1B whole,
    read back from ``tp_sweep.json`` and held against the traced step."""
    lcfg = get_config(LLAMA)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep = characterize_main(["--arch", LLAMA, *TP_SWEEP,
                                   "--out-dir", tmp])
    back = strict_json(Path(tmp, "tp_sweep.json").read_text(),
                       "tp_sweep.json", 17)
    if back != json.loads(json.dumps(sweep)):
        fail("phase 17: tp_sweep.json does not read back as the sweep")
    params = model_params(lcfg, 17)
    n_kernels = {b: len(_decode_trace(lcfg, params, b, sweep["max_len"],
                                      DEV).kernels)
                 for b in sweep["batches"]}
    del params
    torch.cuda.empty_cache()
    for p in sweep["points"]:
        want = (2 * lcfg.n_layers * p["batch"] * lcfg.d_model
                * lcfg.cdtype.itemsize if p["tp"] > 1 else 0)
        if p["per_device_dispatches"] != n_kernels[p["batch"]] or \
                p["collective_bytes"] != want:
            fail(f"phase 17 (e): {p} vs {n_kernels[p['batch']]} kernels, "
                 f"{want} B")
    print(f"phase 17: characterize --arch {LLAMA} {' '.join(TP_SWEEP)}: "
          f"tp_sweep.json read back equal; per-device dispatches = the "
          f"traced step's kernels {n_kernels}; collective bytes 2 L B d "
          f"{lcfg.cdtype.itemsize}")
    for line in buf.getvalue().strip().splitlines()[:-1]:
        print(f"  {line}")
    return {"inflection_batch": sweep["inflection_batch"],
            "n_kernels": n_kernels,
            "points": [{k: p[k] for k in ("platform", "tp", "batch",
                                          "modeled_tklqt_us",
                                          "modeled_step_us",
                                          "modeled_collective_tax_us")}
                       for p in sweep["points"]]}


def phase_serving_tier() -> tuple:
    """Phase 17: the serving tier around the engine (see the module
    docstring).  Returns ({part: numbers}, {path: launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    rows, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        rows["export"] = export_flags(cfg, tmp, counts)
        rows["attribution"] = attribution_flags(cfg, counts)
        rows["fleet"] = fleet_two(cfg, tmp, counts)
        rows["elastic"] = fleet_elastic(cfg, tmp, counts, "prefix-affinity",
                                        "route_paged_elastic")
        rows["elastic_lqd"] = fleet_elastic(cfg, tmp, counts,
                                            "least-queue-depth",
                                            "route_paged_elastic_lqd")
        rows["tp_sweep"] = tp_sweep_check(tmp)
    secs = time.perf_counter() - t0
    print(f"phase 17: {secs:.1f} s")
    print("phase 17: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 18
MOONLIGHT = "moonshot-v1-16b-a3b"
KIMI = "kimi-k2-1t-a32b"
JAMBA = "jamba-1.5-large-398b"
MOONLIGHT_CELLS = {"moonlight_contiguous": [], "moonlight_paged_bf16": PAGED}
# the same cells' engine options (the eager cells build their engines)
MOONLIGHT_CACHE = {"moonlight_contiguous": {},
                   "moonlight_paged_bf16": dict(cache="paged",
                                                block_size=BLOCK)}
# depth of the eager cells (and of the jit runs their tokens are held
# against), on whole Moonlight's first layers: at all 48, make_fx traces
# 12.7 k nodes a cell and the two cells took 255 s of a 1062 s script on
# an H100's host (PERF.md section 4); jit serves it whole
MOONLIGHT_EAGER_LAYERS = 8
# the cuts the card forces (80 GB): Kimi K2 at full width and 1 of its 61
# layers (19.4 B parameters, 38.8 GB bf16; two layers need 73 GB); Jamba at
# full width as one 8-layer superblock with 4 of its 16 experts (16.2 B,
# 32.5 GB; all 16 need 90 GB, and the pattern forbids a shorter stack)
KIMI_LAYERS = 1
JAMBA_EXPERTS = 4
MOONLIGHT_F32_LAYERS = 2
MOONLIGHT_TRACE_STEPS = 1  # decode steps a trace (eager: ~150 ms, 5.2 k kernels)
# a decode step's device time by operator scope (models/transformer.py)
SPLIT_SCOPES = {"attn": "attention", "moe": "moe", "mamba": "mamba",
                "mlp": "mlp", "norm1": "norm", "norm2": "norm",
                "final_norm": "norm", "resid": "other", "embed": "other",
                "unembed": "unembed", "xattn": "xattn", "norm_x": "norm"}
# the largest router-logit difference the kernels' arithmetic may make,
# as a share of the router logits' rms: 16 bf16 ulps (2^-8 each).  The
# bf16 kernels and plain versions round at other points in every layer
# before a router; a kernel that moved the router's inputs by more would
# move the logits past it
ROUTER_REL = 2.0 ** -4
# the kernels' router logits regressed on the plain ones may have a slope
# 1 + s with |s| at most one bf16 ulp: rounding at other points leaves no
# slope, a kernel that scaled the router's inputs would
ROUTER_SLOPE = 2.0 ** -8


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def step_split(eng, label: str, tries: int = 3, cache=None):
    """One decode step of ``eng``'s model (its weights and contiguous
    cache, or ``cache`` of its batch, every row at length 20) run
    directly, so that its operator
    scopes reach the profiler: each device kernel, joined to the call that
    launched it (``profiled_kernels``), is filed under the innermost
    ``SPLIT_SCOPES`` scope around that call.  Returns {kind: device ms} and
    their sum, or None when no profile recorded a device kernel."""
    cfg = eng.cfg
    toks = torch.zeros((eng.B, 1), dtype=torch.int32, device=DEV)
    lens = torch.full((eng.B,), 20, dtype=torch.int32, device=DEV)

    cache = eng.cache if cache is None else cache

    def run():
        forward(eng.params, toks, cfg, cache=cache, lengths=lens)
        torch.cuda.synchronize()

    run()
    for _ in range(tries):
        pairs, spans = profiled_kernels(run)
        if pairs:
            break
    else:
        print(f"{label}: decode step split by operator: not measured (the "
              "profiler recorded no device kernel)")
        return None
    scopes = [sc for sc in spans if sc["name"] in SPLIT_SCOPES]
    split: dict = {}
    for k, c in pairs:
        inner = None if c is None else min(
            (sc for sc in scopes if sc["tid"] == c["tid"]
             and sc["ts"] <= c["ts"] <= sc["ts"] + sc["dur"]),
            key=lambda sc: sc["dur"], default=None)
        kind = "other" if inner is None else SPLIT_SCOPES[inner["name"]]
        split[kind] = split.get(kind, 0.0) + k["dur"] * 1e-3
    total = sum(split.values())
    print(f"{label}: one decode step (batch {eng.B}, kv len 20) run "
          f"directly: device {total:.3f} ms, " + ", ".join(
              f"{k} {v:.3f} ms ({v / total:.1%})"
              for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
          + f"; {len(pairs)} device kernels")
    return {"device_ms": total, **split}


@contextlib.contextmanager
def recorded_routes():
    """Record every MoE call's expert ids, its top-k margin (the router
    logits' gap between the k-th expert and the next) and its f32 router
    logits into the yielded list, in order."""
    from repro_torch.layers import moe as moe_layer
    got, route = [], moe_layer.route

    def spy(x2d, router_w, c, with_aux=True):
        out = route(x2d, router_w, c, with_aux)
        logits = x2d.float() @ router_w.float()
        top = logits.topk(c.moe.top_k + 1, dim=-1).values
        got.append((out[1].clone(), top[:, -2] - top[:, -1], logits))
        return out
    moe_layer.route = spy
    try:
        yield got
    finally:
        moe_layer.route = route


def routed_experts(params, cfg, prompt, plains=()):
    """``recorded_routes`` of one forward of ``prompt`` through the kernels,
    those named in ``plains`` run as their plain versions."""
    with recorded_routes() as got, plain_kernels(plains):
        forward(params, prompt, cfg)
    return got


def same_experts(a, b):
    """Per token: the same set of experts (the order of the top k only
    orders the combine's sum)."""
    return (a.sort(dim=-1).values == b.sort(dim=-1).values).all(dim=-1)


def first_set_flip(a, p):
    """The first MoE call of two recorded routings (``recorded_routes``,
    ``p`` the plain one) where a token goes to another set of experts:
    (call, row, p's top-k margin there, a's experts, p's experts), or
    None."""
    for call, ((ea, _, _), (ep, margin, _)) in enumerate(zip(a, p)):
        if ea.shape != ep.shape:
            return None
        diff = ~same_experts(ea, ep)
        if diff.any():
            t = int(diff.nonzero()[0])
            return (call, t, float(margin[t]), ea[t].tolist(),
                    ep[t].tolist())
    return None


def check_routing(params, cfg, label: str) -> dict:
    """bf16 routing through the kernels (the jit path's arithmetic) against
    the plain versions on the served prompts, one forward each, every
    token-layer compared until its prompt's first flip (its later inputs
    then differ).  ``delta``: the largest |kernel - plain| router logit of
    a token-layer that routes alike, the two paths' arithmetic difference
    at the router; it must stay within ROUTER_REL of the logits' rms, and
    the kernels' logits regressed on the plain ones over every compared
    token-layer must have a slope within ROUTER_SLOPE of 1 (a systematic
    shift of the router's inputs moves it; rounding does not).  A flip of
    a token's set of experts needs a plain top-k margin below the two
    logits' difference, at most 2 ``delta``: that is the tie, and every
    flip must sit below it.  Returns the counts, ``delta``, the slope, the
    tie, the share of token-layers whose margin is below the tie and the
    median margin."""
    prompt = torch.tensor([r.prompt for r in serve.make_requests(
        N_REQ, cfg.vocab_size, 16)], device=DEV)
    b, n = prompt.shape
    a = routed_experts(params, cfg, prompt)
    p = routed_experts(params, cfg, prompt, tuple(PLAINS))
    alive = torch.ones(b, dtype=torch.bool, device=DEV)
    deltas, margins, flip_margins, squares = [], [], [], []
    cross = norm = 0.0          # the regression's sums: (kernel - plain)
    for (ea, _, la), (ep, margin, lp) in zip(a, p):   # x plain, plain^2
        live = alive.repeat_interleave(n)
        rows = same_experts(ea, ep)
        deltas.append((la - lp).abs().amax(dim=-1)[rows & live])
        margins.append(margin[live])
        squares.append(lp[live].square().mean(dim=-1))
        cross += float(((la - lp) * lp)[live].sum())
        norm += float(lp[live].square().sum())
        bad = ~rows & live
        flip_margins.append(margin[bad])
        alive &= ~bad.view(b, n).any(dim=-1)
    delta = float(torch.cat(deltas).max())
    rms = float(torch.cat(squares).mean().sqrt())
    margins, flips = torch.cat(margins), torch.cat(flip_margins)
    slope = cross / norm
    tie = 2 * delta
    total, n_flips = margins.numel(), flips.numel()
    share = float((margins < tie).float().mean())
    median = float(margins.median())
    if not delta <= ROUTER_REL * rms:
        fail(f"{label}: the kernels move a router logit by {delta:.3g}, "
             f"more than {ROUTER_REL:.3g} of the logits' rms {rms:.3g}")
    if not abs(slope) <= ROUTER_SLOPE:
        fail(f"{label}: the kernels' router logits against the plain ones "
             f"have a slope 1 + {slope:.3g}, beyond 1 +- {ROUTER_SLOPE:.3g}")
    if n_flips and not float(flips.max()) < tie:
        fail(f"{label}: {int((flips >= tie).sum())} tokens routed to other "
             "experts through the kernels than through the plain versions "
             f"where the plain top-k margin >= {tie:.3g} (2 x the largest "
             f"router-logit difference, {delta:.3g}; up to "
             f"{float(flips.max()):.3g})")
    print(f"{label}: routing (each token's set of experts) through the "
          f"kernels equals the plain versions' in {total - n_flips}/{total} "
          f"token-layers of the {b} served prompts; router logits apart by "
          f"<= {delta:.3g} ({delta / rms:.2%} of their rms {rms:.3g}; "
          f"slope 1 + {slope:.2g}), so "
          f"a tie is a plain top-k margin < {tie:.3g}: {share:.2%} of the "
          f"token-layers (median margin {median:.3g}); {n_flips} flips, "
          "each at such a tie"
          + (f" (widest {float(flips.max()):.3g})" if n_flips else ""))
    return {"same": total - n_flips, "total": total, "flips": n_flips,
            "delta": delta, "logit_rms": rms, "slope": slope, "tie": tie,
            "share_below_tie": share, "median_margin": median}


def moe_engine(cfg, label: str, seed: int, counts: dict) -> dict:
    """A cut full-width model served under jit by ``ServeEngine`` over the
    serve CLI's requests: launches, routing, first tokens against the
    plain versions, the step split, parameter bytes and peak memory."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model_params(cfg, seed)
    nbytes = tree_bytes(params)
    eng, done, rep, counts[label] = serve_engine(cfg, params, "jit", 18)
    check_launches(label, "jit", eng, rep)
    route = check_routing(params, cfg, f"phase 18 {label}")
    agree = check_first_tokens(eng, done, cfg, route["tie"])
    split = step_split(eng, f"phase 18 {label}")
    peak = torch.cuda.max_memory_allocated()
    row = dict(layers=cfg.n_layers, param_bytes=nbytes, peak_bytes=peak,
               first_tokens=agree, routing=route, split=split,
               step_ms=rep["mean_decode_step_ms"],
               tok_per_s=rep["tok_per_s"], mean_ttft_ms=rep["mean_ttft_ms"],
               graphs=rep["graphs_captured"],
               capture_s=rep["graph_capture_s"])
    print(f"phase 18: {label} jit: {cfg.n_layers} layers, parameters "
          f"{nbytes / 1e9:.2f} GB, peak memory {peak / 1e9:.2f} GB; decode "
          f"step {row['step_ms']:.3f} ms, {row['tok_per_s']:.1f} tok/s, "
          f"mean TTFT {row['mean_ttft_ms']:.2f} ms; first tokens agree with "
          f"the plain bf16 forward {agree}/{N_REQ}; {row['graphs']} graphs "
          f"in {row['capture_s']:.3f} s; {time.perf_counter() - t0:.1f} s")
    del eng, params
    torch.cuda.empty_cache()
    return row


def graphs_equal_direct(eng, done, label: str) -> int:
    """The jit engine's tokens (its step bodies replayed as CUDA graphs)
    against a second jit engine on the same weights whose bodies run
    directly: the same kernels on the same inputs, so every token must be
    equal.  Returns the requests compared."""
    direct = ServeEngine(eng.cfg, eng.params, max_batch=MAX_BATCH,
                         max_len=MAX_LEN, plan="jit", device=DEV)
    direct.backend._capturing = False
    got = {r.rid: r.generated for r in direct.run(
        serve.make_requests(N_REQ, eng.cfg.vocab_size, 16))}
    bad = [r.rid for r in done if got.get(r.rid) != r.generated]
    if bad or len(got) != len(done):
        fail(f"{label}: the graph replays' tokens differ from the same "
             f"bodies run directly in requests {bad}")
    print(f"  {label}: jit's graph replays serve the tokens of the same "
          f"step bodies run directly in {len(done)}/{len(done)} requests, "
          "token for token")
    del direct
    torch.cuda.empty_cache()
    return len(done)


def phase_moe() -> tuple:
    """Phase 18: the mixture-of-experts and Mamba stacks at full width.
    Moonlight-16B-A3B's f32 logits at 2 layers, kernels against plain
    versions; Moonlight whole (48 layers, bf16) through
    ``repro_torch.launch.serve`` under jit, contiguous and paged: launches,
    one dispatch a step, the routing (which sets the tie the token checks
    allow), the served first tokens against the plain versions, the
    contiguous graph replays against the same bodies run directly, the
    paged jit tokens against the contiguous ones and the step split; the
    eager cells at MOONLIGHT_EAGER_LAYERS, each held against jit on its
    weights as phase 13's cells; then Kimi K2 (1 layer) and Jamba (one
    8-layer superblock, 4 experts) under jit.  Returns ({cell: row}, {cell:plan: launch
    counts})."""
    t0 = time.perf_counter()
    assert not torch.backends.cuda.matmul.allow_tf32   # the f32 router
    cfg = get_config(MOONLIGHT)
    f32_logits_check(cfg.replace(n_layers=MOONLIGHT_F32_LAYERS), 18, 18)
    rows, counts, served = {}, {}, {}
    whole: dict = {}

    def moonlight_extra(cell):
        def extra(eng, done):
            if "routing" not in whole:
                whole.update(
                    param_bytes=tree_bytes(eng.params),
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    routing=check_routing(eng.params, cfg,
                                          f"phase 18 {cell}"),
                    graphs_equal_direct=graphs_equal_direct(eng, done, cell),
                    split=step_split(eng, f"phase 18 {cell}"))
                print(f"phase 18: moonlight whole: {cfg.n_layers} layers, "
                      f"parameters {whole['param_bytes'] / 1e9:.2f} GB, "
                      f"peak memory {whole['peak_bytes'] / 1e9:.2f} GB")
            tie = whole["routing"]["tie"]
            whole[f"{cell}_first_tokens"] = check_first_tokens(
                eng, done, cfg, tie)
            print(f"  {cell} jit: first tokens agree with the plain bf16 "
                  f"forward {whole[f'{cell}_first_tokens']}/{N_REQ}")
            return tie
        return extra

    def eager_cells(params, tie):
        """The eager cells at MOONLIGHT_EAGER_LAYERS (``params``: whole
        Moonlight's first layers, so every MoE call routes as the whole
        model's first ones and ``tie`` holds), each against jit on the
        same weights: launches, one dispatch a jit step, jit's tokens equal
        eager's but at a logit or routing near tie."""
        cut = cfg.replace(n_layers=MOONLIGHT_EAGER_LAYERS)
        for cell, kw in MOONLIGHT_CACHE.items():
            t_cell = time.perf_counter()
            runs = {}
            for plan in ("eager", "jit"):
                eng, done, rep, n = serve_engine(cut, params, plan, 18, **kw)
                check_launches(cell, plan, eng, rep)
                runs[plan] = (done, rep)
                if plan == "eager":
                    counts[f"{cell}:eager"] = n
                    trace = phase_trace(eng, f"phase 18 {cell} eager trace",
                                        cell == "moonlight_contiguous",
                                        MOONLIGHT_TRACE_STEPS)
                    row = dict(cell_row(rep, trace),
                               layers=MOONLIGHT_EAGER_LAYERS)
                    rows.setdefault(cell, {})["eager"] = row
                    print_row(18, cell, "eager", row)
                del eng
                torch.cuda.empty_cache()
            (edone, erep), (jdone, jrep) = runs["eager"], runs["jit"]
            check_jit(cell, jrep, erep, jdone, edone, params, cut, tie)
            print(f"phase 18: {cell} eager at {MOONLIGHT_EAGER_LAYERS} "
                  f"layers (and jit on its weights) done in "
                  f"{time.perf_counter() - t_cell:.1f} s")

    print(f"phase 18: f32 check {time.perf_counter() - t0:.1f} s")
    for cell, extra in MOONLIGHT_CELLS.items():
        torch.cuda.reset_peak_memory_stats()
        contiguous = cell == "moonlight_contiguous"
        t_cell = time.perf_counter()
        eng, done, rep, counts[f"{cell}:jit"] = serve_flags(cfg, extra, "jit",
                                                            18)
        check_launches(cell, "jit", eng, rep)
        if rep["dispatches_per_decode_step"] != 1.0:
            fail(f"{cell} jit: {rep['dispatches_per_decode_step']} "
                 "dispatches per decode step, not 1")
        moonlight_extra(cell)(eng, done)
        trace = phase_trace(eng, f"phase 18 {cell} jit trace", contiguous,
                            MOONLIGHT_TRACE_STEPS)
        rows.setdefault(cell, {})["jit"] = cell_row(rep, trace)
        served[cell] = done
        print_row(18, cell, "jit", rows[cell]["jit"])
        print(f"phase 18: {cell} jit done in "
              f"{time.perf_counter() - t_cell:.1f} s")
        if contiguous:
            eager_cells(dict(eng.params, blocks=eng.params["blocks"][
                :MOONLIGHT_EAGER_LAYERS]), whole["routing"]["tie"])
        del eng
        torch.cuda.empty_cache()
    want = {r.rid: r.generated for r in served["moonlight_contiguous"]}
    bad = [r.rid for r in served["moonlight_paged_bf16"]
           if r.generated != want.get(r.rid)]
    if bad:
        fail(f"phase 18: the paged jit engine served other tokens than the "
             f"contiguous one in requests {bad}")
    print(f"phase 18: moonlight paged jit tokens equal contiguous jit's in "
          f"{len(want)}/{len(want)} requests, token for token")
    whole["paged_equal_contiguous"] = len(want)
    rows["moonlight_contiguous"]["whole"] = whole
    kimi = get_config(KIMI).replace(n_layers=KIMI_LAYERS)
    rows["kimi"] = moe_engine(kimi, "kimi", 181, counts)
    jcfg = get_config(JAMBA)
    jamba = jcfg.replace(n_layers=len(jcfg.block_pattern), moe=dataclasses.
                         replace(jcfg.moe, n_experts=JAMBA_EXPERTS))
    rows["jamba"] = moe_engine(jamba, "jamba", 182, counts)
    secs = time.perf_counter() - t0
    print(f"phase 18: {secs:.1f} s")
    print("phase 18: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 19
VISION = "llama-3.2-vision-11b"
SEAMLESS = "seamless-m4t-medium"
# the gate every vision cross layer gets: the init's tanh(0) = 0 would
# zero them, and every check of the image path would be vacuous
XGATE = 0.5
XATTN_PROMPT, XATTN_STEPS = 12, 16     # the image / frame path's greedy run
# depth of the f32 check and of the eager and fused cells: one superblock
# of Llama-3.2-Vision (4 self-attention layers and its xattn layer), two
# of Seamless's decoder layers (f32 runs Seamless whole); a whole 40-layer
# eager cell would trace for minutes (PERF.md section 7)
XATTN_CUT = {VISION: 5, SEAMLESS: 2}
XATTN_LABEL = {VISION: "vision", SEAMLESS: "seamless"}


def xattn_cases(dtype):
    """The kernels at phase 19's shapes: ``flash_attention`` non-causal
    over Llama-3.2-Vision's 1601 patches (B 4, 32/8 heads of 128, S 16),
    over Seamless's encoder (B 1, 16 heads of 64, S = T = 4096) and at the
    served cross prefill (B 1, S 16 over T 1: S > T, the wrapper's query
    offset negative); ``decode_attention`` over a whole cross cache (T 1601
    and 4096, B 4); ``rmsnorm_matmul`` at the untied heads (4 x 1 rows)."""
    es = torch.tensor([], dtype=dtype).element_size()
    cases = {}
    for i, (tag, (b, hq, hkv, hd, s, t)) in enumerate((
            ("vision_x", (MAX_BATCH, 32, 8, 128, BUCKET, 1601)),
            ("seamless_enc", (1, 16, 16, 64, 4096, 4096)),
            ("x_t1", (1, 32, 8, 128, BUCKET, 1)))):
        q = randn((b, s, hq, hd), dtype, 300 + 3 * i).transpose(1, 2)
        k = randn((b, t, hkv, hd), dtype, 301 + 3 * i).transpose(1, 2)
        v = randn((b, t, hkv, hd), dtype, 302 + 3 * i).transpose(1, 2)
        cases[f"flash_attention[{tag}]"] = dict(
            call=lambda q=q, k=k, v=v, sc=hd ** -0.5: kernels.flash_attention(
                q, k, v, scale=sc, causal=False),
            plain=lambda q=q, k=k, v=v, sc=hd ** -0.5: attention_ref(
                q, k, v, scale=sc, causal=False),
            library=lambda q=q, k=k, v=v, sc=hd ** -0.5:
                F.scaled_dot_product_attention(q, k, v, scale=sc,
                                               enable_gqa=True),
            bytes=(2 * b * s * hq * hd + 2 * b * t * hkv * hd) * es,
            flops=4 * b * s * t * hq * hd)
    for i, (tag, (hq, hkv, hd, t)) in enumerate((
            ("vision_x1601", (32, 8, 128, 1601)),
            ("seamless_x4096", (16, 16, 64, 4096)))):
        b = MAX_BATCH
        q = randn((b, hq, hd), dtype, 320 + 3 * i)
        k = randn((b, t, hkv, hd), dtype, 321 + 3 * i).transpose(1, 2)
        v = randn((b, t, hkv, hd), dtype, 322 + 3 * i).transpose(1, 2)
        cases[f"decode_attention[{tag}]"] = dict(
            call=lambda q=q, k=k, v=v, sc=hd ** -0.5: kernels.decode_attention(
                q, k, v, scale=sc),
            plain=lambda q=q, k=k, v=v, sc=hd ** -0.5: decode_attention_ref(
                q, k, v, scale=sc),
            library=lambda q=q, k=k, v=v, sc=hd ** -0.5:
                F.scaled_dot_product_attention(q[:, :, None], k, v, scale=sc,
                                               enable_gqa=True),
            bytes=(2 * b * hq * hd + 2 * b * t * hkv * hd) * es,
            flops=4 * b * t * hq * hd)
    for tag, arch in (("vision", VISION), ("seamless", SEAMLESS)):
        d, f = get_config(arch).d_model, get_config(arch).vocab_size
        x = randn((MAX_BATCH, 1, d), dtype, 340)
        w = randn((d,), dtype, 341) + 1.0
        wq = randn_on_card((d, f), dtype, 342, scale=0.02)
        rows = MAX_BATCH
        cases[f"rmsnorm_matmul[unembed_{tag}]"] = dict(
            call=lambda x=x, w=w, wq=wq: kernels.rmsnorm_matmul(x, w, wq),
            plain=lambda x=x, w=w, wq=wq: rmsnorm_matmul_ref(x, w, wq),
            library=None,
            unfused=lambda x=x, w=w, wq=wq, d=d: torch.matmul(
                F.rms_norm(x, (d,), w, eps=1e-5), wq),
            bytes=(2 * rows * d + d + d * f + rows * f) * es,
            flops=2 * rows * d * f + 4 * rows * d)
    return cases


def xattn_params(cfg, seed: int) -> dict:
    """``model_params`` with every ``xgate`` at XGATE."""
    params = model_params(cfg, seed)
    for blk in params["blocks"]:
        if "xgate" in blk:
            blk["xgate"].fill_(XGATE)
    return params


def cross_inputs(cfg, b: int, seed: int) -> dict:
    """The stub frontend's seeded states, (B, n_frontend_tokens, D) in the
    compute dtype: frame embeddings for the encoder, or patch
    embeddings."""
    x = randn_on_card((b, cfg.n_frontend_tokens, cfg.d_model), cfg.cdtype,
                      seed)
    key = "encoder_tokens" if cfg.n_encoder_layers else "frontend_embeds"
    return {key: x}


def cross_run(params, cfg, prompt, steps: int, inputs: dict,
              greedy: bool) -> tuple:
    """A prefill of ``prompt`` (B x n) with the cross inputs into a fresh
    cache (the cross caches written), then ``steps`` decode steps through
    the cross caches: each feeding the previous step's argmax (``greedy``)
    or the given tokens ``steps``.  Returns (the logits of each call, the
    tokens fed, the cache)."""
    b, n = prompt.shape
    n_steps = steps if greedy else len(steps)
    cache = make_cache(cfg, b, n + n_steps, src_len=cfg.n_frontend_tokens,
                       device=DEV)
    logits, cache = forward(params, prompt, cfg, cache=cache, **inputs)
    got, fed = [logits], []
    for i in range(n_steps):
        tok = (got[-1][:, -1].argmax(-1, keepdim=True) if greedy
               else steps[i].to(DEV))
        fed.append(tok)
        lg, cache = forward(params, tok, cfg, cache=cache,
                            lengths=np.full(b, n + i))
        got.append(lg)
    return got, fed, cache


def xattn_f32_check(cfg, seed: int) -> float:
    """f32 at full width (``cfg`` cut in depth): a MAX_BATCH x BUCKET
    prefill with the cross inputs and 3 decode steps through the cross
    caches, kernels against plain versions; the last step against a full
    forward over the whole sequence, through the kernels."""
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = xattn_params(cfg32, seed)
    inputs = cross_inputs(cfg32, MAX_BATCH, seed)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, BUCKET))).to(DEV)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (MAX_BATCH, 1))) for _ in range(3)]
    out = {}
    for mode in ("kernel", "plain"):
        ctx = plain_kernels() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            out[mode] = cross_run(params, cfg32, prompt, steps, inputs,
                                  greedy=False)[0]
    label = f"phase 19 {cfg.name} f32 logits"
    err = max(compare_logits(a, b_, LOGIT_TOL_F32, f"{label} call {i}")
              for i, (a, b_) in enumerate(zip(out["kernel"], out["plain"])))
    whole = torch.cat([prompt] + [t.to(DEV) for t in steps], dim=1)
    full, _ = forward(params, whole, cfg32, **inputs)
    d_full = compare_logits(out["kernel"][-1][:, -1], full[:, -1],
                            LOGIT_TOL_F32, f"{label} decode vs full forward")
    print(f"phase 19: {cfg.name} f32 at full width, {cfg.n_layers} layers"
          + (f" (+{cfg.n_encoder_layers} encoder)" if cfg.n_encoder_layers
             else "") + f", {cfg.n_frontend_tokens} source positions: "
          f"prefill ({MAX_BATCH} x {BUCKET}) with the cross inputs + 3 decode "
          f"steps through the cross caches: max |kernel - plain| logits "
          f"{err:.3g} (<= {LOGIT_TOL_F32}), argmax agrees; the last step "
          f"against a full forward of the whole sequence {d_full:.3g}")
    del params, out, full
    torch.cuda.empty_cache()
    return max(err, d_full)


def cross_path(eng, params, cfg, label: str) -> dict:
    """The image or frame path at batch MAX_BATCH in bf16: a
    XATTN_PROMPT-token prefill with the seeded cross inputs, XATTN_STEPS
    greedy decode steps through the cross caches; the last step's logits
    against a full forward of the whole sequence (LOGIT_TOL_BF16, argmax
    outside near ties), the greedy tokens against the plain versions' run
    (a row may part only at a plain near tie); a decode step split with
    the full cross cache; the encoder's device ms over its frames."""
    b = MAX_BATCH
    inputs = cross_inputs(cfg, b, 191)
    prompt = torch.from_numpy(np.random.default_rng(191).integers(
        0, cfg.vocab_size, (b, XATTN_PROMPT))).to(DEV)
    got, fed, cache = cross_run(params, cfg, prompt, XATTN_STEPS, inputs,
                                greedy=True)
    whole = torch.cat([prompt] + fed, dim=1)
    full, _ = forward(params, whole, cfg, **inputs)
    with plain_kernels():
        pgot, pfed, _ = cross_run(params, cfg, prompt, XATTN_STEPS, inputs,
                                  greedy=True)
        pwhole = torch.cat([prompt] + pfed, dim=1)
        pfull, _ = forward(params, pwhole, cfg, **inputs)
    # bf16: a decode step and a full forward sum in other orders (other
    # kernels, other row counts for cuBLAS); the plain versions' own
    # difference between the two measures that, and the kernels' may be
    # at most twice it (or LOGIT_TOL_BF16)
    d_plain = float((pgot[-1][:, -1] - pfull[:, -1]).abs().max())
    tol = max(LOGIT_TOL_BF16, 2 * d_plain)
    d_full = compare_logits(got[-1][:, -1], full[:, -1], tol,
                            f"{label} decode vs full forward")
    rms = float(full[:, -1].float().square().mean().sqrt())
    toks = torch.cat(fed, dim=1)
    ptoks = torch.cat(pfed, dim=1)
    same = 0
    for r in range(b):
        diff = (toks[r] != ptoks[r]).nonzero()
        if not len(diff):
            same += 1
            continue
        i = int(diff[0])
        lg = pgot[i][r, -1]
        gap = float((lg[ptoks[r, i]] - lg[toks[r, i]]).abs())
        if not gap < LOGIT_TOL_BF16:
            fail(f"{label}: row {r} token {i} is {int(toks[r, i])} through "
                 f"the kernels and {int(ptoks[r, i])} through the plain "
                 f"versions, plain logits {gap:.3g} apart")
        print(f"  near tie: row {r} token {i}: kernels {int(toks[r, i])}, "
              f"plain {int(ptoks[r, i])}, plain logits {gap:.3g} apart "
              f"(< {LOGIT_TOL_BF16})")
    split = step_split(eng, f"{label} ({cfg.n_frontend_tokens}-row cross "
                       "cache)", cache=cache)
    row = dict(decode_vs_full=d_full, decode_vs_full_plain=d_plain,
               logits_rms=rms, greedy_equal_plain=same,
               split_full_cross=split)
    if cfg.n_encoder_layers:
        frames = inputs["encoder_tokens"]
        enc_ms = time_ms(lambda: encode(params, frames, cfg), iters=5)[0]
        # the products a layer does: q, k, v and o, the two attention
        # products over all T x T pairs, the MLP's two (three with a GLU)
        t, d, hd = cfg.n_frontend_tokens, cfg.d_model, cfg.hd
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        flops = cfg.n_encoder_layers * (
            2 * b * t * d * (2 * hq + 2 * hkv) * hd
            + 4 * b * t * t * hq * hd
            + 2 * b * t * d * cfg.d_ff * (3 if cfg.glu else 2))
        row.update(encoder_ms=enc_ms, encoder_tflops=flops / enc_ms / 1e9)
        print(f"  {label}: the encoder ({cfg.n_encoder_layers} layers) over "
              f"{b} x {cfg.n_frontend_tokens} frames: {enc_ms:.3f} ms device"
              f" ({flops / 1e12:.2f} TFLOP of products: "
              f"{flops / enc_ms / 1e9:.0f} TFLOP/s)")
    print(f"  {label}: the {'frame' if cfg.n_encoder_layers else 'image'} "
          f"path, batch {b}: prefill {XATTN_PROMPT} tokens with "
          f"{cfg.n_frontend_tokens} source positions, {XATTN_STEPS} greedy "
          f"decode steps through the cross caches; the last step against a "
          f"full forward of the whole sequence: max |diff| {d_full:.3g} "
          f"(the plain versions' own {d_plain:.3g}; <= {tol:.3g}; logits "
          f"rms {rms:.3g}), argmax agrees; greedy tokens equal the plain "
          f"versions' in {same}/{b} rows (the rest part at a printed near "
          "tie)")
    del cache, got, pgot, full, pfull
    torch.cuda.empty_cache()
    return row


def xattn_cut_cells(cfg, seed: int, counts: dict) -> dict:
    """``cfg`` cut to XATTN_CUT layers: jit, eager and fused engines over
    the serve CLI's requests; eager's tokens against jit's (near ties
    printed), fused's equal to jit's with the model's norm windows."""
    cell = f"{XATTN_LABEL[cfg.name]}_cut"
    params = xattn_params(cfg, seed)
    rows, done = {}, {}
    for plan in ("jit", "eager", "fused"):
        eng, done[plan], rep, counts[f"{cell}:{plan}"] = serve_engine(
            cfg, params, plan, 19)
        check_launches(cell, plan, eng, rep)
        if plan == "eager":
            same = check_near_ties(done["eager"], done["jit"], params, cfg,
                                   ("under eager", "under jit"),
                                   plain_logits)
            print(f"  {cell}: eager tokens equal jit's in {same}/{N_REQ} "
                  "requests (the rest part at a printed near tie)")
        if plan == "fused":
            check_fused(cell, eng, done["fused"], done["jit"])
            print(f"  {cell} fused: tokens equal jit's in {N_REQ}/{N_REQ} "
                  f"requests; rule hits per call as norm_launches "
                  f"{norm_launches(cfg)}")
        rows[plan] = dict(step_ms=rep["mean_decode_step_ms"],
                          dispatches=rep["dispatches_per_decode_step"],
                          tok_per_s=rep["tok_per_s"])
        print(f"phase 19: {cell} {plan}: {cfg.n_layers} layers, decode step "
              f"{rows[plan]['step_ms']:.3f} ms, "
              f"{rows[plan]['dispatches']:.0f} dispatches a step")
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return rows


def xattn_whole(cfg, seed: int, counts: dict) -> dict:
    """The bf16 model whole under jit over the serve CLI's requests (the
    served one-row cross cache): launches, graph replays against the same
    bodies run directly, first tokens against the plain versions, the step
    split, then the cross path (``cross_path``), then a speculative engine
    (k = 4, the default draft) whose tokens must equal plain jit's but at a
    printed near tie; parameter bytes and peak memory."""
    label = XATTN_LABEL[cfg.name]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = xattn_params(cfg, seed)
    nbytes = tree_bytes(params)
    eng, done, rep, counts[f"{label}:jit"] = serve_engine(cfg, params, "jit",
                                                          19)
    check_launches(label, "jit", eng, rep)
    direct = graphs_equal_direct(eng, done, label)
    agree = check_first_tokens(eng, done, cfg)
    split = step_split(eng, f"phase 19 {label} (served one-row cross cache)")
    path = cross_path(eng, params, cfg, f"phase 19 {label}")
    spec = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       plan="jit", device=DEV, speculative=True, spec_k=4)
    kernels.reset_launch_counts()
    sdone = spec.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    torch.cuda.synchronize()
    counts[f"{label}:spec_jit"] = kernels.launch_counts()
    same = check_near_ties(sdone, done, params, cfg,
                           ("speculative", "plain jit"), plain_logits)
    st = spec.stats
    print(f"  {label} speculative (k 4, draft {spec.draft_cfg.n_layers} "
          f"layers): tokens equal plain jit's in {same}/{N_REQ} requests "
          f"(the rest part at a printed near tie); accept rate "
          f"{st.accept_rate:.3f}, {st.spec_rounds} rounds")
    peak = torch.cuda.max_memory_allocated()
    row = dict(layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               param_bytes=nbytes, peak_bytes=peak, first_tokens=agree,
               graphs_equal_direct=direct, split_served=split, **path,
               step_ms=rep["mean_decode_step_ms"], tok_per_s=rep["tok_per_s"],
               mean_ttft_ms=rep["mean_ttft_ms"],
               graphs=rep["graphs_captured"], capture_s=rep["graph_capture_s"],
               spec_same=same, spec_accept_rate=st.accept_rate)
    print(f"phase 19: {label} jit: {cfg.n_layers} layers"
          + (f" + {cfg.n_encoder_layers} encoder" if cfg.n_encoder_layers
             else "") + f", parameters {nbytes / 1e9:.2f} GB, peak memory "
          f"{peak / 1e9:.2f} GB; decode step {row['step_ms']:.3f} ms, "
          f"{row['tok_per_s']:.1f} tok/s, mean TTFT {row['mean_ttft_ms']:.2f}"
          f" ms; first tokens agree with the plain bf16 forward "
          f"{agree}/{N_REQ}; {row['graphs']} graphs in {row['capture_s']:.3f}"
          f" s; {time.perf_counter() - t0:.1f} s")
    del eng, spec, params
    torch.cuda.empty_cache()
    return row


def phase_xattn() -> tuple:
    """Phase 19: the cross-attention stacks, Llama-3.2-Vision-11B and
    SeamlessM4T-medium (``xattn_f32_check``, ``xattn_whole``,
    ``xattn_cut_cells``).  Returns ({cell: row}, {cell:plan: launch
    counts})."""
    t0 = time.perf_counter()
    rows, counts = {}, {}
    for i, arch in enumerate((VISION, SEAMLESS)):
        cfg = get_config(arch)
        label = XATTN_LABEL[arch]
        f32_cfg = cfg.replace(n_layers=XATTN_CUT[VISION]) if arch == VISION \
            else cfg
        rows[f"{label}_f32"] = xattn_f32_check(f32_cfg, 190 + i)
        rows[label] = xattn_whole(cfg, 192 + i, counts)
        rows[f"{label}_cut"] = xattn_cut_cells(
            cfg.replace(n_layers=XATTN_CUT[arch]), 194 + i, counts)
        print(f"phase 19: {label} done at {time.perf_counter() - t0:.1f} s")
    secs = time.perf_counter() - t0
    print(f"phase 19: {secs:.1f} s")
    print("phase 19: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 20
TP = 2
# cell -> the engine's cache options; each cell is served at tp=2 and, on
# the same weights, at tp=1
TP_CELLS = {"llama_tp2_contiguous": {},
            "llama_tp2_paged_bf16": dict(cache="paged", block_size=BLOCK),
            "llama_tp2_paged_int8": dict(cache="paged", kv_dtype="int8",
                                         block_size=BLOCK,
                                         prefill_chunk=CHUNK)}
TP_STEPS = 20            # decode steps timed straight through a backend
TP_LOGIT_TOL = 1e-4      # f32 logits, tp=2 against tp=1 (other sum order)


def tp_f32_check(cfg, seed: int) -> dict:
    """f32 logits of a prefill into every slot (12-token prompts) and 8
    batched decode steps (the tp=1 argmax fed to both), ``LocalBackend``
    under jit against ``ShardedBackend`` at tp=2 on the same weights (TF32
    off on every rank), the whole model: the sums of the row-split
    products (wo, w_out) run in another order, so they agree within
    TP_LOGIT_TOL, not bit for bit."""
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = model_params(c32, seed)
    one = LocalBackend(c32, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       device=DEV)
    two = ShardedBackend(c32, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                         tp=TP, device=DEV)
    err, rms = 0.0, 0.0
    try:
        pairs = ((one, one.init_contiguous_cache()),
                 (two, two.init_contiguous_cache()))
        rng = np.random.default_rng(seed)
        toks = np.zeros((MAX_BATCH, 1), np.int64)
        lens = np.full(MAX_BATCH, PROMPT, np.int32)
        for slot in range(MAX_BATCH):
            row = np.zeros((1, BUCKET), np.int64)
            row[0, :PROMPT] = rng.integers(0, cfg.vocab_size, PROMPT)
            a, b = (be.prefill(c, row, slot, PROMPT)[0].clone()
                    for be, c in pairs)
            err = max(err, (a - b).abs().max().item())
            rms = max(rms, a.pow(2).mean().sqrt().item())
            toks[slot, 0] = a.argmax().item()
        for _ in range(8):
            a, b = (be.decode(c, toks, lens)[0].clone() for be, c in pairs)
            err = max(err, (a - b).abs().max().item())
            toks[:, 0] = a.argmax(-1).cpu().numpy()
            lens += 1
    finally:
        two.close()
    del one, two, params
    torch.cuda.empty_cache()
    if not err <= TP_LOGIT_TOL:
        fail(f"phase 20: f32 logits at tp={TP} part from tp=1 by {err:.3g}"
             f" > {TP_LOGIT_TOL}")
    print(f"phase 20: {cfg.name} f32 at full width and depth "
          f"({c32.n_layers} layers), a prefill "
          f"into {MAX_BATCH} slots and 8 decode steps: max |tp={TP} - tp=1|"
          f" logits {err:.3g} (<= {TP_LOGIT_TOL}; logits rms {rms:.3g})")
    return dict(max_abs_err=err, logits_rms=rms)


def tp_new(cfg, params, tp: int, **cache_kw) -> ServeEngine:
    return ServeEngine(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       plan="jit", device=DEV, tp=tp, **cache_kw)


def tp_engine(cfg, eng: ServeEngine) -> tuple:
    """``eng`` over the serve CLI's requests (warmup, reset, measured run
    with the launch counts reset just before); with tp > 1 also the other
    ranks' launches in the measured run."""
    tp = eng.tp
    eng.run(serve.make_requests(N_REQ, cfg.vocab_size, 16))
    eng.reset()
    reqs = serve.make_requests(N_REQ, cfg.vocab_size, 16)
    ranks = ([dict(t) for t in eng.backend.rank_launch_totals]
             if tp > 1 else None)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rep = serve.report(eng, done, wall)
    if ranks is not None:
        ranks = [{k: t.get(k, 0) - b.get(k, 0) for k in counts}
                 for t, b in zip(eng.backend.rank_launch_totals, ranks)]
    if len(done) != N_REQ or any(r.status != "done" or len(r.generated)
                                 != 16 for r in done):
        fail(f"phase 20 {cfg.name} tp={tp}: finished {len(done)} of "
             f"{N_REQ} requests")
    return eng, done, rep, counts, ranks


def direct_steps(eng, n: int = TP_STEPS) -> dict:
    """``n`` decode steps straight through the engine's backend (the
    served signature, so its graphs replay): wall ms a step (synchronized
    at both ends) and, at tp > 1, every rank's segment replays,
    all-reduces and seconds in the gloo exchange a step, and the last
    step's launches per rank."""
    be, b = eng.backend, MAX_BATCH
    toks = np.zeros((b, 1), np.int64)
    lens = np.full(b, MAX_LEN // 2, np.int32)
    if eng.kv is not None:
        bt = eng.kv.block_tables([None] * b)
        step = lambda: be.paged_decode(eng.cache, toks, lens, bt)  # noqa
    else:
        step = lambda: be.decode(eng.cache, toks, lens)  # noqa: E731
    step()
    sharded = eng.tp > 1
    before = (list(zip(be.rank_collectives, be.rank_graphs)) if sharded
              else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    out = dict(wall_ms=(time.perf_counter() - t0) / n * 1e3)
    if sharded:
        after = zip(be.rank_collectives, be.rank_graphs)
        out["ranks"] = [dict(
            replays=(ag.replays - pg.replays) / n,
            allreduces=(a.allreduces - p.allreduces) / n,
            allreduce_ms=(a.allreduce_s - p.allreduce_s) / n * 1e3)
            for (a, ag), (p, pg) in zip(after, before)]
        out["launches"] = [{k: v for k, v in r.items() if v}
                           for r in be.rank_launches]
    return out


def tp_cell(cell, cfg, params, cache_kw, eng) -> tuple:
    """One cell: tp=1 under jit, then ``eng`` (tp=2, started on the same
    weights), each over the serve CLI's requests and then timed directly;
    the checks of phase 20.  Returns (row, the tp=2 run's launch counts
    per rank)."""
    t0 = time.perf_counter()
    e1, d1, r1, _, _ = tp_engine(cfg, tp_new(cfg, params, 1, **cache_kw))
    s1 = direct_steps(e1)
    del e1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    eng, done, rep, counts, ranks = tp_engine(cfg, eng)
    t2 = time.perf_counter()
    try:
        s2 = direct_steps(eng)
        graphs = eng.backend.graph_stats
        info = eng.backend.info
        # the transport alone: the same payload between the ranks, host
        # memory only, back to back
        probe_ms = eng.backend.probe_exchange(
            200, MAX_BATCH * cfg.d_model * 2) * 1e3
    finally:
        eng.close()
    L = cfg.n_layers
    attn = attention_of(eng)
    want_step, want_pre = want_launches(local_config(cfg, TP), attn)
    check_launches(cell, "jit", eng, rep)
    want_nz = {k: v for k, v in want_step.items() if v}
    for r, (got, per) in enumerate(zip(s2["launches"], s2["ranks"])):
        if got != want_nz:
            fail(f"{cell}: rank {r} launched {got} in a decode step, not "
                 f"{want_nz}")
        if per["replays"] != 2 * L + 1 or per["allreduces"] != 2 * L:
            fail(f"{cell}: rank {r} ran {per['replays']} graph replays and "
                 f"{per['allreduces']} all-reduces a decode step, not "
                 f"{2 * L + 1} and {2 * L}")
    if ranks[1] != counts or ranks[0] != counts:
        fail(f"{cell}: the ranks' launches in the measured run part: "
             f"{ranks} (rank 0 counted {counts})")
    want_bytes = 2 * L * MAX_BATCH * cfg.d_model * 2
    if rep["collective_bytes_per_decode_step"] != want_bytes:
        fail(f"{cell}: {rep['collective_bytes_per_decode_step']} collective "
             f"bytes a decode step, not {want_bytes}")
    if rep["tp"] != TP or set(rep["per_device_dispatches"]) != {"0", "1"} \
            or tuple(info.devices) != (0, 0):
        fail(f"{cell}: tp {rep['tp']}, dispatch streams "
             f"{rep['per_device_dispatches']}, devices {info.devices}")
    t3 = time.perf_counter()
    plain = (plain_int8_logits if cache_kw.get("kv_dtype") == "int8"
             else plain_logits)
    same = check_near_ties(done, d1, params, cfg, (f"at tp={TP}", "at tp=1"),
                           plain)
    seconds = dict(tp1=t1 - t0, tp2_served=t2 - t1, tp2_rest=t3 - t2,
                   ties=time.perf_counter() - t3)
    tax_us = 2 * L * allreduce_cost_s(PLATFORMS["Intel+H100"],
                                      MAX_BATCH * cfg.d_model * 2, TP) * 1e6
    row = dict(step_ms=rep["mean_decode_step_ms"],
               tp1_step_ms=r1["mean_decode_step_ms"],
               direct_ms=s2["wall_ms"], tp1_direct_ms=s1["wall_ms"],
               allreduce_ms=[p["allreduce_ms"] for p in s2["ranks"]],
               host_exchange_ms=probe_ms,
               modeled_tax_us=tax_us, tok_per_s=rep["tok_per_s"],
               tp1_tok_per_s=r1["tok_per_s"],
               mean_ttft_ms=rep["mean_ttft_ms"],
               tp1_mean_ttft_ms=r1["mean_ttft_ms"],
               segments=graphs.captured, capture_s=graphs.capture_s,
               same_tokens=same, collective_bytes_per_step=want_bytes,
               seconds=seconds)
    print(f"phase 20: {cell}: ranks on devices {info.devices} (they share "
          f"the card, gloo over host memory: no tensor-parallel speed); "
          f"decode step {row['step_ms']:.3f} ms (serve clock), "
          f"{row['direct_ms']:.3f} ms direct; tp=1 jit "
          f"{row['tp1_step_ms']:.3f} / {row['tp1_direct_ms']:.3f} ms; "
          f"all-reduces a step: rank 0 {row['allreduce_ms'][0]:.3f} ms, "
          f"rank 1 {row['allreduce_ms'][1]:.3f} ms in the gloo exchange "
          f"({2 * L} of {MAX_BATCH * cfg.d_model * 2} B; one such exchange "
          f"host to host, no device work: {probe_ms * 1e3:.1f} us); modeled "
          f"Intel+H100 collective tax {tax_us:.1f} us a step; "
          f"{2 * L + 1} replays and {2 * L} all-reduces a step on each rank; "
          f"{want_bytes} collective bytes a step; launches a step {want_nz}"
          f" on each rank; {row['tok_per_s']:.1f} tok/s (tp=1 "
          f"{row['tp1_tok_per_s']:.1f}), TTFT {row['mean_ttft_ms']:.2f} ms "
          f"(tp=1 {row['tp1_mean_ttft_ms']:.2f}); {graphs.captured} graph "
          f"segments in {graphs.capture_s:.2f} s; tokens equal tp=1's in "
          f"{same}/{N_REQ} requests (the rest part at a printed near tie); "
          "seconds " + json.dumps({k: round(v, 1)
                                   for k, v in seconds.items()}))
    del eng
    torch.cuda.empty_cache()
    return row, {f"{cell}:jit": counts, f"{cell}:jit:rank1": ranks[1]}


def phase_tp() -> tuple:
    """Phase 20: tensor-parallel serving, Llama-3.2-1B at tp=2, both ranks
    on the one card over gloo: f32 logits of the whole model against tp=1,
    then bf16 serving of the whole model on the contiguous cache, the
    paged pool and an int8 pool against tp=1 jit on the same weights.
    Returns
    ({cell: row}, {cell:jit[:rank1]: launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(LLAMA)
    params = model_params(cfg, 201)
    # each cell's tp=2 engine starts (a worker process that imports this
    # script and torch, then receives its shard) while the f32 check runs;
    # the engines then serve one after the other
    with ThreadPoolExecutor(len(TP_CELLS)) as pool:
        starting = {cell: pool.submit(tp_new, cfg, params, TP, **kw)
                    for cell, kw in TP_CELLS.items()}
        try:
            rows = {"llama_tp2_f32": tp_f32_check(cfg, 200)}
            print(f"phase 20: f32 check done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            engines = {cell: f.result() for cell, f in starting.items()}
        except BaseException:
            for f in starting.values():
                if f.exception() is None:
                    f.result().close()
            raise
    print(f"phase 20: tp={TP} engines started at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts = {}
    try:
        for cell, cache_kw in TP_CELLS.items():
            rows[cell], c = tp_cell(cell, cfg, params, cache_kw,
                                    engines[cell])
            counts.update(c)
            print(f"phase 20: {cell} done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        for eng in engines.values():
            eng.close()
    del params
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 20: {secs:.1f} s")
    print("phase 20: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 21
# cut in depth for the script's time limit (PERF.md section 4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 12
TRAIN_LR, TRAIN_WARMUP = 1e-3, 5
# The trained runs draw their n-grams from the first TRAIN_DATA_VOCAB
# token ids (the model keeps its whole 49152-token vocabulary).  Over all
# 49152 ids each id comes ~1.7 times in 20 steps, and at full width the
# loss stays at its initial ~11.0 (the reference's Trainer too); a side
# run prints that.
TRAIN_DATA_VOCAB = 2048
TRAIN_TOP = 12                 # kernels named in the profiled step
TIMED_FROM = 2                 # the median step skips steps 1-2 (warm-up)
RESUME_LAYERS, RESUME_STEPS, RESUME_FAIL = 4, 8, 4
RESUME_TOL = 5e-3              # bf16 loss, other atomics order on resume
TRAIN_KERNELS = ("rmsnorm_matmul", "residual_rmsnorm", "flash_attention")


def backward_cases(cfg, dtype) -> dict:
    """The three ops of the training step at its shapes (SmolLM-360M, B 8 x
    S 512): name -> (wrapper call, plain version, inputs, output
    gradients, the backward formula on the saved tensors, (flops, bytes)
    of the backward, the library's backward or None)."""
    b, s, d = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale, eps = hd ** -0.5, cfg.norm_eps

    def t(shape, seed, sc=1.0):
        return randn(shape, dtype, seed, sc).requires_grad_(True)

    def nb(*ts) -> int:
        return sum(x.numel() * x.element_size() for x in ts)
    out = {}
    q, k, v = t((b, hq, s, hd), 1), t((b, hkv, s, hd), 2), t((b, hkv, s, hd), 3)
    go = randn((b, s, hq, hd), dtype, 4).transpose(1, 2)
    with torch.no_grad():
        o = kernels.flash_attention(q, k, v, scale=scale)
    pairs = b * hq * s * (s + 1) // 2              # causal, S = T
    sdpa = (lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    out["flash_attention"] = (
        lambda q, k, v: kernels.flash_attention(q, k, v, scale=scale),
        lambda q, k, v: attention_ref(q, k, v, scale=scale), (q, k, v),
        (go,), lambda: flash_attention_bwd(go, q, k, v, o, scale=scale),
        (10.0 * pairs * hd, float(2 * nb(q, k, v) + nb(o, go))), sdpa)
    x, r, w = t((b, s, d), 5), t((b, s, d), 6, 0.5), t((d,), 7)
    gy, gs = randn((b, s, d), dtype, 8), randn((b, s, d), dtype, 9)
    out["residual_rmsnorm"] = (
        lambda x, w, r: kernels.residual_rmsnorm(x, w, r, eps=eps),
        lambda x, w, r: residual_rmsnorm_ref(x, w, r, eps), (x, w, r),
        (gy, gs), lambda: residual_rmsnorm_bwd(gy, gs, x, w, r, eps),
        (10.0 * x.numel(), float(2 * nb(x, w, r) + nb(gy, gs))), None)
    out["residual_rmsnorm[final]"] = (
        lambda x, w: kernels.residual_rmsnorm(x, w, eps=eps)[0],
        lambda x, w: residual_rmsnorm_ref(x, w, None, eps)[0], (x, w),
        (gy,), lambda: residual_rmsnorm_bwd(gy, None, x, w, None, eps),
        (10.0 * x.numel(), float(2 * nb(x, w) + nb(gy))), None)
    wp = t((d, hq * hd), 10, 0.03)
    gp, gn = randn((b, s, hq * hd), dtype, 11), randn((b, s, d), dtype, 12)
    with torch.no_grad():
        normed = kernels.rmsnorm_matmul(x, w, wp, eps=eps)[1]
    n_rows = b * s
    out["rmsnorm_matmul"] = (
        lambda x, w, wp: kernels.rmsnorm_matmul(x, w, wp, eps=eps),
        lambda x, w, wp: rmsnorm_matmul_ref(x, w, wp, eps), (x, w, wp),
        (gp, gn),
        lambda: rmsnorm_matmul_bwd(gp, gn, x, w, wp, normed, eps),
        (4.0 * n_rows * d * hq * hd + 10.0 * x.numel(),
         float(2 * nb(x, w, wp) + nb(normed, gp, gn))), None)
    return out


def grads_of(fn, inputs, gouts) -> tuple:
    outs = fn(*inputs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return torch.autograd.grad(list(outs[:len(gouts)]), inputs, list(gouts))


def check_backwards(cfg) -> dict:
    """Each registered backward against autograd through the plain
    version, on the card, in f32 (TF32 off) and bf16; then, in bf16, the
    backward formula's device time beside its bound, the plain version's
    backward and, for flash, SDPA's backward."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (op, plain, ins, gouts, bwd, (flops, nbytes),
                   lib) in backward_cases(cfg, dtype).items():
            got = grads_of(op, ins, gouts)
            want = grads_of(plain, ins, gouts)
            # each gradient against its own tolerance (dW of a product
            # sums over 4096 rows, dweight of a norm too)
            err = max_err(got, want)
            worst = max(max_err(g, w) / rel_bound(w, dtype)
                        for g, w in zip(got, want))
            line = (f"phase 21: {name} backward {str(dtype)[6:]}: max |op - "
                    f"autograd(plain)| {err:.3g}, {worst:.3g} of the "
                    f"tolerance ({TOL[str(dtype)]:g} x max(1, max |plain|) "
                    "a gradient)")
            if not worst <= 1.0:
                fail(line)
            row = {"max_abs_err": err}
            if dtype == torch.bfloat16:
                ms = time_ms(bwd)[0]
                with torch.enable_grad():
                    po = plain(*ins)
                po = po if isinstance(po, (tuple, list)) else (po,)
                plain_ms = time_ms(lambda: torch.autograd.grad(
                    list(po[:len(gouts)]), ins, list(gouts),
                    retain_graph=True))[0]
                lib_ms = None
                if lib is not None:
                    lo = lib(*ins)
                    lib_ms = time_ms(lambda: torch.autograd.grad(
                        lo, ins, gouts[0], retain_graph=True))[0]
                bms, by = bound_ms(nbytes, flops, dtype)
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by, flops=flops,
                           bytes=nbytes)
                lib_txt = "" if lib_ms is None else \
                    f", SDPA backward {lib_ms:.3f} ms"
                line += (f"; {ms:.3f} ms (bound {bms:.3f} ms by {by}), "
                         f"plain backward {plain_ms:.3f} ms{lib_txt}")
            print(line)
            rows[f"{name}:{str(dtype)[6:]}"] = row
        torch.cuda.empty_cache()
    return rows


def train_step(trainer, params, state, batch, ev=None) -> None:
    """One training step as the Trainer's default step takes it, with a
    CUDA event recorded before the forward, the backward, the optimizer
    and after it when ``ev`` (4 events) is given."""
    def mark(i):
        if ev is not None:
            ev[i].record()
    mark(0)
    loss, _ = loss_fn(params, batch, trainer.cfg, remat=False)
    mark(1)
    loss.backward()
    mark(2)
    opt_update(trainer.opt_cfg, tree_map(lambda p: p.grad, params), state,
               params)
    mark(3)
    for p in tree_leaves(params):
        p.grad = None


def train_step_split(trainer, params, state, tries: int = 3) -> dict:
    """One training step split by CUDA events into forward (loss),
    backward and optimizer ms: the median of ``tries`` steps on the next
    batches; then one more step profiled: device busy ms and the kernels
    that take most of it."""
    parts = []
    batches = [to_device(make_batch(trainer.data_cfg, TRAIN_STEPS + i,
                                    trainer.cfg), DEV)
               for i in range(tries + 1)]
    for batch in batches[:tries]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        train_step(trainer, params, state, batch, ev)
        torch.cuda.synchronize()
        parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    med = np.median(np.array(parts), axis=0)
    row = dict(zip(("forward_ms", "backward_ms", "optimizer_ms"),
                   map(float, med)))

    def run():
        train_step(trainer, params, state, batches[tries])
        torch.cuda.synchronize()
    pairs, _ = profiled_kernels(run)
    if not pairs:
        print("phase 21: one profiled step: not measured (no device event)")
        return row
    by: dict = {}
    for k, _ in pairs:
        t, c = by.get(k["name"], (0.0, 0))
        by[k["name"]] = (t + k["dur"] * 1e-3, c + 1)
    busy = sum(t for t, _ in by.values())
    span = (max(k["ts"] + k["dur"] for k, _ in pairs)
            - min(k["ts"] for k, _ in pairs)) * 1e-3
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:TRAIN_TOP]
    row["profile"] = {"busy_ms": busy, "kernels": len(pairs),
                      "span_ms": span,
                      "top": [(k[:80], t, c) for k, (t, c) in top]}
    print(f"phase 21: one profiled step: device busy {busy:.1f} ms in "
          f"{len(pairs)} kernels, first kernel to last {span:.1f} ms; "
          "largest: " + "; ".join(f"{k[:60]} {t:.2f} ms ({c})"
                                  for k, (t, c) in top))
    return row


def train_whole(cfg, tmp: str) -> tuple:
    """Whole SmolLM-360M (bf16 params, f32 AdamW state) trained for
    TRAIN_STEPS steps through ``Trainer``, the launch counts reset just
    before and read just after.  Returns (row, launches a step)."""
    data = DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=TRAIN_DATA_VOCAB)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                   total_steps=TRAIN_STEPS)
    trainer = Trainer(cfg, data, TrainConfig(
        steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
        ckpt_dir=f"{tmp}/whole"), oc, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = trainer.run()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {}
    want = {**norm_launches(cfg), "flash_attention": attention_launches(cfg)}
    for name in TRAIN_KERNELS:
        n = counts[name]
        if n == 0 or n != want[name] * TRAIN_STEPS:
            fail(f"phase 21: train path launched {name} {n} times in "
                 f"{TRAIN_STEPS} steps; expected {want[name]} a step")
        per_step[name] = n // TRAIN_STEPS
    losses = [h["loss"] for h in out["history"]]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"phase 21: loss did not fall: {losses}")
    dts = [h["dt"] for h in out["history"][TIMED_FROM:]]
    step_s = float(np.median(dts))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = param_count(out["params"])
    save = trainer.ckpt.last_save
    save_s = save["copy_s"] + save["write_s"]
    row = {"steps": TRAIN_STEPS, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses,
           "step_ms": step_s * 1e3, "step_ms_all": [d * 1e3 for d in dts],
           "tokens_per_s": tokens / step_s, "params": n_params,
           "tflops": 6 * n_params * tokens / step_s / 1e12,
           "peak_memory_gb": peak / 1e9,
           "stragglers": out["stragglers"],
           "launches_a_step": per_step,
           "checkpoint": {**save, "gb": save["bytes"] / 1e9,
                          "seconds": save_s,
                          "gb_per_s": save["bytes"] / 1e9 / save_s}}
    row["split"] = train_step_split(trainer, out["params"],
                                    out["opt_state"])
    sp, ck = row["split"], row["checkpoint"]
    print(f"phase 21: {cfg.name} whole ({cfg.n_layers} layers, "
          f"{n_params / 1e6:.1f} M params bf16, AdamW f32 state) trained "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens (n-grams "
          f"over {TRAIN_DATA_VOCAB} ids), lr {TRAIN_LR} warmup "
          f"{TRAIN_WARMUP}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"phase 21: step {row['step_ms']:.1f} ms (median of steps "
          f"{TIMED_FROM + 1}-{TRAIN_STEPS}), {row['tokens_per_s']:.0f} "
          f"tokens/s, {row['tflops']:.1f} TFLOP/s by 6 N tokens, peak "
          f"memory {row['peak_memory_gb']:.2f} GB; one step: forward "
          f"{sp['forward_ms']:.1f} ms, backward {sp['backward_ms']:.1f} ms, "
          f"optimizer {sp['optimizer_ms']:.1f} ms; launches a step "
          f"{per_step}")
    print(f"phase 21: final checkpoint {ck['gb']:.3f} GB: host copy "
          f"{ck['copy_s']:.2f} s + write {ck['write_s']:.2f} s = "
          f"{ck['seconds']:.2f} s, {ck['gb_per_s']:.2f} GB/s")
    del out, trainer
    torch.cuda.empty_cache()
    return row, {"train": counts}


def train_full_vocab(cfg, tmp: str) -> dict:
    """TRAIN_STEPS steps of the same recipe with the n-grams over the
    model's whole vocabulary (Trainer's step without its checkpoints):
    the losses, for the record (they do not fall at full width)."""
    data = DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=cfg.vocab_size)
    trainer = Trainer(cfg, data, TrainConfig(
        steps=TRAIN_STEPS, ckpt_dir=f"{tmp}/full_vocab"), OptConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS),
        device=DEV)
    params, state, _ = trainer.restore_or_init()
    losses = []
    for i in range(TRAIN_STEPS):
        batch = to_device(make_batch(data, i, cfg), DEV)
        params, state, m = trainer.default_step(params, state, batch)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 21: non-finite loss over the whole vocabulary: {losses}")
    print(f"phase 21: the same {TRAIN_STEPS} steps with n-grams over all "
          f"{cfg.vocab_size} ids: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(min {min(losses):.4f}, max {max(losses):.4f})")
    del params, state, trainer
    torch.cuda.empty_cache()
    return {"losses": losses}


def train_resume(cfg, tmp: str) -> dict:
    """The crash-and-resume path at RESUME_LAYERS layers (full width): an
    uninterrupted run, a run that fails after step RESUME_FAIL's
    checkpoint, and its restart, whose losses are held against the
    uninterrupted run's."""
    cfg = cfg.replace(n_layers=RESUME_LAYERS)
    data = DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=TRAIN_DATA_VOCAB)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                   total_steps=RESUME_STEPS)

    def run(name, fail_at=None):
        return Trainer(cfg, data, TrainConfig(
            steps=RESUME_STEPS, ckpt_every=RESUME_FAIL,
            ckpt_dir=f"{tmp}/{name}", fail_at_step=fail_at), oc,
            device=DEV).run()
    ref = run("uninterrupted")
    try:
        run("crashed", RESUME_FAIL)
        fail("phase 21: fail_at_step did not fail")
    except RuntimeError as err:
        if "simulated failure" not in str(err):
            raise
    res = run("crashed")
    steps = [h["step"] for h in res["history"]]
    if steps != list(range(RESUME_FAIL, RESUME_STEPS)):
        fail(f"phase 21: the restart ran steps {steps}")
    diff = max(abs(a["loss"] - b["loss"]) for a, b in
               zip(res["history"], ref["history"][RESUME_FAIL:]))
    line = (f"phase 21: crash after step {RESUME_FAIL} of {RESUME_STEPS} "
            f"at {RESUME_LAYERS} layers and restart: largest per-step loss "
            f"difference against the uninterrupted run {diff:.3g} "
            f"(<= {RESUME_TOL})")
    if not diff <= RESUME_TOL:
        fail(line)
    print(line)
    return {"layers": RESUME_LAYERS, "fail_at": RESUME_FAIL,
            "max_loss_diff": diff}


def phase_train() -> tuple:
    """Phase 21: training.  Returns (row, {"train": launch counts})."""
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    rows = {"backward": check_backwards(cfg)}
    with tempfile.TemporaryDirectory() as tmp:
        rows["whole"], counts = train_whole(cfg, tmp)
        rows["whole_full_vocab"] = train_full_vocab(cfg, tmp)
        rows["resume"] = train_resume(cfg, tmp)
    secs = time.perf_counter() - t0
    print(f"phase 21: {secs:.1f} s")
    print("phase 21: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ phase 22
# Two rank processes share cuda:0 and exchange over gloo through host
# memory: the times are no parallel speed.
MR_RANKS = 2
MR_SHARE = "two ranks time-sharing cuda:0 over gloo: no parallel speed"
# (a): 8 x 512 tokens a step, 4 a rank; the steps cut in depth for the
# script's time limit (PERF.md section 4)
MR_STEPS, MR_BATCH = 6, 8
COMPRESS_TOL = 0.05                 # the reference test's relative bound
EP_ARCH, EP_LAYERS, EP_BATCH, EP_SEQ = "moonshot-v1-16b-a3b", 2, 2, 256
EP_CF = 8.0                         # nothing drops (the reference test's)
EP_TOL_F32 = 1e-4                   # relative, 1 layer, TF32 off
# bf16, 2 layers: a leaf's gradient error over its largest local value
# (sound runs read 0.19-0.23; a dropped or ep-scaled expert gradient reads
# 1 by construction, a misrouted one is measured each run), and the share
# of tokens whose experts a rounding near-tie may flip (sound: 0.4-3.1 %)
EP_GRAD_TOL_BF16, EP_FLIP_MAX = 0.5, 0.05
PP_MICRO, PP_MB = 4, 2              # (c): 4 microbatches of 2 x 512


def mr_checksum(params) -> int:
    """A checksum of every parameter's bits, on the device."""
    total = 0
    for i, p in enumerate(tree_leaves(params)):
        b = p.detach().reshape(-1).view(torch.int16).int()
        total += (i + 1) * int(b.sum(dtype=torch.int64)) + \
            int((b * b).sum(dtype=torch.int64))
    return total


def mr_sync(ctx) -> float:
    torch.cuda.synchronize(ctx.device)
    return time.perf_counter()


def mr_dp_train(ctx, steps: int, layers: int | None = None) -> dict:
    """(a), on each rank: SmolLM-360M (bf16, the same seed on every rank;
    whole, or cut to ``layers``) trained ``steps`` steps of
    ``make_compressed_dp_grad`` plus AdamW on the rank's 4 x 512 rows of
    phase 21's n-gram batches.  First, for the check only, the first
    batch's local gradients meaned exactly (an f32 all-reduce); then the
    launch counts reset and the steps run."""
    cfg = get_config(ARCH)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    dev = ctx.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                   total_steps=steps)
    state = opt_init(oc, params)
    data = DataConfig(batch=MR_BATCH, seq_len=TRAIN_SEQ,
                      vocab_size=TRAIN_DATA_VOCAB)
    n, r = ctx.size("data"), ctx.index("data")
    rows = slice(r * MR_BATCH // n, (r + 1) * MR_BATCH // n)

    def local(i):
        return {k: v[rows] for k, v in
                to_device(make_batch(data, i, cfg), dev).items()}

    def loss(p, b):
        return loss_fn(p, b, cfg, remat=False)
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    g0 = torch.autograd.grad(loss(ps, local(0))[0], tree_leaves(ps))
    exact = raw_psum(torch.cat([g.float().reshape(-1) for g in g0]), ctx,
                     "data") / n
    del ps, g0
    step = make_compressed_dp_grad(loss, ctx, "data")
    errors = init_error_state(params)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    out = {"losses": [], "checksums": [], "step_ms": [], "exchange_ms": [],
           "optimizer_ms": []}
    for i in range(steps):
        batch = local(i)
        w0, t0 = dataclasses.replace(ctx.wire), mr_sync(ctx)
        grads, errors, lv = step(params, errors, batch)
        t1 = mr_sync(ctx)
        opt_update(oc, grads, state, params)
        t2 = mr_sync(ctx)
        if i == 0:
            g = torch.cat([x.float().reshape(-1) for x in tree_leaves(grads)])
            out["first_rel"] = float((g - exact).norm() / exact.norm())
            out["wire_a_step"] = ctx.wire.bytes - w0.bytes
            out["wire"] = wire_bytes(grads, n)
            del g, exact
        out["losses"].append(float(lv))
        out["checksums"].append(mr_checksum(params))
        out["step_ms"].append((t2 - t0) * 1e3)
        out["exchange_ms"].append((ctx.wire.seconds - w0.seconds) * 1e3)
        out["optimizer_ms"].append((t2 - t1) * 1e3)
        del grads
    out["launches"] = kernels.launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def ep_config(dtype: str, layers: int, cf: float):
    base = get_config(EP_ARCH)
    return base.replace(n_layers=layers, param_dtype=dtype,
                        compute_dtype=dtype,
                        moe=dataclasses.replace(base.moe,
                                                capacity_factor=cf))


def grads_of_loss(params, batch, cfg, **kw) -> tuple:
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(ps, batch, cfg, remat=False, aux_weight=0.0, **kw)
    return float(loss.detach()), dict(zip(
        [k for k, _ in named_leaves(ps)],
        torch.autograd.grad(loss, tree_leaves(ps))))


@contextlib.contextmanager
def recorded_dispatch():
    """Record each MoE dispatch's expert ids (sorted a token) and dropped
    assignments while the block runs."""
    dispatch, calls = moe_layer.dispatch_slots, []

    def recording(eids, n_experts, cap):
        slot, keep = dispatch(eids, n_experts, cap)
        calls.append((eids.sort(dim=-1).values, int((~keep).sum())))
        return slot, keep
    moe_layer.dispatch_slots = recording
    try:
        yield calls
    finally:
        moe_layer.dispatch_slots = dispatch


@contextlib.contextmanager
def ep_mode(mode: str):
    """The model's MoE layers in EP ``mode`` (``forward`` leaves it to the
    reference's auto rule, which picks seq at S 256)."""
    fwd = moe_layer.moe_fwd
    moe_layer.moe_fwd = functools.partial(fwd, mode=mode)
    try:
        yield
    finally:
        moe_layer.moe_fwd = fwd


def mr_ep_check(ctx, dtype: str, layers: int, cf: float, modes: tuple,
                local: bool) -> dict:
    """(b), on each rank: Moonlight at full width cut to ``layers``, the
    same seed on every rank; for each EP mode the logits and aux of
    ``forward(dist=)`` and ``loss_fn(dist=, aux_weight=0)`` with its
    gradients, held (with ``local``) against the local path on the whole
    parameters over the same batch: per leaf the largest difference of
    the gradients of the rank's slice (and over the leaf's largest
    magnitude); the largest logits difference over the tokens this rank
    routes (``seq``: its slice of the sequence) and over those of them
    whose expert sets equal the local path's in every layer (a router
    near-tie that rounding at another point flips changes a token's
    experts; such tokens are counted).  Beside them, what a fault would
    read: each expert leaf's gradient against the other rank's experts'
    local gradient (a misrouted expert).  The assignments dropped per
    shard, per MoE layer and mode."""
    cfg = ep_config(dtype, layers, cf)
    dev = ctx.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(22),
                         device=dev)
    mesh = ctx.mesh
    dist = moe_layer.MeshContext(mesh, ("data",), "model", ranks=ctx)
    specs = expert_param_specs(params, cfg, mesh)
    shard = shard_for_rank(params, specs, mesh, ctx.rank)
    rng = np.random.default_rng(22)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (EP_BATCH, EP_SEQ)), device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    k = cfg.moe.top_k
    out = {}
    if local:
        with torch.no_grad(), recorded_dispatch() as ref_routes:
            ref_logits, _, ref_aux = forward(params, tokens, cfg,
                                             with_aux=True)
        ref_loss, ref_g = grads_of_loss(params, batch, cfg)
        whole_g = unflatten_named(params, ref_g)
        ref_g = dict(named_leaves(shard_for_rank(whole_g, specs, mesh,
                                                 ctx.rank)))
        # the other rank's experts' gradients: a misrouting fault's reading
        other_g = dict(named_leaves(shard_for_rank(
            whole_g, specs, mesh, (ctx.rank + 1) % mesh.size)))
        full = dict(named_leaves(params))
        experts = [key for key in ref_g if ref_g[key].shape
                   != full[key].shape]
        del whole_g, full
        out["local"] = {"aux": float(ref_aux), "loss": ref_loss}
    for mode in modes:
        with ep_mode(mode):
            t0 = mr_sync(ctx)
            with torch.no_grad(), recorded_dispatch() as routes:
                logits, _, aux = forward(shard, tokens, cfg, with_aux=True,
                                         dist=dist)
            t1 = mr_sync(ctx)
            loss, g = grads_of_loss(shard, batch, cfg, dist=dist)
            t2 = mr_sync(ctx)
        row = {"aux": float(aux), "loss": loss,
               "drops": [d for _, d in routes],
               "forward_ms": (t1 - t0) * 1e3,
               "loss_and_grads_ms": (t2 - t1) * 1e3}
        if local:
            # the (B, S) tokens this rank routes, and those whose experts
            # differ from the local path's in some layer
            own = slice(None)
            if mode == "seq":
                n = EP_SEQ // ctx.size("model")
                own = slice(ctx.index("model") * n,
                            (ctx.index("model") + 1) * n)
            flipped = torch.zeros((EP_BATCH, EP_SEQ), dtype=torch.bool,
                                  device=dev)[:, own]
            for (mine, _), (ref, _) in zip(routes, ref_routes):
                ref = ref.view(EP_BATCH, EP_SEQ, k)[:, own]
                flipped |= (mine.view(ref.shape) != ref).any(-1)
            diff = (logits.float() - ref_logits.float()).abs()[:, own]
            diff = diff.amax(-1)
            row["logits_err"] = float(diff.max())
            row["logits_err_same_routes"] = float(
                diff[~flipped].max()) if bool((~flipped).any()) else 0.0
            row["flipped"] = int(flipped.sum())
            row["routed"] = int(flipped.numel())
            row["logits_scale"] = float(ref_logits.float().abs().max())
            rel = {}
            for key, v in g.items():
                scale = float(ref_g[key].float().abs().max())
                rel[key] = float((v.float() - ref_g[key].float()).abs()
                                 .max()) / max(scale, 1e-30)
            worst = max(rel, key=rel.get)
            row["grad_rel"] = rel[worst]
            row["grad_rel_leaf"] = worst
            row["grad_rel_misrouted"] = min(
                float((g[key].float() - other_g[key].float()).abs().max())
                / max(float(other_g[key].float().abs().max()), 1e-30)
                for key in experts)
            row["grad_abs"] = max(
                float((v.float() - ref_g[key].float()).abs().max())
                for key, v in g.items())
        out[mode] = row
    return out


def unflatten_named(tree, named: dict):
    """``tree``'s structure with ``named[key]`` at every leaf."""
    values = iter([named[k] for k, _ in named_leaves(tree)])
    return tree_map(lambda _: next(values), tree)


def mr_pipeline(ctx, n_micro: int, mb: int,
                layers: int | None = None) -> dict:
    """(c), on each rank: SmolLM-360M (bf16; whole, or cut to ``layers``)
    split into one stage a rank (``pipeline_stages``, ``stage_forward`` as
    the stage function); a warm-up, then the GPipe schedule over
    ``n_micro`` microbatches of mb x 512 embedded tokens with the launch
    counts reset before it, then (rank 0) the sequential
    ``reference_forward`` of all stages on the same inputs."""
    cfg = get_config(ARCH)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    dev = ctx.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    stage = ctx.index("pipe")
    stages = pipeline_stages(params, ctx.size("pipe"))
    rng = np.random.default_rng(23)
    tokens = torch.tensor(rng.integers(0, TRAIN_DATA_VOCAB,
                                       (n_micro, mb, TRAIN_SEQ)), device=dev)
    x = embed_tokens(params["embed"], tokens, cfg).to(cfg.cdtype)
    fn = functools.partial(stage_forward, cfg=cfg)
    out = {}
    with torch.no_grad():
        pipeline_forward(fn, stages[stage], x, ctx, "pipe")
        kernels.reset_launch_counts()
        t0 = mr_sync(ctx)
        y = pipeline_forward(fn, stages[stage], x, ctx, "pipe")
        out["pipelined_ms"] = (mr_sync(ctx) - t0) * 1e3
        out["launches"] = kernels.launch_counts()
        if stage == 0:
            reference_forward(fn, stages, x[:1])
            t0 = mr_sync(ctx)
            ref = reference_forward(fn, stages, x)
            out["sequential_ms"] = (mr_sync(ctx) - t0) * 1e3
            out["max_err"] = max_err(y, ref)
            out["equal"] = bool(torch.equal(y, ref))
            out["finite"] = bool(torch.isfinite(y).all())
    return out


def mr_cell_a(pool) -> tuple:
    """(a): data parallel with the int8 wire.  Returns (row, launches a
    step and rank)."""
    cfg = get_config(ARCH)
    mesh = make_host_mesh(data=MR_RANKS, model=1, device=DEV)
    outs = pool.run(mr_dp_train, mesh, [(MR_STEPS,)] * MR_RANKS)
    a, b = outs
    if a["checksums"] != b["checksums"]:
        bad = next(i for i, (x, y) in enumerate(zip(a["checksums"],
                                                    b["checksums"]))
                   if x != y)
        fail(f"phase 22 (a): parameters differ between the ranks after "
             f"step {bad + 1}")
    losses = a["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"phase 22 (a): loss did not fall: {losses}")
    rel = max(o["first_rel"] for o in outs)
    if not rel <= COMPRESS_TOL:
        fail(f"phase 22 (a): first compressed mean gradient {rel:.4f} "
             f"relative from the exact mean (> {COMPRESS_TOL})")
    want = {**norm_launches(cfg), "flash_attention": attention_launches(cfg)}
    per_step = {}
    for name in TRAIN_KERNELS:
        got = [o["launches"][name] for o in outs]
        if any(n != want[name] * MR_STEPS for n in got):
            fail(f"phase 22 (a): dp_train launched {name} {got} times a "
                 f"rank in {MR_STEPS} steps; expected {want[name]} a step")
        per_step[name] = got[0] // MR_STEPS
    timed = slice(TIMED_FROM, None)
    step = float(np.median(a["step_ms"][timed]))
    exch = float(np.median(a["exchange_ms"][timed]))
    opt = float(np.median(a["optimizer_ms"][timed]))
    row = {"steps": MR_STEPS, "ranks": MR_RANKS, "losses": losses,
           "first_rel": rel, "step_ms": step, "exchange_ms": exch,
           "compute_ms": step - exch - opt, "optimizer_ms": opt,
           "step_ms_all": a["step_ms"], "exchange_ms_all": a["exchange_ms"],
           "wire_handed_to_gloo": a["wire_a_step"], "wire": a["wire"],
           "peak_gb_ranks": [o["peak_gb"] for o in outs],
           "launches_a_step": per_step}
    print(f"phase 22 (a): {cfg.name} whole, {MR_RANKS} data ranks x "
          f"{MR_BATCH // MR_RANKS} x {TRAIN_SEQ} tokens, int8 compressed "
          f"gradients + AdamW, {MR_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; first step's mean {rel:.4f} relative from the "
          f"exact mean (<= {COMPRESS_TOL}); parameters bit-identical across "
          f"the ranks after every step")
    print(f"phase 22 (a): step {step:.1f} ms = compute {row['compute_ms']:.1f}"
          f" + exchange {exch:.1f} + AdamW {opt:.1f} (median of steps "
          f"{TIMED_FROM + 1}-{MR_STEPS}; {MR_SHARE}); wire a step and rank: "
          f"int8 {a['wire']['int8'] / 1e6:.1f} MB sent + received against "
          f"an f32 all-reduce's {a['wire']['f32_allreduce'] / 1e6:.1f} MB "
          f"({a['wire_a_step'] / 1e6:.1f} MB handed to gloo); peak memory "
          f"{' + '.join(f'{g:.2f}' for g in row['peak_gb_ranks'])} = "
          f"{sum(row['peak_gb_ranks']):.2f} GB; launches a step and rank "
          f"{per_step}")
    return row, {name: per_step[name] for name in TRAIN_KERNELS}


def ep_row(outs: list, mode: str) -> dict:
    """The ranks' ``mr_ep_check`` rows of ``mode`` as one: the largest
    errors, the smallest misrouted reading, the flipped tokens of all
    ranks (a ``seq`` rank routes its slice of the sequence, a ``rep`` rank
    all of it)."""
    rs = [o[mode] for o in outs]
    row = {key: max(r[key] for r in rs) for key in (
        "logits_err", "logits_err_same_routes", "grad_rel", "grad_abs",
        "logits_scale")}
    seq = mode == "seq"
    row.update({
        "grad_rel_misrouted": min(r["grad_rel_misrouted"] for r in rs),
        "flipped": (sum if seq else max)(r["flipped"] for r in rs),
        "routed": (sum if seq else max)(r["routed"] for r in rs),
        "grad_rel_leaf": max(rs, key=lambda r: r["grad_rel"])[
            "grad_rel_leaf"],
        "aux": rs[0]["aux"], "aux_local": outs[0]["local"]["aux"],
        "loss": rs[0]["loss"], "loss_local": outs[0]["local"]["loss"],
        "forward_ms": rs[0]["forward_ms"],
        "loss_and_grads_ms": rs[0]["loss_and_grads_ms"]})
    return row


def ep_gate(row: dict, dtype: str) -> tuple:
    """(ok, the tolerance in words) of an EP-against-local row: f32 holds
    logits and every leaf's gradient within EP_TOL_F32 relative; bf16
    holds the share of route-flipped tokens within EP_FLIP_MAX, the other
    tokens' logits within LOGIT_TOL_BF16 and every leaf's gradient within
    EP_GRAD_TOL_BF16 of its largest local value, and needs a misrouted
    expert's reading above that bound."""
    if dtype == "float32":
        ok = row["grad_rel"] <= EP_TOL_F32 and \
            row["logits_err"] <= EP_TOL_F32 * row["logits_scale"]
        return ok, f"{EP_TOL_F32} relative"
    ok = row["grad_rel"] <= EP_GRAD_TOL_BF16 < row["grad_rel_misrouted"] \
        and row["flipped"] <= EP_FLIP_MAX * row["routed"] \
        and row["logits_err_same_routes"] <= LOGIT_TOL_BF16
    return ok, (f"gradients {EP_GRAD_TOL_BF16} of the leaf's largest, "
                f"below a misrouted reading; at most {EP_FLIP_MAX:.0%} of "
                f"the tokens flipped; logits {LOGIT_TOL_BF16} where the "
                f"routes agree")


def mr_cell_b(pool) -> dict:
    """(b): expert parallel at ep = 2 against one rank's local path.  It
    prints every line before it fails on any."""
    mesh = make_host_mesh(data=1, model=MR_RANKS, device=DEV)
    rows, bad = {}, []
    for dtype, layers in (("bfloat16", EP_LAYERS), ("float32", 1)):
        outs = pool.run(mr_ep_check, mesh, [(dtype, layers, EP_CF,
                                             ("seq", "rep"), True)]
                        * MR_RANKS)
        for mode in ("seq", "rep"):
            row = ep_row(outs, mode)
            ok, tol = ep_gate(row, dtype)
            line = (f"phase 22 (b): {EP_ARCH} full width, {layers} of 48 "
                    f"layers, {dtype}, ep {MR_RANKS} {mode}, capacity "
                    f"factor {EP_CF}, batch {EP_BATCH} x {EP_SEQ}: against "
                    f"the local path gradients (aux_weight 0) "
                    f"{row['grad_abs']:.3g} abs, {row['grad_rel']:.3g} of "
                    f"the leaf's largest ({row['grad_rel_leaf']}; a "
                    f"misrouted expert would read "
                    f"{row['grad_rel_misrouted']:.3g}); logits "
                    f"{row['logits_err_same_routes']:.3g} over the tokens "
                    f"routed as local's in every layer, "
                    f"{row['logits_err']:.3g} over all (max |logit| "
                    f"{row['logits_scale']:.3g}; {row['flipped']} of "
                    f"{row['routed']} tokens routed differently in some "
                    f"layer) (tolerance {tol}); aux {row['aux']:.6f} (per "
                    f"shard) beside local's {row['aux_local']:.6f}; forward "
                    f"{row['forward_ms']:.1f} ms, loss and gradients "
                    f"{row['loss_and_grads_ms']:.1f} ms ({MR_SHARE})")
            print(line, flush=True)
            if not ok:
                bad.append(line)
            rows[f"{dtype}_{mode}"] = row
    cf = get_config(EP_ARCH).moe.capacity_factor
    outs = pool.run(mr_ep_check, mesh, [("bfloat16", EP_LAYERS, cf,
                                         ("seq", "rep"), False)] * MR_RANKS)
    k = get_config(EP_ARCH).moe.top_k
    for mode in ("seq", "rep"):
        drops = [o[mode]["drops"] for o in outs]
        rows[f"drops_{mode}"] = drops
        # a seq shard routes its slice of the sequence, a rep shard all
        per_shard = EP_BATCH * EP_SEQ * k // (MR_RANKS if mode == "seq"
                                             else 1)
        print(f"phase 22 (b): at Moonlight's own capacity factor {cf}, "
              f"{mode}: assignments dropped per shard (rank) and MoE layer "
              f"{drops} of {per_shard} a shard and layer; aux "
              f"{outs[0][mode]['aux']:.6f}")
    if bad:
        fail("\n".join(bad))
    return rows


def mr_cell_c(pool) -> dict:
    """(c): the GPipe pipeline of SmolLM-360M's 32 blocks in 2 stages."""
    mesh = Mesh({"pipe": MR_RANKS}, (DEV,) * MR_RANKS)
    outs = pool.run(mr_pipeline, mesh, [(PP_MICRO, PP_MB)] * MR_RANKS)
    a = outs[0]
    if not a["finite"] or a["max_err"] > TOL[str(torch.bfloat16)]:
        fail(f"phase 22 (c): pipelined output {a['max_err']:.3g} from the "
             f"sequential run (finite {a['finite']})")
    per = get_config(ARCH).n_layers // MR_RANKS
    ticks = PP_MICRO + MR_RANKS - 1
    for o in outs:
        if o["launches"]["flash_attention"] != per * ticks:
            fail(f"phase 22 (c): a stage launched flash_attention "
                 f"{o['launches']['flash_attention']} times in {ticks} "
                 f"ticks; expected {per} a tick")
    row = {"pipelined_ms": a["pipelined_ms"],
           "sequential_ms": a["sequential_ms"], "max_err": a["max_err"],
           "equal": a["equal"],
           "bubble": bubble_fraction(MR_RANKS, PP_MICRO),
           "launches_a_stage": outs[0]["launches"]}
    print(f"phase 22 (c): {ARCH}'s {2 * per} blocks in {MR_RANKS} stages "
          f"of {per}, {PP_MICRO} microbatches of {PP_MB} x {TRAIN_SEQ} "
          f"(bf16, forward): against reference_forward on one rank max "
          f"error {a['max_err']:.3g} (bit-equal: {a['equal']}); pipelined "
          f"{a['pipelined_ms']:.1f} ms, sequential {a['sequential_ms']:.1f} "
          f"ms, bubble (P - 1) / ticks = {row['bubble']:.3f} ({MR_SHARE})")
    return row


@contextlib.contextmanager
def rank_pool(pool=None):
    """``pool``, or a pool of MR_RANKS ranks sharing the card for the
    block (phases 22 and 23 share one when run together)."""
    if pool is not None:
        yield pool
        return
    with RankPool(MR_RANKS, DEV, timeout_s=900) as own:
        yield own


def phase_multirank(pool=None) -> tuple:
    """Phase 22: the multi-rank training pieces on one pool of two ranks
    that share the card.  Returns (rows, {"dp_train": launches a step})."""
    t0 = time.perf_counter()
    with rank_pool(pool) as pool:
        print(f"phase 22: {MR_RANKS} ranks started at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows = {}
        rows["dp_train"], dp_counts = mr_cell_a(pool)
        rows["ep"] = mr_cell_b(pool)
        rows["pipeline"] = mr_cell_c(pool)
    secs = time.perf_counter() - t0
    print(f"phase 22: {secs:.1f} s")
    print("phase 22: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, {"dp_train": dp_counts}


# ------------------------------------------------------------------ phase 23
# The step builders (launch/steps.py) and the dry run (launch/dryrun.py).
ST_ARCH, ST_BATCH, ST_SEQ = LLAMA, 2, 256
ST_STEPS, ST_DECODES, ST_F32_LAYERS = 3, 3, 2
ST_OPT = dict(lr=1e-3, warmup_steps=0)
# the f32 check's AdamW eps: at the default 1e-8 the first step is nearly
# the gradient's sign, and an element whose gradient is near 1e-8 turns
# its f32 rounding into an update error of the step's size (lr)
ST_F32_EPS = 1e-4
# bf16 whole, tp 2 against tp 1: the loss within ST_LOSS_BF16 (other
# reduction orders through 16 layers), the logits' largest difference
# within ST_LOGITS_BF16 of their largest magnitude; f32 at 2 layers (TF32
# off): the loss, the logits and every parameter after one step within
# ST_F32 (absolute).  The first step's update is nearly the gradient's
# sign, so the gradient's scale is held apart: the global norm within
# ST_GNORM (relative), and AdamW's first moment, 0.1 x the clipped
# gradient, of every leaf within ST_MOMENT of the leaf's largest (a
# leaf's gradient summed once too often or too seldom over the model
# axis is off by 0.5 to 1 of it; the H100 read 0 and 3.9e-6-4.6e-6)
ST_LOSS_BF16, ST_LOGITS_BF16, ST_F32 = 2e-2, 5e-2, 1e-4
ST_GNORM, ST_MOMENT = 1e-6, 1e-4
# the dry run's peak of temporaries against the rank's measured one
# (max_memory_allocated over the call less what was allocated before):
# within ST_PEAK_REL of the measured plus ST_PEAK_ARG of the call's
# arguments (the caching allocator's rounding, which a trace does not see)
ST_PEAK_REL, ST_PEAK_ARG = 0.05, 2e-4
# the production-mesh cells run here (the whole --all: a chip call of its
# own); the dense, the FSDP-expert MoE, RWKV-6's training and a 500 k cell
DRY_CELLS = (("internlm2-20b", "decode_32k"), ("kimi-k2-1t-a32b", "decode_32k"),
             ("rwkv6-3b", "train_4k"), ("jamba-1.5-large-398b", "long_500k"))
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 4, 6
WKV_BWD = (8, 512, 40, 64)          # B, T, H, hd of the backward's check


def st_config(layers: int | None, dtype: str):
    cfg = get_config(ST_ARCH).replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg.replace(n_layers=layers) if layers else cfg


def st_bundles(cfg, mesh) -> tuple:
    """The train, prefill and decode bundles of phase 23 over ``mesh``:
    a prefill of ST_SEQ tokens into its ST_SEQ-position cache, decode
    steps over a cache of ST_SEQ + ST_DECODES positions (the prefill's
    copied into its first ST_SEQ)."""
    eps = {"eps": ST_F32_EPS} if cfg.param_dtype == "float32" else {}
    train = build_train_step(cfg, ShapeSpec("st_train", ST_SEQ, ST_BATCH,
                                            "train"), mesh,
                             opt_cfg=OptConfig(**ST_OPT, **eps),
                             options=StepOptions(microbatches=1))
    pre = build_serve_step(cfg, ShapeSpec("st_prefill", ST_SEQ, ST_BATCH,
                                          "prefill"), mesh, mode="prefill")
    dec = build_serve_step(cfg, ShapeSpec("st_decode", ST_SEQ + ST_DECODES,
                                          ST_BATCH, "decode"), mesh,
                           mode="decode")
    return train, pre, dec


def st_global(cfg, train, dev) -> tuple:
    """The whole inputs: weights drawn on the card from seed 23, their
    AdamW state, a batch and the serving tokens."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(23),
                         device=dev)
    opt = opt_init(train.plan.opt_cfg, stack_blocks(params, cfg))
    g = torch.Generator().manual_seed(23)
    toks = torch.randint(0, TRAIN_DATA_VOCAB, (ST_BATCH,
                                               ST_SEQ + ST_DECODES + 1),
                         generator=g, dtype=torch.int32).to(dev)
    batch = {"tokens": toks[:, :ST_SEQ], "labels": toks[:, 1:ST_SEQ + 1]}
    return params, opt, batch, toks


def logical_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(logical_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(logical_bytes(v) for v in tree)
    return 0


def st_sync(dev) -> float:
    torch.cuda.synchronize(dev)
    return time.perf_counter()


def st_call(ctx, fn, args) -> tuple:
    """(result, ms, exchange ms, peak temporaries) of one call."""
    dev = ctx.device
    st_sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    w0, t0 = ctx.wire.seconds, st_sync(dev)
    out = fn(ctx, *args)
    t1 = st_sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return out, (t1 - t0) * 1e3, (ctx.wire.seconds - w0) * 1e3, peak


def st_caches(cfg, pre, dec, rank: int) -> tuple:
    """The rank's slices of the prefill's and the decode steps' caches."""
    out = []
    for b in (pre, dec):
        whole = make_cache(cfg, ST_BATCH, b.shape.seq_len,
                           device=b.mesh.devices[rank])
        out.append(b.rank_slice(2, whole, rank))
    return tuple(out)


def st_serve(ctx, pre, dec, params_shard, caches, toks) -> tuple:
    """A prefill and ST_DECODES decode steps on one rank: the last
    position's logits (the rank's vocabulary block) of each, and the
    calls' (ms, exchange ms, peak)."""
    pcache, dcache = caches
    tok = pre.rank_slice(1, toks[:, :ST_SEQ], ctx.rank)
    (logits, pcache), *meas = st_call(ctx, pre.fn, (params_shard, tok,
                                                    pcache, 0))
    last, calls = [logits[:, -1].float()], [meas]
    for layer, filled in zip(dcache, pcache):
        for name in ("k", "v"):
            layer[name][:, :ST_SEQ].copy_(filled[name])
    for i in range(ST_DECODES):
        tok = dec.rank_slice(1, toks[:, ST_SEQ + i:ST_SEQ + i + 1],
                             ctx.rank)
        (logits, dcache), *meas = st_call(ctx, dec.fn, (
            params_shard, tok, dcache, ST_SEQ + i))
        last.append(logits[:, -1].float())
        calls.append(meas)
    return torch.stack(last), calls


def st_rank(ctx, layers, dtype: str, steps: int, compare: bool) -> dict:
    """Phase 23 on one rank: the train bundle ``steps`` times, then a
    prefill and decode steps, over the pool's mesh; with ``compare`` the
    same bundles on a one-rank mesh in this process too, from the same
    weights, and this rank's slices compared."""
    dev = ctx.device
    cfg = st_config(layers, dtype)
    train, pre, dec = st_bundles(cfg, ctx.mesh)
    params, opt, batch, toks = st_global(cfg, train, dev)
    tin = train.rank_inputs((params, opt, batch), ctx.rank)
    del opt
    caches = st_caches(cfg, pre, dec, ctx.rank)
    # the cache index: a 0-d int32, as the bundles' input specs hold it
    out = {"arg_bytes": {
        "train": logical_bytes(tin),
        "prefill": logical_bytes((tin[0], caches[0])) + 4 +
        logical_bytes(pre.rank_slice(1, toks[:, :ST_SEQ], ctx.rank)),
        "decode": logical_bytes((tin[0], caches[1])) + 4 +
        logical_bytes(dec.rank_slice(1, toks[:, :1], ctx.rank))}}
    ref = None
    if compare:
        one = make_host_mesh(data=1, model=1, device=dev)
        rctx, _ = dry_context(one, 0, device=dev)
        r_train, r_pre, r_dec = st_bundles(cfg, one)
        r_opt = opt_init(r_train.plan.opt_cfg, stack_blocks(params, cfg))
        r_params = tree_map(lambda t: t.clone(), params)
        ref = {"loss": [], "gnorm": []}
        for _ in range(steps):
            _, _, m = r_train.fn(rctx, r_params, r_opt, batch)
            ref["loss"].append(float(m["loss"]))
            ref["gnorm"].append(float(m["grad_norm"]))
        ref["logits"], _ = st_serve(rctx, r_pre, r_dec, params,
                                    st_caches(cfg, r_pre, r_dec, 0), toks)
        ref["params"] = shard_for_rank(r_params, train.plan.specs[0],
                                       ctx.mesh, ctx.rank)
        ref["moment"] = train.rank_slice(1, r_opt, ctx.rank)["m"]
        del r_opt, r_params
    del params
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    losses, gnorms, calls = [], [], []
    serve_params = tree_map(lambda t: t.clone(), tin[0])
    for _ in range(steps):
        (_, _, m), *meas = st_call(ctx, train.fn, tin)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        calls.append(meas)
    out["train_launches"] = kernels.launch_counts()
    out["losses"], out["train_calls"] = losses, calls
    kernels.reset_launch_counts()
    last, out["serve_calls"] = st_serve(ctx, pre, dec, serve_params, caches,
                                        toks)
    out["serve_launches"] = kernels.launch_counts()
    if ref is not None:
        n = last.shape[-1]
        want = ref["logits"][..., ctx.rank * n:(ctx.rank + 1) * n]
        out["logits_err"] = float((last - want).abs().max())
        out["logits_scale"] = float(want.abs().max())
        out["loss_err"] = max(abs(a - b) for a, b in
                              zip(losses, ref["loss"]))
        out["param_err"] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(tree_leaves(tin[0]),
                                               tree_leaves(ref["params"])))
        out["gnorm_err"] = max(abs(a - b) / b
                               for a, b in zip(gnorms, ref["gnorm"]))
        out["moment_err"] = max(leaf_rel_err(a, b) for a, b in zip(
            tree_leaves(tin[1]["m"]), tree_leaves(ref["moment"])))
        out["gnorms"], out["ref_gnorms"] = gnorms, ref["gnorm"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def leaf_rel_err(got, want) -> float:
    """max |got - want| over the leaf's largest |want| (0 where both are
    0 everywhere)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def st_dry(cfg, mesh) -> dict:
    """The dry run of phase 23's bundles on the same mesh: rank 0's trace,
    as ``launch.dryrun`` traces a cell (over (data 1, model 2) the two
    ranks hold slices of one shape)."""
    return {b.name: dryrun.trace_rank(b, 0)["memory"]
            for b in st_bundles(cfg, mesh)}


def st_check(rows: list, dry: dict, label: str) -> None:
    """Arguments equal to the dry run's; the measured peak of each call
    within the stated tolerance of the dry run's temporaries."""
    for r, row in enumerate(rows):
        for kind in ("train", "prefill", "decode"):
            d = dry[kind]
            if row["arg_bytes"][kind] != d["argument_bytes"]:
                fail(f"phase 23 {label} rank {r} {kind}: arguments "
                     f"{row['arg_bytes'][kind]} B measured, "
                     f"{d['argument_bytes']} B in the dry run")
            if kind == "train":
                peak = max(c[2] for c in row["train_calls"])
            elif kind == "prefill":
                peak = row["serve_calls"][0][2]
            else:
                peak = max(c[2] for c in row["serve_calls"][1:])
            slack = ST_PEAK_REL * peak + ST_PEAK_ARG * d["argument_bytes"]
            ok = abs(peak - d["temp_bytes"]) <= slack
            print(f"phase 23: {label} rank {r} {kind}: arguments "
                  f"{row['arg_bytes'][kind] / 1e6:.3f} MB measured = "
                  f"{d['argument_bytes'] / 1e6:.3f} MB dry; temporaries "
                  f"{peak / 1e6:.3f} MB measured (max_memory_allocated "
                  f"less the arguments' allocation) vs "
                  f"{d['temp_bytes'] / 1e6:.3f} MB dry, within "
                  f"{slack / 1e6:.3f} MB [{'held' if ok else 'FAILED'}]")
            if not ok:
                fail(f"phase 23 {label} rank {r} {kind}: measured "
                     f"temporaries {peak} B, dry {d['temp_bytes']} B: "
                     f"outside {ST_PEAK_REL} x measured + {ST_PEAK_ARG} x "
                     f"the arguments ({slack:.0f} B)")


def st_ranks(pool, mesh, t0: float) -> tuple:
    """(a) and (b): the bundles on two ranks, bf16 whole then f32 at
    ST_F32_LAYERS; each beside a one-rank mesh; then the dry run."""
    def stamp(what: str) -> None:
        print(f"phase 23: {what} at {time.perf_counter() - t0:.1f} s",
              flush=True)
    rows = {}
    out = pool.run(st_rank, mesh, [(None, "bfloat16", ST_STEPS, r == 0)
                                   for r in range(mesh.size)])
    r0 = out[0]
    if r0["loss_err"] > ST_LOSS_BF16 or \
            r0["logits_err"] > ST_LOGITS_BF16 * r0["logits_scale"]:
        fail(f"phase 23 bf16: tp 2 vs tp 1 loss {r0['loss_err']}, logits "
             f"{r0['logits_err']} of {r0['logits_scale']}")
    for r, o in enumerate(out):
        if not o["losses"][-1] < o["losses"][0]:
            fail(f"phase 23 rank {r}: the loss did not fall {o['losses']}")
        for k in ("rmsnorm_matmul", "residual_rmsnorm", "flash_attention"):
            if o["train_launches"][k] <= 0:
                fail(f"phase 23 rank {r}: {k} not launched by the train "
                     "step")
        for k in ("rmsnorm_matmul", "residual_rmsnorm", "flash_attention",
                  "decode_attention"):
            if o["serve_launches"][k] <= 0:
                fail(f"phase 23 rank {r}: {k} not launched by the serve "
                     "steps")
        ms = [c[0] for c in o["train_calls"]]
        ex = [c[1] for c in o["train_calls"]]
        print(f"phase 23: {ST_ARCH} bf16 whole, mesh (data 1, model 2), "
              f"rank {r}: losses {[round(x, 4) for x in o['losses']]}; "
              f"train step ms {[round(x, 1) for x in ms]}, of which gloo "
              f"exchange {[round(x, 1) for x in ex]} (compute "
              f"{[round(a - b, 1) for a, b in zip(ms, ex)]}); prefill / "
              f"decode ms {[round(c[0], 1) for c in o['serve_calls']]}, "
              f"exchange {[round(c[1], 1) for c in o['serve_calls']]}; "
              f"peak {o['peak_gb']:.2f} GB ({MR_SHARE})")
    print(f"phase 23: bf16 tp 2 vs tp 1 on rank 0: loss differs by "
          f"{r0['loss_err']:.2e} (<= {ST_LOSS_BF16}), last-position logits "
          f"by {r0['logits_err']:.3e} of {r0['logits_scale']:.3f} (<= "
          f"{ST_LOGITS_BF16} of it), parameters after {ST_STEPS} steps by "
          f"{r0['param_err']:.3e}, gradient norms {r0['gnorms']} against "
          f"{r0['ref_gnorms']} (largest relative difference "
          f"{r0['gnorm_err']:.2e}), AdamW's first moment "
          f"{r0['moment_err']:.2e} of a leaf's largest")
    stamp("bf16 ranks done")
    rows["bf16"] = {"losses": [o["losses"] for o in out],
                    "train_ms": [[c[0] for c in o["train_calls"]]
                                 for o in out],
                    "exchange_ms": [[c[1] for c in o["train_calls"]]
                                    for o in out],
                    "serve_ms": [[c[0] for c in o["serve_calls"]]
                                 for o in out],
                    "loss_err": r0["loss_err"],
                    "logits_err": r0["logits_err"],
                    "launches": {"train": out[0]["train_launches"],
                                 "serve": out[0]["serve_launches"]}}
    dry = st_dry(st_config(None, "bfloat16"), mesh)
    st_check(out, dry, "bf16 whole")
    rows["bf16"]["dry"] = dry
    rows["bf16"].update(gnorm_err=r0["gnorm_err"],
                        moment_err=r0["moment_err"])
    stamp("dry run of the bundles done")
    f32 = pool.run(st_rank, mesh, [(ST_F32_LAYERS, "float32", 1, True)
                                   for _ in range(mesh.size)])
    for r, o in enumerate(f32):
        errs = (o["loss_err"], o["logits_err"], o["param_err"])
        print(f"phase 23: f32 {ST_F32_LAYERS} layers rank {r}: tp 2 vs tp 1 "
              f"loss {errs[0]:.2e}, logits {errs[1]:.2e}, parameters after "
              f"one step {errs[2]:.2e} (<= {ST_F32}); gradient norm "
              f"{o['gnorms'][0]!r} against {o['ref_gnorms'][0]!r}, "
              f"{o['gnorm_err']:.2e} of it (<= {ST_GNORM}); AdamW's first "
              f"moment {o['moment_err']:.2e} of a leaf's largest (<= "
              f"{ST_MOMENT})")
        if max(errs) > ST_F32 or o["gnorm_err"] > ST_GNORM or \
                o["moment_err"] > ST_MOMENT:
            fail(f"phase 23 f32 rank {r}: {errs}, gradient norm "
                 f"{o['gnorm_err']}, first moment {o['moment_err']}")
    rows["f32"] = [{k: o[k] for k in ("loss_err", "logits_err", "param_err",
                                      "gnorm_err", "moment_err")}
                   for o in f32]
    stamp("f32 ranks done")
    counts = {"steps_train": out[0]["train_launches"],
              "steps_serve": out[0]["serve_launches"]}
    return rows, counts


def st_production_cells(tmp: str) -> list:
    """(c): the named production-mesh cells of the dry run."""
    recs = []
    for arch, shape in DRY_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=tmp)
        recs.append({k: rec[k] for k in ("arch", "shape", "mesh", "memory",
                                          "fits", "t_lower_s")}
                    | {"roofline": {k: rec["roofline"][k] for k in (
                        "t_compute", "t_memory", "t_collective", "dominant",
                        "roofline_frac")}})
    return recs


def wkv_bwd_check() -> dict:
    """(d): the wkv6 backward at B 8 x T 512 x 40 x 64 against autograd
    through the plain chunked version, and its device time beside a
    bound."""
    b, t, h, hd = WKV_BWD
    g = torch.Generator(device=DEV).manual_seed(5)
    r, k, v = (torch.randn(b, t, h, hd, generator=g, device=DEV) * 0.5
               for _ in range(3))
    logw = -torch.exp(torch.randn(b, t, h, hd, generator=g, device=DEV))
    u = torch.randn(h, hd, generator=g, device=DEV) * 0.5
    s0 = torch.randn(b, h, hd, hd, generator=g, device=DEV) * 0.1
    do = torch.randn(b, t, h, hd, generator=g, device=DEV)
    ds = torch.randn(b, h, hd, hd, generator=g, device=DEV)
    ins = [a.clone().requires_grad_() for a in (r, k, v, logw, u, s0)]
    o, s = wkv6_ref(*ins)
    want = torch.autograd.grad([o, s], ins, [do, ds], retain_graph=True)
    got = wkv6_bwd(r, k, v, logw, u, s0, do, ds)
    errs = [float((a - w).abs().max() / w.abs().max().clamp(min=1.0))
            for a, w in zip(got, want)]
    ms, _ = time_ms(lambda: wkv6_bwd(r, k, v, logw, u, s0, do, ds), 5)
    plain_ms, _ = time_ms(lambda: torch.autograd.grad(
        [o, s], ins, [do, ds], retain_graph=True), 5)
    nbytes = 4.0 * (9 * b * t * h * hd + 3 * b * h * hd * hd + 2 * h * hd)
    c = 16                              # the backward's chunk
    flops = b * t * h * (20.0 * c * hd + 8.0 * hd * hd)
    bound, by = bound_ms(nbytes, flops, torch.float32)
    if max(errs) > 1e-4:
        fail(f"phase 23 wkv6 backward: errors {errs} above 1e-4")
    print(f"phase 23: wkv6 backward B{b} T{t} H{h} hd{hd} f32: largest "
          f"relative error against autograd through the plain version "
          f"{max(errs):.2e} (dr, dk, dv, dlogw, du, ds0: "
          f"{[f'{e:.1e}' for e in errs]}); device {ms * 1e3:.1f} us, "
          f"autograd through the plain version {plain_ms * 1e3:.1f} us, "
          f"bound {bound * 1e3:.1f} us by {by}")
    return {"errs": errs, "us": ms * 1e3, "plain_us": plain_ms * 1e3,
            "bound_us": bound * 1e3, "bound_by": by}


def rwkv_train() -> tuple:
    """(d): whole-width RWKV-6 3B cut to RWKV_TRAIN_LAYERS layers, bf16,
    RWKV_TRAIN_STEPS steps of loss_fn + AdamW on phase 21's n-gram
    batches: the loss must fall.  Returns (row, launch counts a step)."""
    cfg = get_config(RWKV_ARCH).replace(n_layers=RWKV_TRAIN_LAYERS)
    params = model_params(cfg, 31)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=2,
                   total_steps=RWKV_TRAIN_STEPS)
    state = opt_init(oc, params)
    data = DataConfig(batch=4, seq_len=TRAIN_SEQ,
                      vocab_size=TRAIN_DATA_VOCAB)
    losses, ms = [], []
    kernels.reset_launch_counts()
    for i in range(RWKV_TRAIN_STEPS):
        batch = to_device(make_batch(data, i, cfg), DEV)
        t0 = st_sync(DEV)
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = loss_fn(ps, batch, cfg, remat=False)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        it = iter(grads)
        opt_update(oc, tree_map(lambda _: next(it), params), state, params)
        ms.append((st_sync(DEV) - t0) * 1e3)
        losses.append(float(loss.detach()))
    counts = {k: n // RWKV_TRAIN_STEPS
              for k, n in kernels.launch_counts().items()}
    if not losses[-1] < losses[0]:
        fail(f"phase 23 rwkv training: the loss did not fall {losses}")
    if counts["wkv6"] != RWKV_TRAIN_LAYERS or counts["rmsnorm"] <= 0:
        fail(f"phase 23 rwkv training: launches a step {counts}")
    print(f"phase 23: {RWKV_ARCH} bf16 whole width, {RWKV_TRAIN_LAYERS} of "
          f"32 layers, 4 x {TRAIN_SEQ} tokens a step: losses "
          f"{[round(x, 3) for x in losses]}; ms a step "
          f"{[round(x, 1) for x in ms]}; launches a step wkv6 "
          f"{counts['wkv6']}, rmsnorm {counts['rmsnorm']}")
    del params, state
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms}, counts


def phase_steps(pool=None) -> tuple:
    """Phase 23: the step builders on two ranks sharing the card, the dry
    run beside them and over named production-mesh cells, and RWKV-6
    training.  Returns (rows, {path: launch counts})."""
    t0 = time.perf_counter()
    mesh = make_host_mesh(data=1, model=2, device=DEV)
    with rank_pool(pool) as pool:
        rows, counts = st_ranks(pool, mesh, t0)
    print(f"phase 23: (a)-(b) {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rows["cells"] = st_production_cells(tmp)
    print(f"phase 23: (c) {time.perf_counter() - t0:.1f} s", flush=True)
    rows["wkv6_backward"] = wkv_bwd_check()
    rows["rwkv_train"], counts["rwkv_train"] = rwkv_train()
    secs = time.perf_counter() - t0
    print(f"phase 23: {secs:.1f} s")
    print("phase 23: " + json.dumps({"rows": rows, "seconds": secs}))
    return rows, counts


# ------------------------------------------------------------------ main
# which main path (its jit run, phase 11; the multi-query entries: their
# phase-16 speculative run) each kernel's ``launches`` is read from
MAIN_PATH = {"decode_attention": "contiguous",
             "flash_attention": "contiguous",
             "residual_rmsnorm": "contiguous",
             "rmsnorm_matmul": "contiguous",
             "paged_decode_attention": "paged_bf16",
             "paged_decode_attention_quant": "paged_int8_pressure",
             "rmsnorm": "rwkv",
             "wkv6": "rwkv",
             "decode_attention_mq": "spec_contiguous",
             "paged_decode_attention_mq": "spec_paged_bf16",
             "paged_decode_attention_quant_mq": "spec_paged_int8_pressure"}


def main() -> None:
    t0 = time.perf_counter()

    def mark(phases: str) -> None:
        print(f"chip_smoke: phases {phases} done at "
              f"{time.perf_counter() - t0:.1f} s")
    cfg, rcfg = get_config(ARCH), get_config(RWKV_ARCH)
    phase_build()
    rows = phase_kernels(cfg, rcfg)
    mark("1-2")
    phase_dispatch_cost(cfg)
    phase_logits_f32(cfg)
    mark("1-3")
    # the newest phases right after the kernels' checks, so that a fault
    # there ends the run early
    _, train_counts = phase_train()
    mark("1-3, 21")
    with rank_pool() as pool:
        _, multirank_counts = phase_multirank(pool)
        mark("1-3, 21-22")
        _, steps_counts = phase_steps(pool)
    mark("1-3, 21-23")
    _, tp_counts = phase_tp()
    mark("1-3, 20-22")
    _, moe_counts = phase_moe()
    mark("1-3, 18, 20-22")
    _, xattn_counts = phase_xattn()
    mark("1-3, 18-22")
    eager_counts, eager = {}, {}
    eager_counts["contiguous"], rep, eng, done = phase_serve(cfg, 4)
    eager["contiguous"] = (rep, done, phase_trace(eng, "phase 5",
                                                  prefill=True))
    del eng
    torch.cuda.empty_cache()
    eager_counts["paged_bf16"], rep, eng, done = phase_serve(cfg, 6, PAGED)
    eager["paged_bf16"] = (rep, done, phase_trace(eng, "phase 6 trace"))
    eager_counts["paged_int8_pressure"], rep, eng, done = phase_pool_pressure(
        cfg, eng.params)
    eager["paged_int8_pressure"] = (rep, done,
                                    phase_trace(eng, "phase 7 trace"))
    del eng
    torch.cuda.empty_cache()
    mark("1-7")
    phase_logits_rwkv(rcfg)
    eager_counts["rwkv"], rep, eng, done = phase_serve(rcfg, 9)
    check_rwkv_streams(rcfg)
    eager["rwkv"] = (rep, done, phase_trace(eng, "phase 10", prefill=True))
    del eng
    torch.cuda.empty_cache()
    mark("1-10")
    jit_rows, jit_done, path_counts = phase_jit(cfg, rcfg, eager)
    mark("1-11")
    _, plan_counts = phase_plans(cfg, rcfg, eager, jit_done)
    llama_rows, llama_counts, llama_done = phase_llama()
    _, other_counts = phase_others()
    _, char_counts = phase_characterize()
    _, spec_counts = phase_speculative(jit_rows, jit_done, llama_rows,
                                       llama_done)
    _, tier_counts = phase_serving_tier()
    print(f"chip_smoke: phases 1-23 in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = dict(rows[name])
        for key, sub in rows.items():          # e.g. "rmsnorm_matmul[prefill]"
            if key.startswith(name + "["):
                row[key[len(name) + 1:-1]] = sub
        launches = {**path_counts, **spec_counts}[MAIN_PATH[name]][name]
        if launches <= 0:
            fail(f"{name} was not launched on its main path "
                 f"({MAIN_PATH[name]})")
        by_path = {f"{p}:jit": c[name] for p, c in path_counts.items()}
        by_path.update({f"{p}:eager": c[name]
                        for p, c in eager_counts.items()})
        by_path.update({p: c[name] for p, c in plan_counts.items()})
        by_path.update({p: c[name] for p, c in llama_counts.items()})
        by_path.update({p: c[name] for p, c in other_counts.items()})
        by_path.update({p: c[name] for p, c in char_counts.items()})
        by_path.update({p: c[name] for p, c in spec_counts.items()})
        by_path.update({p: c[name] for p, c in tier_counts.items()})
        by_path.update({p: c[name] for p, c in moe_counts.items()})
        by_path.update({p: c[name] for p, c in xattn_counts.items()})
        by_path.update({p: c[name] for p, c in tp_counts.items()})
        if name in TRAIN_KERNELS:      # the training step's: launches a step
            by_path.update({p: c[name] // TRAIN_STEPS
                            for p, c in train_counts.items()})
            # a data-parallel rank's step (phase 22 (a))
            by_path.update({p: c[name] for p, c in multirank_counts.items()})
        # phase 23: a rank's train steps and serve calls (tp 2), RWKV-6
        # training's launches a step
        by_path.update({p: c[name] for p, c in steps_counts.items()})
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "launches_by_path": by_path, **row})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
