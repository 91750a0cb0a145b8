"""Drive the PyTorch port's serving path and training step, exact and
over the quantized wire, the paper's simulator with its auction solver,
LM training with its flash-attention kernel, the pipelined training
step with its prefetch plane, the LM serving path (prefill and
KV-cache decode) and MoE layers, and elastic training under a fault
plan with its checkpoints and resume, training over several parameter
servers and on the dense cache engine, the SSM and hybrid LMs with
their linear-scan kernels, the VLM prefix and the audio
encoder-decoder, traced training runs with the observability
benchmark, and training under remat with the MoE's block dispatch and
the dry run of the spec layer, on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and ``nvidia-smi``'s name and power limit;
2. build — compiles the CUDA sources in ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all at once, and prints each kernel's
   registers and spills; counts the tensor-core instructions in the SASS
   of B8's libraries (``cuobjdump -sass``): ``HGMMA`` in the bf16
   forward's ``flash_attn_sm90`` and backward's ``flash_attn_bwd_sm90``
   and in the f32 (split TF32) forward's ``flash_attn_tf32`` and
   backward's ``flash_attn_bwd_tf32``, and fails on none; with ``--was
   DIR`` also builds the f32 forward and backward libraries of the
   checkout in DIR (the parent commit, unpacked with ``git archive``:
   the CUDA-core kernels) for phase 3's "was" times;
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its median time, the plain version's, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over 67 TFLOP/s f32; B8's f32 route over 495 TFLOP/s TF32 / 3, three
   TF32 products a product, beside 67), beside the launch floor (an empty kernel's
   device and call ms).  Serving (wdl-s1: V = 502,000, E = 512): the
   hot-set plane of C rows: the in-place TTL refresh ``plane_refresh``
   at phase 5's budget of 64 on a cold plane's ties, without a budget
   at ~1/4 due (its list then pulled by ``staged_pull``) and
   select-only, bit for bit (rows, expiry, count, list), beside the
   out-of-place ``staged_gather`` at ~1/4 due; the training prefetch
   plane's pull (64 of 512 slots) by ``staged_pull`` and by
   ``staged_gather``; bags of the stream's 48 history slots, B =
   16 and 4,096, bit for bit (and with an all-PAD bag, weights, and at
   E = 510).  Training: the decide stage's per-id cost table (U, 4)
   pooled over one S1 batch of 256 x 74 (and the pooled lookup again at
   E = 512 on the wdl-s1 table; on the dense (502,000, 4) per-id table of
   phase 16's one-call dispatch; on the per-shard table of phase 15's
   decide, 2 shards behind the ``--ps-hetero`` links; the dense table,
   and the per-shard one at equal links, bit for bit the compact
   route); ``alg1_cost``, every worker's Alg. 1 in one launch, at 4 x
   256 x 74 and at the benchmark cells' 8 x 128 x 26 (planes after 60
   protocol steps), bit for bit its plain version and the per-worker
   route, timed (device, call and host issue) beside that route's whole
   call; the row pack alone on 256
   slots of ids (74 int32), dense features (13 f32) and labels (1 f32), and the
   exchange's one-launch pack of all three for 4 workers of 256, bit for
   bit against its per-worker plain version (balanced, with overflow,
   with an empty destination, on a relaxed budget), timed beside the 12
   row packs it replaces and beside those with their slot maps.  The
   quantized wire: the pack-quantize alone on 256 slots of dense features
   (fp16, int8, int4, int8:4; and int8 at 512 columns); the exchange's
   one launch with the dense features quantized
   (``pack_send_all_quant``: fp16, int8, int4, int8:4 at the training
   shapes, balanced and with overflow, and int8 at 512 columns), bit for
   bit against its per-worker plain version, timed beside the path it
   replaced (the exact pack, 4 pack-quantizes and their stack); and the
   pooled lookup over the int8-quantized wdl-s1 table (256 x 74, E = 512
   and E = 4; both of its layouts).
   The auction's bids at Table 2's and the simulator's shapes (k = 256
   and 8,192 rows of 8 workers, 1,024 of 16, 64 of 1; a random
   unassigned mask), bit for bit; and the fused whole-solve auction at
   the benchmark cells' decide (8 auctions of 128 x 8), the training
   step's decide (4 auctions of 256 x 4), the simulator's S1 decisions
   (an exact grid, and a price war cut at 6,000 rounds) and Table 2's
   largest, on each route that takes the shape (the warp kernel and the
   block kernel), bit for bit in assignment, slot prices and owners and
   rounds, with its ms a solve and us a round on each, a check that
   ``solve_route`` picks the faster, and the cells' rows bidding a
   round.  The flash
   attention at the LM path's
   shape (smollm-360m: B = 4, S = 2,048, 5 KV heads x 3, hd = 64,
   causal; the prefill's too) and around it (non-causal, hd 128, hd
   32; phi3.5-moe's and pixtral-12b's training shape, B = 1, 8 KV heads
   x 4, hd 128, and pixtral's prefill, B = 4), each in bf16 and in f32:
   bf16 on the
   ``wgmma`` kernel (max abs err 1e-2, or up to 2e-2 where it is within
   1.5x ``scaled_dot_product_attention``'s error against the same plain
   version: both round P to bf16; lse 2e-5), and f32 on the split-TF32
   ``wgmma`` kernel of ``flash_attn_tf32.cu`` (out and lse 2e-5); its
   backward against the plain backward (evaluated in f32) at the first
   four of those shapes in both dtypes: bf16 on the ``wgmma`` kernel of
   ``flash_attn_bwd_sm90.cu`` (each gradient within 1.5x the error of
   SDPA's backward against it), f32 on ``flash_attn_bwd_tf32.cu``
   (1e-4), two calls bitwise equal, its route printed, timed beside the
   plain backward, SDPA's backward and, for f32 with ``--was DIR``,
   DIR's CUDA-core kernels on the same inputs (forward and backward,
   timed between two runs of the new kernel); and the gradients of its
   autograd Function against autograd of its plain version (1e-4); SDPA
   timed as the library yardstick, in the inputs' dtype, the bound at
   989 TFLOP/s bf16 (495 / 3 and 67 f32) and each kernel's TFLOP/s.  The linear
   recurrence's kernels (``linear_scan`` and ``linear_scan_bwd``) at
   falcon-mamba-7b's state (B 1, S 2,048, C 8,192 x 16), recurrentgemma-
   2b's (C 2,560) and a ragged shape, against their plain version within
   2e-6 of the largest output, beside the byte bound (no PyTorch call
   computes a linear recurrence), and the autograd Function's gradients
   against autograd of the plain version;
4. parity — the serve step and a TTL refresh (exact and int8), and 3
   steps of the training stages, exact and with ``--codec int8``, on the
   card against the same calls on the CPU at wdl-tiny; the simulator
   with ``opt="auction"`` (tiny workload, 4 workers on distinct links, 4
   iterations) and the serving simulator (S1, 8 workers, 0.5 s) on the
   card against the CPU; 3 steps of ``run_lm`` at smollm-360m's smoke
   config with S = 2,048 (the flash route) on the card against the CPU,
   losses within 1e-4, and again in bf16 (the card's wgmma forward and
   backward against the CPU's plain versions), losses within 5e-2; every
   f32 B8 launch of the phase, forward and backward, on the ``tf32x3``
   route (each run's counts printed, and the phase's total);
   ``run_dlrm`` pipelined at wdl-tiny (depth 2; depth 2 with stale
   decisions; depth 3 with decide-ahead 2, lookahead 2 and 16 rows a
   step prefetched into 64 slots), the card's chain on a stream of its
   own, against the CPU: integer fields equal, losses and Alg.-1 costs
   within 1e-5, the final prefetch plane's ids, expiry and rows equal; 8
   decode steps of smollm-360m's and phi3.5-moe's smoke configs (f32, B
   4), logits within 1e-5, and 3 ``run_lm`` steps of phi3.5-moe's smoke
   config at S = 2,048, with one dispatch block and with ``MOE_BLOCKS =
   2``, losses within 1e-4; ``run_dlrm --fault-plan`` at wdl-tiny (a
   straggler, a graceful crash, a droop and a warm rejoin; 6 steps;
   depth 1 exact and int8, depth 2) card against CPU: integer fields
   equal, losses and costs within 1e-5; ``run_dlrm --n-ps 3 --ps-layout
   hashed --ps-hetero`` and ``--esd-engine dense`` at depth 2, card
   against CPU alike; 3 ``run_lm`` steps at S 2,048 and 8 decode steps
   of falcon-mamba's and recurrentgemma's smoke configs (f32), losses
   within 1e-4, logits within 1e-5, the scan kernels once a recurrent
   layer and step; the loss and 3 ``make_train_step`` steps of
   pixtral-12b's smoke config (16 patches + 2,032 tokens: B8's route)
   and whisper-large-v3's (64 frames, 64 tokens) on
   ``make_train_batch``'s draws, and 8 decode steps of each (f32), card
   against CPU, losses within 1e-4, logits within 1e-5;
5. serve — ``run_serve`` at wdl-s1 (4 workers, 2,000 QPS for 1 s), then
   for 0.5 s with ``--codec int8``: one ``plane_refresh`` launch a
   worker refresh (and one each for the warm-up and the 4 seeds), no
   ``staged_gather``; ``staged_pull`` only for the seeds' lists (with
   the codec once a refresh, writing the quantized rows);
6. train — ``run_dlrm`` at wdl-s1 (4 workers x 256 samples, ESD alpha 1,
   ragged exchange, 10 steps), then again with ``--codec int8``: one
   ``alg1_cost`` launch a step prices every worker's Alg. 1 (no B1
   launch), one launch of the fused auction kernel a step, its rounds
   per step equal to the CPU's; one launch of the exchange's pack a
   step (with the codec its quantized kernel), the row pack and the
   pack-quantize alone never;
7. table 2 — ``auction_dispatch(exact=False)`` on the draws of
   ``benchmarks/table2.py`` (8 workers, 32 to 1,024 samples a worker):
   rounds, ms per decision and one auction_solve launch each, beside the
   paper's CUDA-Hungarian ms; assignments and rounds equal to the CPU's;
8. simulate — ``simulate`` at S1 (8 workers, 4 x 5 and 4 x 0.5 Gbps,
   r = 0.08, E = 512, 32 samples a worker, 8 iterations, 2 of warm-up;
   the paper's 60 iterations and 128 a worker cut): ESD alpha 1 with the
   auction (calibrated decisions: rounds, cost, ItpS and hit ratio equal
   to the CPU's) and with SSP, LAIA, HET, FAE and random; then the
   serving simulator with the auction; then (run after phase 12) the
   same S1 under ``SIM_PLAN`` (a graceful crash and warm rejoin of
   worker 3, a straggler, a droop): ESD with SSP, LAIA, random and HET
   card against CPU, every field equal; FAE refused alike (its cache
   models no churn) and run on the plan's window events; ESD with the
   auction, one auction_solve launch a decision, every field equal to
   the CPU's (``S1_FAULTS_AUCTION_CPU``); and a multi-PS run (2 shards)
   with a PS outage, card against CPU;
9. lm-train — ``run_lm`` at smollm-360m's full width and depth (32
   layers, d = 960, vocab 49,152, bf16), B = 4, S = 2,048, 5 steps of
   Adam: ms per step (mean of steps 1-4, each ended by a synchronise),
   tokens/s, losses, peak memory, and 32 launches a step of the flash
   kernel and 32 of its backward kernel; then in f32 at full width with
   ``LM_F32_LAYERS`` layers, 3 steps: ms a step, tokens/s, losses, peak
   memory, B8 and its backward once a layer and step on the ``tf32x3``
   route;
10. train-pipeline — ``run_dlrm`` at phase 6's configuration with
   ``--pipeline-depth 2``, exact and with ``--codec int8``: every record
   (loss, counts, cost, Alg.-1 estimate) bit for bit phase 6's, the
   auction's rounds and the launches a step depth 1's, the wall ms a
   step beside depth 1's; with ``--stale-decide`` (step 0's
   ``alg1_realized`` equal to its ``alg1_est`` within 1e-6; two
   alg1_cost launches a step, decide's and the re-score's, no B1); and
   the README's configuration (depth 4, lookahead 4, decide-ahead 3, 64
   rows a step prefetched into 512 slots): one staged_pull launch a step
   and no staged_gather, three alg1_cost a step (decide, repair,
   re-score) and no B1, rows prefetched after step 0, demand misses
   within the misses;
11. lm-serve — smollm-360m at full width and depth (bf16, tied head): a
   prefill of B = 4 x S = 2,048 through ``make_prefill_step`` (32 B8
   launches, 4 times: ms and peak memory), then
   ``examples/serve_llm_decode_torch.py``'s ``run`` at B = 4, the
   prefill batch's first 256 tokens teacher-forced and 256 greedy tokens
   into 512 slots (ms a step p50 and p99, tok/s); then in f32 the same
   prefill, 3 times (ms; B8 once a layer each, all on the ``tf32x3``
   route, and its share at phase 3's LM-shape time), and the prompt,
   the decode logits at positions 0..255 within 1e-3 of the prefill's;
12. lm-moe — phi3.5-moe at full width (d 4,096, 16 experts top-2, bf16),
   its depth cut to 2 layers: 3 ``run_lm`` steps at B = 1, S = 2,048
   (ms a step, peak memory, finite losses, one B8 and one backward
   launch a layer and step), then decode at B = 4, prompt 64, 64 greedy
   tokens, and a nonzero router aux loss;
13. train-elastic — ``run_dlrm`` at phase 6's configuration for 12 steps
   under ``ELASTIC_PLAN`` (at most one worker down: capacity 86, budget
   128, ``out_rows`` 512 a worker) at depth 1, depth 2 and with
   ``--codec int8``: finite records, ``n_active`` 3 at steps 3-6, no
   sample for worker 1 while it is down, depth 2's records bit for bit
   depth 1's, one alg1_cost (no B1), one auction_solve and one
   ``pack_send_all`` (``_quant`` with the codec) a step, and ms a step
   beside phase 6's; then an empty plan, its records bit for bit phase
   6's;
14. resume — phase 13's configuration at depth 2, 10 steps with a
   checkpoint at step 5, resumed from it: records from step 5 bit for
   bit; smollm-360m at full width, depth cut to 4 of 32 layers, B 4 x S
   2,048, 4 steps with a checkpoint at step 2, resumed into other
   weights: losses bit for bit, B8 and its backward once a layer and
   step; each checkpoint's bytes and save and restore ms;
15. train-ps — ``run_dlrm`` at phase 6's configuration over 2 parameter
   servers behind the ``--ps-hetero`` links (the tables PS-stacked, ids
   and cache planes PS-linearized, Alg. 1 priced per shard through B1):
   contiguous and hashed at depth 1 and 2 (depth 2 bit for bit depth
   1), hashed with ``--codec int8``, and contiguous under
   ``PS_PLAN`` (a PS outage: Alg. 1's estimate rises in its window
   only); 4 B1 launches, one auction_solve and one pack_send_all
   (``_quant`` with the codec) a step, ms a step beside phase 6's;
16. train-dense — ``run_dlrm --esd-engine dense`` at phase 6's
   configuration at depth 1 and 2, every record bit for bit phase 6's
   (the sparse engine), and with the README's prefetch configuration
   (one staged_pull a step); then ``esd_dispatch`` with the dense
   cost (B1 over the (502,000, 4) per-id table) on the run's final
   state: 4 B1 launches, one auction_solve and one pack_send_all, the
   compact cost's assignment and exchange; the compact cost one
   ``alg1_cost`` launch, its matrix and assignment the per-worker
   route's;
17. lm-ssm — falcon-mamba-7b at full width (d 4,096, d_inner 8,192, N
   16, vocab 65,024, bf16), its 64 layers cut to ``MAMBA_LAYERS``: 3
   ``run_lm`` steps at B 1, S 2,048 (ms a step, tokens/s, peak memory;
   the scan's forward and backward once a layer and step, B8 never),
   then f32 decode against an f32 prefill of B 4 x S 256 within
   ``SSM_F32_TOL``; recurrentgemma-2b at full width and depth (26
   layers: 18 RG-LRU, 8 local at hd 256, window 2,048, vocab 256,000,
   bf16): 3 ``run_lm`` steps at B 1, S 2,048 (the scan once an RG-LRU
   layer and step each way, the local layers on the blockwise route, B8
   never), prefills of B 1 x S 4,096 (the window cuts), and decode at B
   4, prompt 64 + 64 greedy;
18. lm-vlm-audio — pixtral-12b at full width (d 5,120, 32 heads over 8,
   hd 128, vocab 131,072, bf16): 3 ``make_train_step`` steps at
   ``PIXTRAL_TRAIN_LAYERS`` of its 40 layers, B 1, 256 patches + 1,792
   tokens (B8 and its backward once a layer and step; ms a step,
   tokens/s, peak memory), then at full depth 4 prefills of B 4 x
   (256 + 1,792) (B8 once a layer) and decode of text tokens at B 4,
   prompt 64 + 64 greedy; whisper-large-v3 at full width and depth (32
   + 32 layers, d 1,280, 20 heads, vocab 51,866, bf16): 3 steps at B 1,
   1,500 frames, 448 tokens, 3 prefills at B 4, decode at B 4 over the
   1,500 encoded frames (cross K/V filled by ``encode``), 64 steps, no
   kernel (the encoder is bidirectional: the naive route); then in f32
   at the smoke configs whisper's decode over filled cross K/V against
   ``decode_train`` and pixtral's prefill with a prefix, card against
   CPU, within ``VLM_AUDIO_F32_TOL``;
19. trace — ``repro_torch.launch.train.main`` at phase 6's configuration
   with ``--trace-out`` and ``--validate-timing``, at depth 1 and 2:
   every record bit for bit the untraced run's (phases 6 and 10), the
   launches a step theirs; the exported trace parses, with the tracks
   ``decide`` and ``train/0`` (``train/1`` at depth 2); at depth 2 every
   ``decide``, ``advance`` and ``train.sync`` span carries a positive
   ``device_ms``, its step's stage time between CUDA events, and at
   depth 1 none does; the depth-2 ``hidden_frac`` exceeds depth 1's, 0;
   the report, and traced and untraced wall ms a step.  Then
   ``benchmarks/obs_bench_torch.py``'s ``run(quick=True)`` on the card,
   its artifact written through ``write_bench``, which gates its three
   claims (the tracer's overhead at most 3 % among them).  Then ``main``
   for smollm-360m at full width, its depth cut to 4 layers, B 4 x S
   2,048, 3 steps with ``--trace-out``: one ``train.sync`` span a step,
   B8 and its backward once a layer and step;
20. remat — ``launch.steps.make_train_step(remat=True)`` against
   ``remat=False`` from the same weights (Adam, lr 1e-2, 3 steps):
   smollm-360m at full width and depth, B 4 x S 2,048 (losses bit for
   bit; B8 forward twice a layer and step under remat, its backward
   once; both peaks and ms a step), falcon-mamba-7b at full width with
   ``MAMBA_LAYERS`` layers (losses bit for bit, the remat peak lower),
   then at the deepest of ``REMAT_MAMBA_DEPTHS`` that trains with remat
   (the scan twice a layer and step forward, once backward), which the
   same run shows out of memory without remat; phi3.5-moe at full width,
   2 layers, B 1 x S 2,048, ``MOE_BLOCKS = 4`` with remat (finite losses
   and router aux); then ``launch.dryrun.run_dryrun`` on ``meta`` for
   smollm-360m and falcon-mamba-7b x ``train_4k`` and llama4-scout x
   ``decode_32k``: the reference's record keys and state bytes, the
   extrapolated FLOPs.

Each run of phases 5 to 20 sets every kernel's launch counter to 0 just
before and reads the counters just after; every bf16 LM run (phases 9,
12, 14, 18, 19, 20) also checks that each of its backward launches took
the ``wgmma`` route (``flash_attn.BWD_ROUTE_LAUNCHES``), and every f32
one (phases 4, 9 and 11) that its forward and backward launches took the
``tf32x3`` route (``ROUTE_LAUNCHES``, ``BWD_ROUTE_LAUNCHES``); the
kernel line counts B8's f32 kernels apart (``flash_attention_f32``,
``flash_attention_bwd_f32``).  B1's per-shard and dense
inputs get a line each (time, plain and ``embedding_bag`` times, bound,
launches).  Then one JSON line of kernel
records, after the script's wall time, and as the last line ``{"ok":
true, "device": {...}}``.  Any failed check raises, so the script exits
non-zero; it also fails without a CUDA device and when the package is
not beside it.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
# f32-accurate work on the tensor cores: three TF32 products of the split
# operands for each f32 one (B8's tf32x3 route), counted in f32 work
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"pooled_lookup": CSRC + "emb_lookup.cu",
           "alg1_cost": CSRC + "emb_lookup.cu",
           "pack_send_all": CSRC + "exchange_pack.cu",
           "gather_rows": CSRC + "exchange_pack.cu",
           "staged_gather": CSRC + "emb_lookup.cu",
           "plane_refresh": CSRC + "emb_lookup.cu",
           "staged_pull": CSRC + "emb_lookup.cu",
           "pooled_lookup_staged": CSRC + "emb_lookup.cu",
           "gather_rows_quant": CSRC + "exchange_pack.cu",
           "pack_send_all_quant": CSRC + "exchange_pack.cu",
           "pooled_lookup_quant": CSRC + "emb_lookup.cu",
           "auction_bids": CSRC + "auction.cu",
           "auction_solve": CSRC + "auction.cu",
           "flash_attention": CSRC + "flash_attn_sm90.cu",
           "flash_attention_bwd": CSRC + "flash_attn_bwd_sm90.cu",
           "flash_attention_f32": CSRC + "flash_attn_tf32.cu",
           "flash_attention_bwd_f32": CSRC + "flash_attn_bwd_tf32.cu",
           "linear_scan": CSRC + "linear_scan.cu",
           "linear_scan_bwd": CSRC + "linear_scan.cu"}
REPLACES = {"pooled_lookup": "src/repro/kernels/emb_lookup.py:88",
            "alg1_cost": "none: it fuses the per-id pricing of src/repro/"
                         "kernels/ops.py:44 (cost_matrix_pallas_sparse) "
                         "into B1's pooling, all workers in one launch",
            "pack_send_all": "src/repro/kernels/exchange_pack.py:34 with "
                             "the slot map around it: "
                             "src/repro/exchange/ragged.py:36 (pack_send)",
            "gather_rows": "src/repro/kernels/exchange_pack.py:34",
            "staged_gather": "src/repro/kernels/emb_lookup.py:174",
            "plane_refresh": "src/repro/kernels/emb_lookup.py:174 with the "
                             "selection around it: src/repro/serve/"
                             "plane.py:82 (refresh_plane), :58 (_pull_rows)",
            "staged_pull": "src/repro/kernels/emb_lookup.py:174 on the "
                           "prefetch pull: src/repro/pipeline/prefetch.py:"
                           "112 (prefetch_step)",
            "pooled_lookup_staged": "src/repro/kernels/emb_lookup.py:245",
            "gather_rows_quant": "src/repro/kernels/exchange_pack.py:108",
            "pack_send_all_quant": "src/repro/kernels/exchange_pack.py:108 "
                                   "and :34 with the slot map around them: "
                                   "src/repro/exchange/ragged.py:123 "
                                   "(ragged_exchange_quant), :36 "
                                   "(pack_send)",
            "pooled_lookup_quant": "src/repro/kernels/emb_lookup.py:337",
            "auction_bids": "src/repro/kernels/auction.py:51",
            "auction_solve": "src/repro/kernels/auction.py:51 with the "
                             "loops around it: src/repro/core/auction.py:34 "
                             "(_round_body), :95 (_auction_phase); "
                             "src/repro/kernels/ops.py:70 (_resolve), :100 "
                             "(_phase); src/repro/core/dispatch_tpu.py:158 "
                             "(auction_fixed)",
            "flash_attention": "src/repro/kernels/flash_attn.py:66",
            "flash_attention_bwd": "the gradient of src/repro/kernels/"
                                   "flash_attn.py:66 (JAX differentiates "
                                   "src/repro/models/layers.py:141)",
            "flash_attention_f32": "src/repro/kernels/flash_attn.py:66",
            "flash_attention_bwd_f32": "the gradient of src/repro/kernels/"
                                       "flash_attn.py:66 (JAX "
                                       "differentiates src/repro/models/"
                                       "layers.py:141)",
            "linear_scan": "src/repro/models/ssm.py:57 chunked_linear_scan "
                           "(jnp, no Pallas kernel)",
            "linear_scan_bwd": "its gradient (JAX differentiates "
                               "src/repro/models/ssm.py:57)"}
LM_ARGV = ["--arch", "smollm-360m", "--seq-len", "2048",
           "--batch-per-worker", "4", "--steps", "5", "--device", "cuda"]
TRAIN_ARGV = ["--arch", "wdl-s1", "--workers", "4", "--batch-per-worker",
              "256", "--steps", "10", "--esd-alpha", "1", "--exchange",
              "ragged", "--capacity-ratio", "0.2", "--device", "cuda"]
# the training auction's rounds per step and worker at TRAIN_ARGV, seed 0,
# from the plain version on the CPU (scripts/train_auction_rounds.py
# --device cpu, and --codec int8): step 0 meets a cold cache
TRAIN_ROUNDS = {
    None: [[10390, 10256, 10547, 10663], [2016, 2752, 446, 58],
           [43, 1013, 50, 89], [73, 61, 32, 66], [53, 48, 49, 106],
           [45, 41, 34, 47], [40, 32, 40, 34], [35, 50, 48, 63],
           [63, 62, 64, 52], [53, 234, 31, 44]],
    "int8": [[9951, 10267, 10571, 10633], [48, 50, 2022, 587],
             [45, 79, 737, 44], [101, 41, 57, 99], [45, 36, 46, 56],
             [49, 45, 63, 41], [48, 38, 47, 34], [50, 38, 53, 38],
             [27, 2216, 38, 43], [68, 40, 25, 49]]}


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, reps: int = 50) -> tuple[float, float]:
    """(device ms, call ms): medians over ``reps`` calls timed with CUDA
    events.  For the device time the stream is first held busy with a
    spin longer than the host takes to enqueue the call, so the events
    bracket the device work alone; the call time has no spin and so also
    counts the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(host_s * 4e9) + 200_000          # cycles, at <= 4 GHz
    dev, call = [], []
    for hold, out in ((True, dev), (False, call)):
        pairs = []
        for _ in range(reps):
            if hold:
                torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
            if hold:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        out.extend(s.elapsed_time(e) for s, e in pairs)
    return statistics.median(dev), statistics.median(call)


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[device] {name} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return name


def _was_build(was: Path):
    """The ``_build`` module of the checkout in ``was``, loaded under its
    own name: it builds that checkout's sources into its own
    ``build/kernels``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "was_build", was / "src" / "repro_torch" / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_build(was: Path | None = None):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = ("emb_lookup", "exchange_pack", "auction", "flash_attn_sm90",
             "flash_attn_tf32", "flash_attn_bwd_sm90", "flash_attn_bwd_tf32",
             "linear_scan")
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the parent's f32 kernels: the CUDA-core forward and backward
        was_libs = (pool.submit(lambda: _was_build(was).load_libraries(
            "flash_attn", "flash_attn_bwd")) if was is not None else None)
        _build.load_libraries(*names)
        was_libs = was_libs.result() if was_libs is not None else None
    dt = time.perf_counter() - t
    extra = f" and {was}'s flash_attn, flash_attn_bwd" if was else ""
    print(f"[build] {', '.join(names)}{extra} in {dt:.2f} s (in parallel)")
    for name in names:
        # ptxas reports, per kernel: the entry, then its stack and
        # spills, then its registers
        kernel, facts = "?", []
        for ln in _build.build_log(name).splitlines():
            if "Compiling entry function" in ln:
                # the mangled name's length-prefixed identifier that ends
                # in _kernel (inside an anonymous namespace's hash too)
                named = next((m[2][:int(m[1])] for m in re.finditer(
                    r"(?=(\d+)([A-Za-z_]\w*))", ln)
                    if m[2][:int(m[1])].endswith("_kernel")
                    and len(m[2]) >= int(m[1])), None)
                kernel = named if named else next(
                    (k for k in SOURCES if f"{k}_kernel" in ln),
                    ln.split("'")[1] if "'" in ln else ln)
                # a template instance: element type (the _sm90
                # libraries: bf16), hd
                inst = re.search(r"kernelI(f|13__nv_bfloat16)?Li(\d+)E", ln)
                if inst:
                    bf16 = (inst[1] == "13__nv_bfloat16"
                            or (inst[1] is None and name.endswith("sm90")))
                    kernel += (f"<{'bf16' if bf16 else 'f32'}, "
                               f"hd {inst[2]}>")
            elif "spill" in ln or "registers" in ln:
                facts.append(ln.split(":", 1)[-1].strip())
                if "registers" in ln:
                    print(f"[build] {name} {kernel}: " + "; ".join(facts))
                    facts = []
    objdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, ops in (("flash_attn_sm90", ("HGMMA",)),
                      ("flash_attn_bwd_sm90", ("HGMMA",)),
                      ("flash_attn_tf32", ("HGMMA",)),
                      ("flash_attn_bwd_tf32", ("HGMMA",))):
        sass = subprocess.run([objdump, "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        print(f"[build] {name} SASS: {counts}")
        check(sum(counts.values()) > 0, f"{name} runs on the tensor cores "
                                        f"({' or '.join(ops)} in its SASS)")
    return was_libs


def _launch_counters():
    from repro_torch.kernels import (auction, emb_lookup, exchange_pack,
                                     flash_attn, linear_scan)

    return (emb_lookup.LAUNCHES, exchange_pack.LAUNCHES, auction.LAUNCHES,
            flash_attn.LAUNCHES, linear_scan.LAUNCHES)


def _zero_launches():
    from repro_torch.kernels import flash_attn

    for counts in (*_launch_counters(), flash_attn.BWD_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _read_launches() -> dict:
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def _bwd_routes() -> dict:
    """B8's backward launches by route (``wgmma``: bf16, ``tf32x3``:
    f32), counted like the launches."""
    from repro_torch.kernels import flash_attn

    return dict(flash_attn.BWD_ROUTE_LAUNCHES)


def _check_bwd_wgmma(n: int, what: str, routes: dict | None = None):
    """A bf16 run's n backward launches of B8 all took the wgmma
    route."""
    routes = _bwd_routes() if routes is None else routes
    check(routes == {"wgmma": n, "tf32x3": 0},
          f"{what}: B8's {n} backward launches on the wgmma route "
          f"({routes})")


def _routes() -> tuple[dict, dict]:
    """B8's forward and backward launches by route, as counted so far."""
    from repro_torch.kernels import flash_attn

    return (dict(flash_attn.ROUTE_LAUNCHES),
            dict(flash_attn.BWD_ROUTE_LAUNCHES))


def _check_routes(before: tuple[dict, dict], route: str,
                  what: str) -> tuple[int, int]:
    """Every B8 launch since ``before`` (``_routes()``), forward and
    backward, took ``route`` (``wgmma`` for bf16, ``tf32x3`` for f32):
    returns (forward, backward) launches."""
    (f0, b0), (f1, b1) = before, _routes()
    fwd = {k: f1[k] - f0[k] for k in f1}
    bwd = {k: b1[k] - b0[k] for k in b1}
    check(all(fwd[k] == bwd[k] == 0 for k in fwd if k != route),
          f"{what}: every B8 launch on the {route} route (forward {fwd}, "
          f"backward {bwd})")
    return fwd[route], bwd[route]


# B1's inputs on this slice's paths beside the decide's compact table:
# "per-shard" (phase 15's multi-PS decide) and "dense" (phase 16's
# one-call dispatch with the dense cost); phase 3 fills their records,
# phases 15 and 16 their launches
B1_INPUTS: dict = {}


def phase_train_kernels(seed: int) -> dict:
    """B1, B2 and the exchange's one-launch pack at the training step's
    shapes."""
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.core.simulator import hetero_ps_bandwidths
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.kernels.ops import (cost_matrix_sparse_kernel,
                                         cost_matrix_sparse_ps_kernel,
                                         cost_table_dense, cost_table_sparse,
                                         cost_table_sparse_ps)
    from repro_torch.ps import make_partition

    wl = WORKLOADS["S1"]
    V, n, m = wl.vocab, 4, 256
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    rec = {}

    def pooled(what, table, ids, w):
        out = K.pooled_lookup(table, ids, w)
        ref = K.pooled_lookup_ref(table, ids, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"pooled_lookup {what} is bitwise "
                                     f"equal to plain")
        ms, call_ms = device_ms(lambda: K.pooled_lookup(table, ids, w))
        plain_ms, _ = device_ms(
            lambda: K.pooled_lookup_ref(table, ids, w), reps=20)
        valid = ids >= 0
        ids_c = torch.where(valid, ids, 0).long()
        w_c = torch.where(valid, w, 0.0)
        lib_ms, _ = device_ms(lambda: torch.nn.functional.embedding_bag(
            ids_c, table, mode="sum", per_sample_weights=w_c))
        B, F = ids.shape
        E = table.shape[1]
        rows = int(torch.unique(ids_c).numel())
        b_ms, b_by = bound(rows * E * 4 + 2 * B * F * 4 + B * E * 4,
                           2 * B * F * E)
        print(f"[kernel] pooled_lookup {what} B={B} F={F} E={E} "
              f"rows={rows}: exact, {ms:.4f} ms (call {call_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, embedding_bag {lib_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({b_by})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # the decide stage: Alg. 1's compact (U, 4) cost table from a random
    # cache state, pooled over one S1 batch's remapped ids
    latest = torch.rand((n, V), generator=g, device=dev) < 0.3
    dirty = latest & (torch.rand((n, V), generator=g, device=dev) < 0.5)
    t_tran = torch.tensor((512 * 4.0) / DEFAULT_BANDWIDTHS(n),
                          dtype=torch.float32, device=dev)
    samples = torch.as_tensor(wl.sample_batch(rng, m).astype(np.int32),
                              device=dev)
    table, inv, w = cost_table_sparse(samples, latest, dirty, t_tran)
    rec["pooled_lookup"] = pooled(f"(decide, U={table.shape[0]})", table,
                                  inv, w)
    compact = K.pooled_lookup(table, inv, w)
    rec["alg1_cost"] = phase_alg1(latest, dirty, t_tran, dev, wl,
                                  np.random.default_rng(seed + 34))
    # phase 16's one-call dispatch with the dense cost: the (V, 4) per-id
    # table of all 502,000 ids, pooled over the samples' own ids; the
    # same per-id values in the same order as the compact route
    table_d, ids_d, w_d = cost_table_dense(samples, latest, dirty, t_tran)
    B1_INPUTS["dense"] = pooled(f"(dense table, V={table_d.shape[0]})",
                                table_d, ids_d, w_d)
    check(torch.equal(K.pooled_lookup(table_d, ids_d, w_d), compact),
          "B1 over the dense (V, 4) table gives the compact route's bits")
    del table_d
    # phase 15's decide: 2 shards, the --ps-hetero links, the per-shard
    # table at the batch's PS-linearized ids
    part = make_partition(V, 2)
    Vs = part.linear_size
    lat_ps = torch.rand((n, Vs), generator=g, device=dev) < 0.3
    dirty_ps = lat_ps & (torch.rand((n, Vs), generator=g, device=dev) < 0.5)
    lin = part.to_linear(samples)
    t_ps = torch.tensor((512 * 4.0) / hetero_ps_bandwidths(n, 2),
                        dtype=torch.float32, device=dev)
    table_ps, inv_ps, w_ps = cost_table_sparse_ps(lin, lat_ps, dirty_ps,
                                                  t_ps, part)
    B1_INPUTS["per-shard"] = pooled(
        f"(decide, 2 PS, hetero links, U={table_ps.shape[0]})", table_ps,
        inv_ps, w_ps)
    # equal links on both shards: the per-shard route is the compact one
    even = t_tran[:, None].repeat(1, 2).contiguous()
    check(torch.equal(cost_matrix_sparse_ps_kernel(lin, lat_ps, dirty_ps,
                                                   even, part),
                      cost_matrix_sparse_kernel(lin, lat_ps, dirty_ps,
                                                t_tran)),
          "B1 over the per-shard table at equal links gives the compact "
          "route's bits")
    print("[kernel] pooled_lookup: the dense (502,000, 4) table and the "
          "per-shard table at equal links give the compact route's bits")
    # the same kernel at E = 512 on the wdl-s1 table
    big = torch.randn((V, 512), generator=g, device=dev) * 0.01
    wts = torch.rand(samples.shape, generator=g, device=dev)
    pooled("(E=512, wdl-s1 table)", big, samples, wts)
    del big

    # the exchange's packs: 256 send slots, about a quarter PAD
    S = m
    slot_np = rng.permutation(m).astype(np.int32)
    slot_np[rng.random(S) < 0.25] = -1
    slot = torch.as_tensor(slot_np, device=dev)
    dense = torch.as_tensor(wl.dense_batch(rng, m), device=dev)
    labels = torch.as_tensor(wl.label_batch(rng, m)[:, None], device=dev)
    for what, rows in (("ids int32", samples), ("dense f32", dense),
                       ("labels f32", labels)):
        out = P.gather_rows(rows, slot)
        ref = P.gather_rows_ref(rows, slot)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"gather_rows {what} is exact")
        check(bool((out[slot < 0] == -1).all()), f"gather_rows {what} "
                                                 f"fills -1 in its dtype")
        ms, call_ms = device_ms(lambda: P.gather_rows(rows, slot))
        plain_ms, _ = device_ms(lambda: P.gather_rows_ref(rows, slot))
        ext = torch.cat([rows, torch.full_like(rows[:1], -1)])
        idx = torch.where(slot >= 0, slot, m).long()
        lib_ms, _ = device_ms(lambda: torch.index_select(ext, 0, idx))
        F = rows.shape[1]
        n_valid = int((slot >= 0).sum())
        b_ms, b_by = bound(S * F * 4 + n_valid * F * 4 + S * 4, 0)
        print(f"[kernel] gather_rows {what} S={S} F={F} valid={n_valid}: "
              f"exact, {ms:.4f} ms (call {call_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        if what == "ids int32":
            rec["gather_rows"] = dict(max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=b_ms, bound_by=b_by)
    rec["pack_send_all"] = phase_pack(rng, wl, n, m, dev)
    return rec


def phase_alg1(latest, dirty, t_tran, dev, wl, rng) -> dict:
    """Alg. 1 for all workers in one launch (``alg1_cost``), bit for bit
    its plain version and the per-worker route (the compact table's build
    and a B1 launch a worker), timed beside that route's whole call: at
    phase 3's decide (4 workers x 256 S1 samples of 74 ids, its random
    planes) and at the benchmark cells' (8 workers x 128 samples of S1's
    26 field ids, no history bag, over its 502,000 rows; the planes as
    60 steps of the cache protocol at ratio 0.08 left them; the paper's
    links).  Returns the cells' row."""
    from repro_torch.core import dispatch as D
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS

    def draw(n, m, F):
        s = wl.sample_batch(rng, n * m)[:, :F].reshape(n, m, F)
        return torch.as_tensor(s.astype(np.int32), device=dev)

    alg1_row("phase 3's decide", draw(latest.shape[0], 256, 74), latest,
             dirty, t_tran)
    n, m, F, V = 8, 128, 26, wl.vocab
    cap = int(0.08 * V)
    state = D.esd_sparse_init(n, V, cap, max_ids=m * F, device=dev)
    for _ in range(60):
        state, _ = D.esd_state_update_sparse(
            state, D.need_ids_list(draw(n, m, F)), cap)
    t = torch.tensor(transmission_time_codec(512, DEFAULT_BANDWIDTHS(n)),
                     dtype=torch.float32, device=dev)
    return alg1_row("the cells' decide", draw(n, m, F), state.latest,
                    state.dirty, t)


def host_ms(fn, reps: int = 50) -> float:
    """Median host ms to issue ``fn`` (no synchronise inside a call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    xs = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        xs.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(xs) * 1e3


def alg1_row(what, samples, latest, dirty, t_tran) -> dict:
    """One ``alg1_cost`` row: exact against plain and the per-worker
    route, device, call and host-issue ms beside the route's, and the
    bytes bound (each slot's id, its kept ids' 2n state bytes, the
    (n, m, n) output)."""
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.kernels.ops import cost_matrix_sparse_kernel

    n, m, F = samples.shape

    def fused():
        return K.alg1_cost(samples, latest, dirty, t_tran)

    def route():
        return torch.stack([cost_matrix_sparse_kernel(samples[i], latest,
                                                      dirty, t_tran)
                            for i in range(n)])

    out = fused()
    ref = K.alg1_cost_ref(samples, latest, dirty, t_tran)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"alg1_cost ({what}) is bitwise equal to "
                                 f"plain")
    check(torch.equal(out, route()), f"alg1_cost ({what}) is bitwise equal "
                                     f"to the per-worker route (B1 a "
                                     f"worker)")
    ms, call_ms = device_ms(fused)
    plain_ms, _ = device_ms(
        lambda: K.alg1_cost_ref(samples, latest, dirty, t_tran), reps=20)
    route_ms, route_call_ms = device_ms(route, reps=20)
    issue_ms, route_issue_ms = host_ms(fused), host_ms(route, reps=20)
    srt = torch.sort(samples.reshape(n * m, F), dim=1).values
    kept = int(((srt != -1) & torch.cat(
        [torch.ones_like(srt[:, :1], dtype=torch.bool),
         srt[:, 1:] != srt[:, :-1]], 1)).sum())
    b_ms, b_by = bound(n * m * F * 4 + kept * 2 * n + n * m * n * 4,
                       kept * n * 6)
    print(f"[kernel] alg1_cost ({what}, n={n} m={m} F={F} "
          f"V={latest.shape[1]}, {kept} kept slots, planes "
          f"{float(latest.float().mean()):.4f} latest, "
          f"{float(dirty.float().mean()):.4f} dirty): exact, {ms:.4f} ms "
          f"(call {call_ms:.4f}, host issue {issue_ms:.4f}), plain "
          f"{plain_ms:.4f} ms, the per-worker route {route_ms:.4f} ms "
          f"(call {route_call_ms:.4f}, host issue {route_issue_ms:.4f}), "
          f"bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, route_ms=route_ms,
                route_call_ms=route_call_ms, host_issue_ms=issue_ms,
                route_host_issue_ms=route_issue_ms)


def phase_pack(rng, wl, n: int, m: int, dev) -> dict:
    """The exchange's one-launch pack at the training step's shapes (4
    workers of 256: ids 74 int32, dense 13 f32, labels f32) against its
    plain version, which packs worker by worker; timed beside the 12
    row packs it replaces (given their slot maps) and beside those packs
    with the 12 slot maps the advance built before them."""
    from repro_torch.core.dispatch import dispatch_cap, exchange_budget
    from repro_torch.kernels import exchange_pack as P

    payloads = [
        torch.as_tensor(np.stack([wl.sample_batch(rng, m)
                                  for _ in range(n)]).astype(np.int32),
                        device=dev),
        torch.as_tensor(np.stack([wl.dense_batch(rng, m) for _ in range(n)]),
                        device=dev),
        torch.as_tensor(np.stack([wl.label_batch(rng, m) for _ in range(n)]),
                        device=dev)]
    balanced = np.stack([rng.permutation(np.repeat(np.arange(n), m // n))
                         for _ in range(n)])
    skew = rng.integers(0, n, (n, m))
    skew[:, : m // 2] = 0                  # worker 0 over its budget
    empty = rng.integers(0, n - 1, (n, m))     # nobody sends to the last
    # --cap-slack 0.5: groups of up to 96 rows on blocks of 128
    slack = exchange_budget(dispatch_cap(m, n, 0.5), m)
    uneven = np.stack([rng.permutation(np.repeat(
        np.arange(n), [m * 3 // 8, m // 4, m // 4, m // 8]))
        for _ in range(n)])
    cases = (("train", balanced, m // n), ("overflow", skew, m // n),
             ("empty destination", empty, slack),
             (f"relaxed budget {slack}", uneven, slack))
    for what, a_np, budget in cases:
        assign = torch.as_tensor(a_np.astype(np.int32), device=dev)
        got = P.pack_send_all(assign, payloads, n, budget)
        want = P.pack_send_all_ref(assign, payloads, n, budget)
        torch.cuda.synchronize()
        for x, y in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"pack_send_all {what} is bitwise equal to plain")
        ov = int(got[3])
        print(f"[kernel] pack_send_all {what}: n={n} m={m} budget={budget}"
              f" overflow={ov}: exact")
        check((ov > 0) == (what == "overflow"),
              f"pack_send_all {what}: overflow only where the budget is "
              f"short")
    assign = torch.as_tensor(balanced.astype(np.int32), device=dev)
    budget = m // n
    ms, call_ms = device_ms(lambda: P.pack_send_all(assign, payloads, n,
                                                    budget))
    plain_ms, plain_call = device_ms(
        lambda: P.pack_send_all_ref(assign, payloads, n, budget), reps=20)
    maps = [P.slot_map_ref(assign[i], n, budget)[0] for i in range(n)]

    def packs():
        for rows in payloads:
            for i in range(n):
                P.gather_rows(rows[i].reshape(m, -1), maps[i])

    def packs_and_maps():
        for rows in payloads:
            for i in range(n):
                P.gather_rows(rows[i].reshape(m, -1),
                              P.slot_map_ref(assign[i], n, budget)[0])

    was_ms, was_call = device_ms(packs)
    old_ms, old_call = device_ms(packs_and_maps, reps=20)
    S = n * budget
    words = sum(math.prod(r.shape[2:]) for r in payloads)
    # bytes: assign read, each sent row read once, every slot of every
    # payload written, with slot_to_row and the counts
    b_ms, b_by = bound(n * m * 4 + n * m * words * 4 + n * S * words * 4
                       + n * S * 4 + n * n * 4 + 4, 0)
    print(f"[kernel] pack_send_all train (ids 74 int32, dense 13 f32, "
          f"labels f32): {ms:.4f} ms (call {call_ms:.4f}), plain "
          f"{plain_ms:.4f} ms (call {plain_call:.4f}); the 12 gather_rows "
          f"it replaces {was_ms:.4f} ms (call {was_call:.4f}); with their 12"
          f" slot maps {old_ms:.4f} ms (call {old_call:.4f}); bound "
          f"{b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_quant_kernels(seed: int) -> dict:
    """B4 and B5 at the quantized wire's shapes."""
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.quant.codecs import get_codec, quantize_rows

    wl = WORKLOADS["S1"]
    V, m = wl.vocab, 256
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    rec = {}

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    # B4: one worker's send slots of the dense features, about a quarter
    # PAD; and 512-column rows
    S = m
    slot_np = rng.permutation(m).astype(np.int32)
    slot_np[rng.random(S) < 0.25] = -1
    slot = torch.as_tensor(slot_np, device=dev)
    n_valid = int((slot_np >= 0).sum())
    dense = torch.as_tensor(wl.dense_batch(rng, m), device=dev)
    wide_rows = torch.randn((m, 512), generator=g, device=dev)
    for name, rows in (("fp16", dense), ("int8", dense), ("int4", dense),
                       ("int8:4", dense), ("int8", wide_rows)):
        c = get_codec(name)
        F = rows.shape[1]
        out = P.gather_rows_quant(rows, slot, c)
        ref = P.gather_rows_quant_ref(rows, slot, c)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(out, ref)),
              f"gather_rows_quant {name} F={F} is bitwise equal to plain")
        if c.kind != "fp16":
            check(bool((out[1][slot < 0] == 1).all()
                       and (out[2][slot < 0] == -1).all()
                       and (out[0][slot < 0] == 0).all()),
                  f"gather_rows_quant {name}: PAD slots scale 1, zp -1")
        ms, call_ms = device_ms(lambda: P.gather_rows_quant(rows, slot, c))
        plain_ms, _ = device_ms(
            lambda: P.gather_rows_quant_ref(rows, slot, c), reps=20)
        G = out[1].shape[1]
        code_bytes = 2 if c.kind == "fp16" else 4
        n_bytes = S * 4 + n_valid * F * 4 + S * F * code_bytes + 2 * S * G * 4
        # min, max, subtract, divide, round and two clamps per element
        b_ms, b_by = bound(n_bytes, 0 if c.kind == "fp16" else 7 * S * F)
        print(f"[kernel] gather_rows_quant {name} S={S} F={F} G={G} "
              f"valid={n_valid}: bitwise, {ms:.4f} ms (call {call_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if name == "int8" and F == 13:
            rec["gather_rows_quant"] = dict(
                max_abs_err=float((out[0] - ref[0]).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del wide_rows
    rec["pack_send_all_quant"] = phase_quant_pack(rng, wl, 4, m, dev)

    # B5: one S1 batch pooled over the int8-quantized wdl-s1 table, and
    # over a quantized table at the decide stage's width E = 4
    ids = torch.as_tensor(wl.sample_batch(rng, m).astype(np.int32),
                          device=dev)
    w = torch.rand(ids.shape, generator=g, device=dev)
    valid = ids >= 0
    n_lookups = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    B, F = ids.shape
    for E in (512, 4):
        c = get_codec("int8")
        codes, scale, zp = quantize_rows(
            torch.randn((V, E), generator=g, device=dev) * 0.01, c)
        out = K.pooled_lookup_quant(codes, scale, zp, ids, w, codec=c)
        ref = K.pooled_lookup_quant_ref(codes, scale, zp, ids, w, codec=c)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(same_bits(out, ref), f"pooled_lookup_quant E={E} is bitwise "
                                   f"equal to plain (max err {err})")
        ms, call_ms = device_ms(
            lambda: K.pooled_lookup_quant(codes, scale, zp, ids, w, codec=c))
        plain_ms, _ = device_ms(
            lambda: K.pooled_lookup_quant_ref(codes, scale, zp, ids, w,
                                              codec=c), reps=20)
        G = scale.shape[1]
        n_bytes = rows * (E * 4 + G * 8) + 2 * B * F * 4 + B * E * 4
        # a multiply-add, a multiply and an add per looked-up element
        b_ms, b_by = bound(n_bytes, 4 * n_lookups * E)
        print(f"[kernel] pooled_lookup_quant int8 B={B} F={F} E={E} "
              f"G={G} V={V} rows={rows}: bitwise, {ms:.4f} ms (call "
              f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by})")
        if E == 512:
            rec["pooled_lookup_quant"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
        del codes, scale, zp
    return rec


def phase_quant_pack(rng, wl, n: int, m: int, dev) -> dict:
    """The exchange's one launch with the dense features on the quantized
    wire (4 workers of 256: ids 74 int32, dense 13 f32 quantized, labels
    f32) against its plain version, which packs and quantizes worker by
    worker; timed beside the path it replaced: the exact pack of ids and labels, then a
    pack-quantize a worker on the pack's slot maps, stacked."""
    from repro_torch.kernels import exchange_pack as P
    from repro_torch.quant.codecs import get_codec

    ids = torch.as_tensor(np.stack([wl.sample_batch(rng, m)
                                    for _ in range(n)]).astype(np.int32),
                          device=dev)
    dense = torch.as_tensor(np.stack([wl.dense_batch(rng, m)
                                      for _ in range(n)]), device=dev)
    labels = torch.as_tensor(np.stack([wl.label_batch(rng, m)
                                       for _ in range(n)]), device=dev)
    wide = torch.randn((n, m, 512), device=dev)
    balanced = torch.as_tensor(np.stack(
        [rng.permutation(np.repeat(np.arange(n), m // n))
         for _ in range(n)]).astype(np.int32), device=dev)
    skew = rng.integers(0, n, (n, m))
    skew[:, : m // 2] = 0                  # worker 0 over its budget
    skew = torch.as_tensor(skew.astype(np.int32), device=dev)
    budget = m // n
    marks = (False, True, False)

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    def flat(out):                 # every tensor of an output, but overflow
        return [t for x in out[0] for t in (x if isinstance(x, tuple)
                                            else (x,))] + list(out[1:3])

    cases = [(name, what, a, dense) for name in ("fp16", "int8", "int4",
                                                 "int8:4")
             for what, a in (("train", balanced), ("overflow", skew))]
    for name, what, assign, rows in cases + [("int8", "train", balanced,
                                              wide)]:
        payloads = [ids, rows, labels]
        got = P.pack_send_all(assign, payloads, n, budget, codec=name,
                              quantized=marks)
        want = P.pack_send_all_ref(assign, payloads, n, budget, codec=name,
                                   quantized=marks)
        torch.cuda.synchronize()
        check(all(same_bits(x, y) for x, y in zip(flat(got), flat(want)))
              and int(got[3]) == int(want[3]),
              f"pack_send_all_quant {name} {what} F={rows.shape[2]} is "
              f"bitwise equal to plain")
        check((int(got[3]) > 0) == (what == "overflow"),
              f"pack_send_all_quant {what}: overflow only where the budget "
              f"is short")
        print(f"[kernel] pack_send_all_quant {name} {what}: n={n} m={m} "
              f"budget={budget} F={rows.shape[2]} overflow="
              f"{int(got[3])}: bitwise")
    c = get_codec("int8")
    payloads = [ids, dense, labels]

    def fused():
        P.pack_send_all(balanced, payloads, n, budget, codec=c,
                        quantized=marks)

    def replaced():                # the exact pack, then B4 per worker
        _, stm, _, _ = P.pack_send_all(balanced, [ids, labels], n, budget)
        wire = [P.gather_rows_quant(dense[i], stm[i], c) for i in range(n)]
        return [torch.stack(t) for t in zip(*wire)]

    ms, call_ms = device_ms(fused)
    was_ms, was_call = device_ms(replaced)
    plain_ms, plain_call = device_ms(
        lambda: P.pack_send_all_ref(balanced, payloads, n, budget, codec=c,
                                    quantized=marks), reps=10)
    wide_ms, wide_call = device_ms(lambda: P.pack_send_all(
        balanced, [ids, wide, labels], n, budget, codec=c, quantized=marks))
    S = n * budget
    # bytes: assign read, each row of each payload read once, every slot
    # written (ids 74 words, labels 1, codes 13, scale and zp 1 each),
    # with slot_to_row and the counts; 7 operations a quantized element
    b_ms, b_by = bound(n * m * 4 + n * m * (74 + 13 + 1) * 4
                       + n * S * (74 + 1 + 13 + 2) * 4 + n * S * 4
                       + n * n * 4 + 4, 7 * n * S * 13)
    print(f"[kernel] pack_send_all_quant train (ids 74 int32, dense 13 f32 "
          f"int8, labels f32): {ms:.4f} ms (call {call_ms:.4f}); the path it replaced (pack, 4 gather_rows_quant, stack) "
          f"{was_ms:.4f} ms (call {was_call:.4f}); plain {plain_ms:.4f} ms "
          f"(call {plain_call:.4f}); dense at 512 columns {wide_ms:.4f} ms "
          f"(call {wide_call:.4f}); bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernels(seed: int) -> dict:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import emb_lookup as K
    from repro_torch.pipeline.prefetch import PrefetchPlane, slot_map
    from repro_torch.serve.sim import _hot_set

    wl = WORKLOADS["S1"]
    V, E, F = wl.vocab, 512, wl.n_fields
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    table = torch.randn((V, E), generator=g, device=dev) * 0.01
    hot = _hot_set(wl, np.random.default_rng(seed + 1), 2048, int(0.25 * V))
    C = len(hot)
    plane_rows = torch.randn((C, E), generator=g, device=dev) * 0.01
    rec = {}

    # staged_gather: the TTL refresh pull, ~1/4 of the slots due
    src_np = np.where(rng.random(C) < 0.25, hot, -1).astype(np.int32)
    src = torch.as_tensor(src_np, device=dev)
    out = K.staged_gather(plane_rows, table, src)
    ref = K.staged_gather_ref(plane_rows, table, src)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), "staged_gather is bitwise equal to plain")
    ms, call_ms = device_ms(lambda: K.staged_gather(plane_rows, table, src))
    plain_ms, plain_call = device_ms(
        lambda: K.staged_gather_ref(plane_rows, table, src))
    b_ms, b_by = bound(2 * C * E * 4 + C * 4, 0)
    rec["staged_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
    print(f"[kernel] staged_gather C={C} E={E} V={V} "
          f"due={int((src_np >= 0).sum())}:"
          f" exact, {ms:.4f} ms (call {call_ms:.4f}), plain {plain_ms:.4f} ms"
          f" (call {plain_call:.4f}), bound {b_ms:.4f} ms ({b_by})")

    # staged_gather at the training prefetch plane (--prefetch 64
    # --prefetch-slots 512): 64 of 512 slots pull a table row
    Cp, pulls = 512, 64
    plane_p = torch.randn((Cp, E), generator=g, device=dev) * 0.01
    src_p = np.full(Cp, -1, np.int32)
    src_p[rng.choice(Cp, pulls, replace=False)] = rng.choice(V, pulls,
                                                             replace=False)
    src_p = torch.as_tensor(src_p, device=dev)
    out = K.staged_gather(plane_p, table, src_p)
    ref = K.staged_gather_ref(plane_p, table, src_p)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "staged_gather at the prefetch plane's "
                                 "shape is bitwise equal to plain")
    ms_p, call_p = device_ms(lambda: K.staged_gather(plane_p, table, src_p))
    plain_p, plain_call_p = device_ms(
        lambda: K.staged_gather_ref(plane_p, table, src_p))
    bp_ms, bp_by = bound(2 * Cp * E * 4 + Cp * 4, 0)
    print(f"[kernel] staged_gather (training prefetch pull) C={Cp} E={E} "
          f"pulled={pulls}: exact, {ms_p:.4f} ms (call {call_p:.4f}), plain "
          f"{plain_p:.4f} ms (call {plain_call_p:.4f}), bound {bp_ms:.4f} ms "
          f"({bp_by})")

    # the launch floor: an empty kernel through the same ctypes path
    from repro_torch.kernels._build import load_library

    lib = load_library("emb_lookup")
    floor_ms, floor_call = device_ms(lambda: lib.empty_launch(
        torch.cuda.current_stream().cuda_stream))
    print(f"[kernel] launch floor (an empty kernel): {floor_ms:.4f} ms "
          f"(call {floor_call:.4f})")

    # plane_refresh, in place: phase 5's refresh (step 32, ttl 32, budget
    # 64) on a cold plane whose every slot is due with one expiry (the
    # ties), without a budget at ~1/4 due (two launches: the list, then
    # staged_pull over the grid), and select-only (the codec's route)
    hot_ids = torch.as_tensor(hot.astype(np.int32), device=dev)
    rng_r = np.random.default_rng(seed + 2)
    quarter = torch.as_tensor(np.where(rng_r.random(C) < 0.25, 32, 33)
                              .astype(np.int32), device=dev)
    ties = torch.full((C,), 32, dtype=torch.int32, device=dev)
    live = plane_rows.clone()
    for what, exp, budget, pull in (("budget 64, ties", ties, 64, True),
                                    ("no budget, 1/4 due", quarter, None,
                                     True),
                                    ("select-only, budget 64, ties", ties,
                                     64, False)):
        got = PrefetchPlane(ids=hot_ids, rows=plane_rows.clone(),
                            expiry=exp.clone())
        want = PrefetchPlane(ids=hot_ids, rows=plane_rows.clone(),
                             expiry=exp.clone())
        n, sl, si = K.plane_refresh(got, table, 32, 32, budget, pull=pull)
        n_ref, sl_ref, si_ref = K.plane_refresh_ref(want, table, 32, 32,
                                                    budget, pull=pull)
        torch.cuda.synchronize()
        check(int(n) == int(n_ref) and torch.equal(got.rows, want.rows)
              and torch.equal(got.expiry, want.expiry)
              and (pull or (torch.equal(sl, sl_ref)
                            and torch.equal(si, si_ref))),
              f"plane_refresh ({what}) is bitwise equal to plain")
        n = int(n)
        # every call takes a fresh copy of the expiry (the rows are
        # shared), so each finds the same backlog
        pools = [itertools.cycle([PrefetchPlane(
            ids=hot_ids, rows=live, expiry=exp.clone()) for _ in range(k)])
            for k in (110, 50)]
        ms, call_ms = device_ms(lambda: K.plane_refresh(
            next(pools[0]), table, 32, 32, budget, pull=pull))
        plain_ms, plain_call = device_ms(lambda: K.plane_refresh_ref(
            next(pools[1]), table, 32, 32, budget, pull=pull), reps=20)
        cap = C if budget is None else budget
        n_bytes = C * 8 + n * 4 + (n * E * 8 if pull else cap * 8)
        b_ms, b_by = bound(n_bytes, 0)
        if budget == 64 and pull:
            rec["plane_refresh"] = dict(max_abs_err=0.0, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by)
        print(f"[kernel] plane_refresh C={C} E={E} {what}: {n} refreshed,"
              f" exact, {ms:.4f} ms (call {call_ms:.4f}; launch floor "
              f"{floor_ms:.4f}), plain {plain_ms:.4f} ms (call "
              f"{plain_call:.4f}), bound {b_ms:.6f} ms ({b_by})")

    # staged_pull, in place: the training prefetch pull, the same 64 of
    # 512 slots as staged_gather's above
    slot_p = torch.nonzero(src_p >= 0).flatten().to(torch.int32)
    pull_src = src_p[slot_p.long()].contiguous()
    want = K.staged_gather(plane_p, table, src_p)
    ref = K.staged_pull_ref(plane_p.clone(), table, slot_p, pull_src)
    out = K.staged_pull(plane_p.clone(), table, slot_p, pull_src)
    torch.cuda.synchronize()
    check(torch.equal(out, ref) and torch.equal(out, want),
          "staged_pull is bitwise equal to plain and to staged_gather")
    target = plane_p.clone()
    ms_s, call_s = device_ms(lambda: K.staged_pull(target, table, slot_p,
                                                   pull_src))
    plain_s, plain_call_s = device_ms(lambda: K.staged_pull_ref(
        target, table, slot_p, pull_src))
    bs_ms, bs_by = bound(pulls * E * 8 + pulls * 8, 0)
    rec["staged_pull"] = dict(max_abs_err=0.0, ms=ms_s, plain_ms=plain_s,
                              bound_ms=bs_ms, bound_by=bs_by)
    print(f"[kernel] staged_pull (training prefetch pull) C={Cp} E={E} "
          f"pulled={pulls}: exact, {ms_s:.4f} ms (call {call_s:.4f}; "
          f"staged_gather {ms_p:.4f}, call {call_p:.4f}), plain "
          f"{plain_s:.4f} ms (call {plain_call_s:.4f}), bound {bs_ms:.6f} "
          f"ms ({bs_by})")

    # pooled_lookup_staged: history bags of the synthetic stream against
    # the hot-set plane, at the serving micro-batch and at a large batch
    plane = PrefetchPlane(ids=torch.as_tensor(hot.astype(np.int32),
                                              device=dev),
                          rows=plane_rows,
                          expiry=torch.full((C,), 1, dtype=torch.int32,
                                            device=dev))
    smap = slot_map(plane, V, 0)

    def bags(B):
        hist = wl.sample_batch(rng, B)[:, F:]
        ids = torch.as_tensor(hist.astype(np.int32), device=dev)
        return ids, torch.where(ids >= 0, smap[ids.long().clamp(min=0)], -1)

    def staged_exact(what, plane_rows, table, slots, ids, w=None):
        out = K.pooled_lookup_staged(plane_rows, table, slots, ids, w)
        ref = K.pooled_lookup_staged_ref(plane_rows, table, slots, ids, w)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"pooled_lookup_staged {what} is bitwise equal to plain")
        return out

    for B in (16, 4096):
        ids, slots = bags(B)
        staged_exact(f"B={B}", plane_rows, table, slots, ids)
        ms, call_ms = device_ms(
            lambda: K.pooled_lookup_staged(plane_rows, table, slots, ids))
        plain_ms, plain_call = device_ms(
            lambda: K.pooled_lookup_staged_ref(plane_rows, table, slots,
                                               ids), reps=20)
        hist, s_np = ids.cpu().numpy(), slots.cpu().numpy()
        valid = hist >= 0
        n_rows = (len(np.unique(s_np[valid & (s_np >= 0)]))
                  + len(np.unique(hist[valid & (s_np < 0)])))
        n_bytes = (n_rows + B) * E * 4 + 2 * B * hist.shape[1] * 4
        b_ms, b_by = bound(n_bytes, 2 * int(valid.sum()) * E)
        print(f"[kernel] pooled_lookup_staged B={B} F={hist.shape[1]} E={E}"
              f" valid={int(valid.sum())} rows={n_rows}: exact,"
              f" {ms:.4f} ms (call {call_ms:.4f}; launch floor "
              f"{floor_ms:.4f}), plain {plain_ms:.4f} ms"
              f" (call {plain_call:.4f}), bound {b_ms:.6f} ms ({b_by})")
        if B == 16:
            rec["pooled_lookup_staged"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)
    # around the path: an all-PAD bag, weights, and rows of E = 510 (the
    # scalar layout)
    ids, slots = bags(16)
    ids[3], slots[3] = -1, -1
    w = torch.rand(ids.shape, generator=g, device=dev)
    out = staged_exact("B=16 with an all-PAD bag and weights", plane_rows,
                       table, slots, ids, w)
    check(not out[3].any(), "an all-PAD bag pools to zeros")
    V_odd = 50_000
    odd = torch.randn((V_odd, 510), generator=g, device=dev)
    ids_odd = torch.where(ids >= 0, ids % V_odd, -1)
    staged_exact("E=510 (scalar layout)", odd[:C].contiguous(), odd,
                 slots.clamp(max=C - 1), ids_odd, w)
    print("[kernel] pooled_lookup_staged: exact with an all-PAD bag "
          "(zeros), with weights, and at E = 510")
    return rec


def phase_parity(seed: int):
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.models.dlrm import init_params
    from repro_torch.serve import make_serve_step, refresh_plane, seed_plane

    worst = worst_rows = 0.0
    for arch in ("wdl-tiny", "dfm-tiny", "dcn-tiny"):
        cfg = DLRM_CONFIGS[arch]
        wl = WORKLOADS[cfg.workload]
        cpu = init_params(cfg, wl, torch.Generator().manual_seed(seed), "cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(seed)
        sparse = wl.sample_batch(rng, 8)
        dense = wl.dense_batch(rng, 8)
        ids = np.unique(sparse[sparse >= 0])
        hot = ids[rng.random(ids.size) < 0.6]
        step_fn = make_serve_step(cfg, wl.n_fields)
        for codec in (None, "int8"):
            pc = seed_plane(cpu.embed, hot, step=0, ttl=4, codec=codec)
            pg = seed_plane(gpu.embed, hot, step=0, ttl=4, codec=codec)
            for step in (0, 6):
                if step:
                    pc, nc = refresh_plane(pc, cpu.embed * 1.5, step, ttl=4,
                                           budget=max(1, hot.size // 2),
                                           codec=codec)
                    pg, ng = refresh_plane(pg, gpu.embed * 1.5, step, ttl=4,
                                           budget=max(1, hot.size // 2),
                                           codec=codec)
                    check(int(nc) == int(ng), "refresh counts agree")
                    for f in ("ids", "expiry"):
                        check(torch.equal(getattr(pc, f),
                                          getattr(pg, f).cpu()),
                              f"refreshed plane {f} equal on card and CPU "
                              f"(codec {codec})")
                    # exact rows are copies; the codec's round trip is
                    # computed by each device's own passes
                    d = float((pc.rows - pg.rows.cpu()).abs().max())
                    check(d == 0.0 if codec is None else d <= 1e-6,
                          f"refreshed plane rows on card and CPU (codec "
                          f"{codec}): max abs diff {d}")
                    worst_rows = max(worst_rows, d)
                lc, qc = step_fn(cpu, pc, sparse, dense, step)
                lg, qg = step_fn(gpu, pg, sparse, dense, step)
                for a, b, what in ((lc, lg, "logits"), (qc, qg, "pooled")):
                    b = b.cpu()
                    check(bool(torch.isfinite(b).all()),
                          f"{arch} {what} finite")
                    check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                          f"{arch} {what} on card vs CPU within 1e-5")
                    worst = max(worst, float((a - b).abs().max()))
    print(f"[parity] serve step + refresh (exact and int8), card vs CPU, "
          f"wdl/dfm/dcn-tiny: max abs err {worst:.3g} (tolerance 1e-5); "
          f"refreshed rows max abs diff {worst_rows:.3g} (exact: 0, int8: "
          f"1e-6)")


def phase_train_parity(seed: int, codec=None):
    """3 steps of the training stages at wdl-tiny (4 workers x 8, ragged
    exchange, alpha 1; exact or over the ``codec`` wire) on the card and
    on the CPU from the same weights: integer outputs and labels equal,
    dense features within 1e-6 (with the codec: dequantized on the
    receiver), losses and parameters within 1e-5."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.core.cost import transmission_time_codec
    from repro_torch.core.dispatch import esd_sparse_init
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.steps import make_dlrm_esd_stages
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.dlrm import bce_loss, init_params
    from repro_torch.optim import rowwise_adagrad
    from repro_torch.quant.codecs import resolve_link_codecs

    cfg = DLRM_CONFIGS["wdl-tiny"]
    wl = WORKLOADS[cfg.workload]
    n, m, V = 4, 8, wl.vocab
    cap = int(0.2 * V)
    bw = DEFAULT_BANDWIDTHS(n)
    t_np = transmission_time_codec(cfg.embedding_dim, bw,
                                   resolve_link_codecs("uniform", bw, codec))
    cpu = init_params(cfg, wl, torch.Generator().manual_seed(seed), "cpu")
    runs = {}
    for key, dev, model in (("cpu", "cpu", cpu),
                            ("card", "cuda", copy.deepcopy(cpu).to("cuda"))):
        t = torch.tensor(t_np, dtype=torch.float32, device=dev)
        decide, advance, _, out_rows = make_dlrm_esd_stages(
            n, m, t, 1.0, exchange="ragged", capacity=cap, codec=codec)
        state = esd_sparse_init(n, V, cap, max_ids=out_rows * wl.width,
                                device=dev)
        train = make_train_step(model, bce_loss, rowwise_adagrad(1e-2),
                                codec)
        log = []
        for s, d, l in itertools.islice(wl.stream(seed + 1, n * m), 3):
            s = torch.as_tensor(s.astype(np.int32), device=dev)
            d, l = torch.as_tensor(d, device=dev), torch.as_tensor(l,
                                                                 device=dev)
            assign, _ = decide(state, s)
            (s2, d2, l2), state, counts = advance(state, s, d, l, assign)
            loss = train(s2, d2, l2)
            log.append(([assign, s2, l2, *counts.values()], d2, loss))
        runs[key] = log, [p.detach() for p in model.parameters()]
    (lc, pc), (lg, pg) = runs["cpu"], runs["card"]
    worst = dense_err = 0.0
    for (ints_c, d_c, loss_c), (ints_g, d_g, loss_g) in zip(lc, lg):
        for a, b in zip(ints_c, ints_g):
            check(torch.equal(a, b.cpu()), "training stages: assignment, "
                  "exchanged ids and labels and counts equal on card and "
                  "CPU")
        check(torch.allclose(d_c, d_g.cpu(), rtol=0, atol=1e-6),
              "exchanged dense features on card vs CPU within 1e-6")
        dense_err = max(dense_err, float((d_c - d_g.cpu()).abs().max()))
        check(torch.allclose(loss_c, loss_g.cpu(), rtol=1e-5, atol=1e-5),
              "training loss on card vs CPU within 1e-5")
        worst = max(worst, float((loss_c - loss_g.cpu()).abs()))
    for a, b in zip(pc, pg):
        check(torch.allclose(a, b.cpu(), rtol=1e-5, atol=1e-5),
              "trained parameters on card vs CPU within 1e-5")
        worst = max(worst, float((a - b.cpu()).abs().max()))
    print(f"[parity] 3 training steps, card vs CPU, wdl-tiny, codec "
          f"{codec or 'none'}: assignments, exchanged ids and labels and "
          f"counts equal; dense features max abs err {dense_err:.3g} "
          f"(tolerance 1e-6); losses {[round(float(x[2]), 6) for x in lg]}; "
          f"max abs err of losses and parameters {worst:.3g} (tolerance "
          f"1e-5)")


PIPE_PARITY = {"depth 2": ["--pipeline-depth", "2"],
               "stale": ["--pipeline-depth", "2", "--stale-decide"],
               "depth 3, decide-ahead 2, prefetch": [
                   "--pipeline-depth", "3", "--decide-ahead", "2",
                   "--lookahead", "2", "--prefetch", "16",
                   "--prefetch-slots", "64"]}


# the multi-PS and dense-engine runs of phase 4
PS_PARITY = {"3 PS hashed, hetero links": ["--n-ps", "3", "--ps-layout",
                                           "hashed", "--ps-hetero"],
             "dense engine, depth 2": ["--esd-engine", "dense",
                                       "--pipeline-depth", "2"]}


def phase_train_pipeline_parity(seed: int, runs: dict = PIPE_PARITY):
    """``run_dlrm`` at wdl-tiny (4 workers x 8, 5 steps) in each of
    ``runs``' configurations (pipelined: its chain on a stream of its own
    on the card) against the same run on the CPU from the same weights:
    every integer field equal, losses and Alg.-1 costs within 1e-5, the
    final prefetch plane's ids and expiry equal and its rows bit for
    bit."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.train import build_parser, run_dlrm
    from repro_torch.models.dlrm import init_params

    cfg = DLRM_CONFIGS["wdl-tiny"]
    cpu = init_params(cfg, WORKLOADS[cfg.workload],
                      torch.Generator().manual_seed(seed), "cpu")
    base = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker",
            "8", "--steps", "5", "--esd-alpha", "1", "--exchange", "ragged",
            "--seed", str(seed)]
    for what, extra in runs.items():
        outs = {dev: run_dlrm(build_parser().parse_args(
                    base + extra + ["--device", dev]),
                    model=copy.deepcopy(cpu).to(dev))
                for dev in ("cpu", "cuda")}
        rc, rg = outs["cpu"]["metrics"], outs["cuda"]["metrics"]
        check(outs["cuda"]["stage_clock"]
              == ("device" if "--pipeline-depth" in extra else "host"),
              "a pipelined card run put its chain on a stream of its own")
        worst = 0.0
        for a, b in zip(rc, rg, strict=True):
            check(set(a) == set(b), f"{what}: the same record fields")
            for key, v in a.items():
                if key in ("loss", "alg1_est", "alg1_realized", "cost"):
                    check(math.isclose(b[key], v, rel_tol=1e-5, abs_tol=0),
                          f"{what}: {key} on card vs CPU within 1e-5")
                    worst = max(worst, abs(b[key] - v) / abs(v))
                elif key != "wall_s":
                    check(b[key] == v, f"{what}: {key} equal on card and CPU")
        pc, pg = outs["cpu"]["prefetch_plane"], outs["cuda"]["prefetch_plane"]
        if pc is not None:
            for key in ("ids", "expiry", "rows"):
                check(torch.equal(getattr(pc, key), getattr(pg, key).cpu()),
                      f"{what}: the final plane's {key} equal on card and "
                      f"CPU")
        print(f"[parity] run_dlrm {what}, card vs CPU, wdl-tiny, 5 steps: "
              f"integer fields equal, losses {[r['loss'] for r in rg]}, max "
              f"rel err of losses and costs {worst:.3g} (tolerance 1e-5)"
              + ("; the final plane's ids, expiry and rows equal"
                 if pc is not None else ""))


def phase_serve(seed: int, codec=None, duration: float = 1.0) -> dict:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.serve import build_parser, run_serve
    from repro_torch.serve import StreamConfig, request_arrivals

    argv = ["--arch", "wdl-s1", "--workers", "4", "--qps", "2000",
            "--duration", str(duration), "--max-batch", "16",
            "--ttl-batches", "32", "--refresh-budget", "64",
            "--device", "cuda", "--seed", str(seed)]
    if codec is not None:
        argv += ["--codec", codec]
    args = build_parser().parse_args(argv)
    _zero_launches()
    out = run_serve(args)
    launches = {k: v for k, v in _read_launches().items() if v}
    n_stream = len(request_arrivals(StreamConfig(
        workload=WORKLOADS["S1"], qps=2000.0, duration_s=duration,
        seed=seed))[0])
    per_batch = {k: round(v / out["n_batches"], 3)
                 for k, v in launches.items()}
    print(f"[serve] wdl-s1, codec {out['codec']}, {duration} s: n_requests "
          f"{out['n_requests']} in "
          f"{out['n_batches']} batches, p50 {out['p50_ms']:.3f} ms, "
          f"p99 {out['p99_ms']:.3f} ms, refresh_rows {out['refresh_rows']}, "
          f"slo_violation_rate {out['slo_violation_rate']:.4f}, decide "
          f"{out['decide_ms_mean']:.3f} ms/batch, worker step "
          f"{out['worker_step_ms_mean']:.3f} ms x {out['worker_steps']}; "
          f"launches {launches} ({per_batch} per micro-batch)")
    check(launches.get("pooled_lookup_staged", 0) > 0,
          "the pooled history bag kernel launched on the serving path")
    # a refresh for each worker step, the warm-up's and each seed's
    refreshes = out["worker_steps"] + 1 + 4
    check(launches.get("plane_refresh") == refreshes,
          f"one plane_refresh launch a refresh ({refreshes})")
    check("staged_gather" not in launches,
          "the refresh runs in place: no staged_gather")
    # the seeds take no budget: their lists are pulled by staged_pull; with
    # the codec every refresh writes its quantized rows by staged_pull
    pulls = 4 if codec is None else refreshes
    check(launches.get("staged_pull") == pulls,
          f"staged_pull {pulls} times: one launch a worker refresh"
          + ("" if codec is None else " and one for its quantized rows"))
    check(out["n_requests"] == n_stream, "every request of the stream served")
    check(out["nonfinite_logits"] == 0, "all logits finite")
    check(out["refresh_rows"] > 0, "TTL refreshes happened")
    return launches


TRAIN_DEPTH1: dict = {}     # codec -> (run_dlrm summary, launches a step)
TRAIN_DEPTH2: dict = {}     # codec -> phase 10's depth-2 (summary, a step)


def phase_train(seed: int, codec=None) -> dict:
    from repro_torch.kernels import auction as A
    from repro_torch.launch.train import build_parser, run_dlrm

    argv = TRAIN_ARGV + ["--seed", str(seed)]
    if codec is not None:
        argv += ["--codec", codec]
    args = build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    A.ROUNDS_LOG = []
    _zero_launches()
    try:
        out = run_dlrm(args)    # raises if a step's exchange overflowed
    finally:
        launches = {k: v for k, v in _read_launches().items() if v}
        solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    recs = out["metrics"]
    per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
    TRAIN_DEPTH1[codec] = out, per_step
    losses = [r["loss"] for r in recs]
    print(f"[train] wdl-s1, codec {out['codec']}, {out['workers']} workers x "
          f"{out['batch'] // out['workers']}, {len(recs)} steps: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; decide "
          f"{out['decide_ms_mean']:.3f} ms, advance "
          f"{out['advance_ms_mean']:.3f} ms, train "
          f"{out['train_ms_mean']:.3f} ms per step (mean of steps 1..), "
          f"{out['samples_per_s']:.1f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches} ({per_step} per step); exchange_overflow 0")
    for key in ("miss_pull", "update_push", "evict_push"):
        print(f"[train] {key} per step: {[r[key] for r in recs]}")
    print("[train] step ms (decide, advance, train) per step: " + str([
        tuple(round(x * 1e3, 2) for x in t) for t in zip(
            *(out["stage_s"][s] for s in ("decide", "advance", "train")))]))
    rounds = [r.sum(dim=1).tolist() for r in solves]
    print(f"[train] auction rounds per step, per worker: {rounds}")
    check(per_step.get("alg1_cost") == 1.0 and "pooled_lookup" not in
          launches, "decide prices every worker in one alg1_cost launch "
                    "a step, and no pooled_lookup runs")
    check(per_step.get("auction_solve") == 1.0 and len(solves) == len(recs)
          and "auction_bids" not in launches,
          "the training auction ran as one auction_solve launch a step, "
          "never on the bid kernel")
    check(args.seed != 0 or rounds == TRAIN_ROUNDS[codec][:len(rounds)],
          "the training auction's rounds equal the CPU's "
          "(scripts/train_auction_rounds.py --device cpu)")
    pack, other = (("pack_send_all", "pack_send_all_quant") if codec is None
                   else ("pack_send_all_quant", "pack_send_all"))
    check(per_step.get(pack) == 1.0 and other not in launches
          and "gather_rows" not in launches,
          f"one {pack} launch a step packs the exchange, for every "
          f"worker and payload; gather_rows never runs on the step")
    check("gather_rows_quant" not in launches,
          "gather_rows_quant never runs on the step: the pack quantizes "
          "the dense features in its one launch")
    check(all(np.isfinite(losses)), "every training loss finite")
    check(all(r["miss_pull"] > 0 for r in recs), "miss_pull > 0 each step")
    return launches


# the README's pipelined configuration at full width
AHEAD_ARGV = ["--pipeline-depth", "4", "--lookahead", "4", "--decide-ahead",
              "3", "--prefetch", "64", "--prefetch-slots", "512"]


def phase_train_pipeline(seed: int) -> dict:
    """``run_dlrm`` at wdl-s1 pipelined: depth 2, exact and with
    ``--codec int8``, each record bit for bit phase 6's depth-1 record,
    the auction's rounds and the launches a step depth 1's; depth 2 with
    stale decisions; and the README's configuration (depth 4, lookahead 4,
    decide-ahead 3, 64 rows a step into 512 slots), its prefetch pull one
    staged_pull launch a step, in place."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.kernels import auction as A
    from repro_torch.launch.train import build_parser, run_dlrm
    from repro_torch.quant.codecs import row_wire_bytes

    total: dict = {}

    def run(extra):
        args = build_parser().parse_args(TRAIN_ARGV + extra
                                         + ["--seed", str(seed)])
        A.ROUNDS_LOG = []
        _zero_launches()
        try:
            out = run_dlrm(args)
        finally:
            launches = {k: v for k, v in _read_launches().items() if v}
            solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        recs = out["metrics"]
        per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
        print(f"[train-pipeline] {' '.join(extra)}: wall "
              f"{out['wall_ms_mean']:.3f} ms a step (mean after the first "
              f"{out['pipeline_depth']}), device ms decide "
              f"{out['decide_ms_mean']:.3f}, advance "
              f"{out['advance_ms_mean']:.3f}, train "
              f"{out['train_ms_mean']:.3f}; host ms {out['host_ms_mean']}; "
              f"{out['samples_per_s']:.1f} samples/s; losses "
              f"{[r['loss'] for r in recs]}; launches {per_step} per step")
        check(out["stage_clock"] == "device",
              "the chain ran on a stream of its own")
        check(all(np.isfinite([r["loss"] for r in recs])),
              "every pipelined loss finite")
        return out, per_step, [r.sum(dim=1).tolist() for r in solves]

    keys = ("loss", "miss_pull", "update_push", "evict_push", "cost",
            "alg1_est")
    for codec in (None, "int8"):
        one, one_launch = TRAIN_DEPTH1[codec]
        extra = ["--pipeline-depth", "2"] + (["--codec", codec] if codec
                                             else [])
        out, per_step, rounds = run(extra)
        TRAIN_DEPTH2[codec] = out, per_step
        check([[r[k] for k in keys] for r in out["metrics"]]
              == [[r[k] for k in keys] for r in one["metrics"]],
              f"depth 2 (codec {codec}): every record bit for bit depth 1's")
        check(seed != 0 or rounds == TRAIN_ROUNDS[codec][:len(rounds)],
              f"depth 2 (codec {codec}): the auction's rounds equal the "
              f"CPU's")
        check(per_step == one_launch,
              f"depth 2 (codec {codec}): the launches a step equal depth "
              f"1's")
        print(f"[train-pipeline] codec {codec or 'none'}: wall ms a step, "
              f"depth 1 {one['wall_ms_mean']:.3f}, depth 2 "
              f"{out['wall_ms_mean']:.3f} (records, rounds and launches "
              f"equal)")

    out, per_step, _ = run(["--pipeline-depth", "2", "--stale-decide"])
    recs = out["metrics"]
    check(per_step.get("alg1_cost") == 2.0 and "pooled_lookup" not in
          per_step, "stale: one alg1_cost a step for decide and one for "
                    "the re-score, no B1")
    check(all("alg1_realized" in r for r in recs),
          "stale: every record has alg1_realized")
    check(math.isclose(recs[0]["alg1_realized"], recs[0]["alg1_est"],
                       rel_tol=1e-6),
          "stale: step 0 decides on the committed state (realized = est)")

    out, per_step, _ = run(AHEAD_ARGV)
    recs = out["metrics"]
    wire = row_wire_bytes(DLRM_CONFIGS[TRAIN_ARGV[1]].embedding_dim, None)
    check(per_step.get("staged_pull") == 1.0
          and "staged_gather" not in per_step,
          "the prefetch pull launched staged_pull once a step, in place")
    check(per_step.get("alg1_cost") == 3.0 and "pooled_lookup" not in
          per_step, "decide-ahead: one alg1_cost a step each for decide, "
                    "the repair and the re-score, no B1")
    check(all(r["prefetch_bytes"] > 0 for r in recs[1:]),
          "prefetch_bytes > 0 after step 0")
    check(all(r["demand_miss_bytes"] <= r["miss_pull"] * wire for r in recs),
          "demand misses never exceed misses")
    check(all("n_reassigned" in r and "alg1_realized" in r for r in recs),
          "n_reassigned and alg1_realized in every record")
    print(f"[train-pipeline] README configuration: prefetch_bytes "
          f"{[r['prefetch_bytes'] for r in recs]}, prefetch_hit_rate "
          f"{[r['prefetch_hit_rate'] for r in recs]}, n_reassigned "
          f"{[r['n_reassigned'] for r in recs]}, window_dedup_frac "
          f"{[r['window_dedup_frac'] for r in recs]}")
    return total


def phase_auction_kernels(seed: int) -> dict:
    """B7, the auction's bids, at Table 2's and the simulator's shapes."""
    from repro_torch.kernels import auction as A

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 13)
    rec = {}
    for k, n in ((256, 8), (8192, 8), (1024, 16), (64, 1)):
        cost = torch.as_tensor(rng.random((k, n), dtype=np.float32),
                               device=dev)
        # prices on a coarse grid, so that values tie inside rows
        price = torch.as_tensor(
            np.round(rng.random(n) * 4).astype(np.float32) / 8, device=dev)
        unassigned = torch.as_tensor(rng.random(k) < 0.5, device=dev)
        eps = torch.tensor([1.0 / (k + 1)], dtype=torch.float32, device=dev)
        best_j, bid = A.auction_bids(cost, price, unassigned, eps)
        ref_j, ref_bid = A.auction_bids_ref(cost, price, unassigned, eps[0])
        torch.cuda.synchronize()
        check(torch.equal(best_j, ref_j.to(torch.int32))
              and torch.equal(bid.view(torch.int32), ref_bid.view(torch.int32)),
              f"auction_bids k={k} n={n}: best_j and bid bitwise equal to "
              f"plain")
        err = float((bid - ref_bid).abs().max())
        ms, call_ms = device_ms(
            lambda: A.auction_bids(cost, price, unassigned, eps))
        plain_ms, _ = device_ms(
            lambda: A.auction_bids_ref(cost, price, unassigned, eps[0]))
        # cost and prices read, mask read, best_j and bid written; a
        # negate, a subtract and two compares per value
        b_ms, b_by = bound(k * n * 4 + n * 4 + k + 2 * k * 4, 4 * k * n)
        print(f"[kernel] auction_bids k={k} n={n} "
              f"unassigned={int(unassigned.sum())}: bitwise, {ms:.4f} ms "
              f"(call {call_ms:.4f}), plain {plain_ms:.4f} ms, library none,"
              f" bound {b_ms:.6f} ms ({b_by})")
        if (k, n) == (256, 8):
            rec["auction_bids"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by)
    rec["auction_solve"] = phase_solve_kernel(seed)
    return rec


def phase_solve_kernel(seed: int) -> dict:
    """B7's fused whole-solve kernel against its plain version on the
    card, bit for bit in assignment, slot prices, slot owners and rounds,
    at the training step's decide (4 auctions of 256 x 4, capacity 64,
    ``auction_fixed``'s nine phases), the benchmark cells' decide (8
    auctions of 128 x 8, capacity 16, nine phases; costs a worker's
    misses times its link's row time, 4 links at 5 Gbps and 4 at 0.5),
    the S1 simulator's decisions (256 x 8, capacity 32, exact grid,
    ``_solve``'s phases; and a price war of tied columns, its phases cut
    at 3,000 rounds) and Table 2's largest (8,192 x 8, capacity 1,024).
    Each case on both routes where the warp route takes its shape, bit
    for bit on each; its time a solve and a round (over the longest of
    the batch's auctions) on each, and a check that the route
    ``solve_route`` picks is not slower than the other (within 5 %);
    a bound from the bytes the rounds' bid passes read (each bidder's
    cost row, in every round it bids) plus the eps table and the outputs.
    At the cells' shape it also prints how many rows bid in each round
    of the longest auction (the plain version's rounds, counted)."""
    from repro_torch.core.auction import phase_eps
    from repro_torch.core.dispatch import _eps
    from repro_torch.kernels import auction as A

    def span(C):
        return float(np.float32(C.max()) - np.float32(C.min()))

    def fixed(C):
        spans = (C.max(axis=(1, 2)) - C.min(axis=(1, 2))).clip(1e-6)
        return torch.stack([_eps(torch.as_tensor(spans), min(p, 6))
                            for p in range(9)], dim=1)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 19)
    grid = np.round(rng.random((4, 256, 4)) * 4e3).astype(np.float32)
    decide = grid / np.float32(4e3) * np.float32(1e-3)
    s1 = np.round(rng.random((1, 256, 8)) * 10_000).astype(np.float32)
    war = np.round(rng.random((1, 256, 8)) * 10_000).astype(np.float32)
    war[:, :, 4:] = war[:, :, :4]                 # tied columns
    t2 = rng.random((1, 8192, 8)).astype(np.float32)
    row_s = np.float32(512 * 4 * 8) / np.array([5e9] * 4 + [5e8] * 4,
                                               np.float32)
    cells = rng.integers(0, 27, (8, 128, 8)).astype(np.float32) * row_s
    cases = (("cells", cells, 16, fixed(cells), 2000),
             ("decide", decide, 64, fixed(decide), 2000),
             ("s1", s1, 32, [phase_eps(span(s1), 1 / 257)], 200_000),
             ("s1-war", war, 32, [[1 / 257] * 2], 3000),
             ("table2", t2, 1024, [phase_eps(span(t2), span(t2) * 1e-3)],
              200_000))
    out, slow = {}, []
    for what, C, cap, eps, max_rounds in cases:
        cost = torch.as_tensor(C, device=dev)
        eps = torch.as_tensor(np.asarray(eps, np.float32), device=dev)
        B, k, n = C.shape
        picked = A.solve_route(k, n, cap)
        got = A.auction_solve(cost, cap, eps, max_rounds)
        # the plain version on the same card tensors, counting each
        # round's bidders
        bidders = []
        body = A._round_body

        def counted(c, e, state):
            bidders.append((state[0] < 0).sum(dim=1).tolist())
            return body(c, e, state)

        A._round_body = counted
        try:
            t = time.perf_counter()
            want = A.auction_solve_ref(cost, cap, eps, max_rounds)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
        finally:
            A._round_body = body
        n_bids = sum(map(sum, bidders))
        rounds = got[3].sum(dim=1)
        longest = int(rounds.max())
        n_bytes = (n_bids * n * 4 + eps.numel() * 4
                   + B * (k * 4 + 2 * n * cap * 4) + got[3].numel() * 4)
        b_ms, b_by = bound(n_bytes, 4 * n_bids * n)
        times = {}
        for route in ["block"] + (["warp"] if A.warp_fits(k, n, cap)
                                  else []):
            res = got if route == picked else A._launch_solve(
                cost, cap, eps, max_rounds, route)
            same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(res, want)]
            check(all(same), f"auction_solve {what} ({route}): "
                             f"assignment, slot prices, slot owners and "
                             f"rounds bitwise equal to plain ({same})")
            ms, call_ms = device_ms(
                lambda: A._launch_solve(cost, cap, eps, max_rounds, route),
                reps=10 if what in ("s1-war", "table2") else 30)
            times[route] = ms
            where = ("registers" if route == "warp" else
                     "shared memory" if A.solve_smem_bytes(k, n, cap, True)
                     <= A.SMEM_MAX else "L2")
            print(f"[kernel] auction_solve {what} B={B} k={k} n={n} c={cap}"
                  f" {route} route{' (picked)' if route == picked else ''}"
                  f" (cost in {where}): bitwise, rounds {rounds.tolist()} "
                  f"({n_bids} bids), {ms:.4f} ms a solve (call "
                  f"{call_ms:.4f}), {ms / max(longest, 1) * 1e3:.3f} us a "
                  f"round; plain {plain_ms:.1f} ms (one run, host clock), "
                  f"library none, bound {b_ms:.6f} ms ({b_by})")
        if times[picked] > 1.05 * min(times.values()):
            slow.append(f"{what}: {times}")
        if what == "cells":
            # bidders a round in the longest auction, by power-of-2 bins
            b = int(rounds.argmax())
            per = [r[b] for r in bidders if r[b] > 0]
            hist = {}
            for nb in per:
                top = 1 << (nb - 1).bit_length()
                key = str(top) if top <= 2 else f"{top // 2 + 1}-{top}"
                hist[key] = hist.get(key, 0) + 1
            print(f"[kernel] auction_solve cells: rows bidding a round in "
                  f"auction {b} ({len(per)} rounds): {hist}")
            out["cells"] = dict(ms=times[picked], route=picked,
                                us_round=times[picked] / longest * 1e3,
                                block_us_round=times["block"] / longest
                                * 1e3, bidders=hist)
        if what == "decide":
            out.update(max_abs_err=0.0, ms=times[picked], plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
    check(not slow, f"auction_solve: solve_route picks a route more than 5 % "
                    f"slower than the other at {slow}")
    return out


def phase_sim_parity(seed: int):
    """The simulator with the auction, and the serving simulator, on the
    card against the CPU: every field but wall-clock time equal; then
    each one's card solves again on both auction routes, timed."""
    from repro_torch.core.simulator import GBPS, SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import auction as A
    from repro_torch.serve import ServeKnobs, simulate_serve

    # 4 workers on distinct link speeds: a cold cache on two speed classes
    # starts a price war of about a million rounds, too long for the CPU
    base = dict(workload=WORKLOADS["tiny"], n_workers=4, batch_per_worker=8,
                iters=4, warmup=1, alpha=1.0, opt="auction", seed=seed,
                bandwidths=np.array([5.0, 2.0, 1.0, 0.5]) * GBPS)
    runs = {}
    sim_solves, serve_solves = [], []
    for dev in ("cuda", "cpu"):
        A.ROUNDS_LOG = []
        n0 = A.LAUNCHES["auction_solve"]
        try:
            with _recording_solves(sim_solves if dev == "cuda" else []):
                res = simulate(SimConfig(device=dev, **base))
        finally:
            log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        runs[dev] = (res, [int(r.sum()) for r in log],
                     A.LAUNCHES["auction_solve"] - n0)
    (card, card_rounds, launched), (cpu, cpu_rounds, _) = (runs["cuda"],
                                                           runs["cpu"])
    for f in ("per_iter_cost", "alg1_cost", "ingredient", "hit_ratio",
              "cost"):
        a, b = getattr(card, f), getattr(cpu, f)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        check(same, f"simulate(opt='auction') {f} equal on card and CPU")
    check(card_rounds == cpu_rounds and launched == len(card_rounds) > 0,
          "the card's simulate solved each decision in one auction_solve "
          "launch, in the CPU's rounds")
    print(f"[parity] simulate tiny, 4 workers x 8, opt auction, 4 "
          f"iterations, card vs CPU: per_iter_cost, alg1_cost, ingredient, "
          f"hit_ratio equal; cost {card.cost!r}; rounds a decision "
          f"{card_rounds} on both; {launched} auction_solve launches")
    knobs = ServeKnobs(qps=2000.0, duration_s=0.5)
    scfg = dict(workload=WORKLOADS["S1"], n_workers=8, opt="auction",
                seed=seed, serve=knobs)
    with _recording_solves(serve_solves):
        card = simulate_serve(SimConfig(device="cuda", **scfg))
    cpu = simulate_serve(SimConfig(device="cpu", **scfg))
    for f in ("p50_s", "p99_s", "mean_s", "slo_violation_rate", "n_requests",
              "n_batches", "pull_rows", "refresh_rows", "staleness_p99_s"):
        check(getattr(card, f) == getattr(cpu, f),
              f"simulate_serve {f} equal on card and CPU")
    check(np.array_equal(card.qps_per_worker, cpu.qps_per_worker),
          "simulate_serve qps_per_worker equal on card and CPU")
    print(f"[parity] simulate_serve S1, 8 workers, 2,000 QPS for 0.5 s, opt "
          f"auction, card vs CPU: all fields equal; p99 "
          f"{card.p99_s * 1e3:.4f} ms, {card.n_batches} batches")
    _route_times("simulate tiny", sim_solves)
    _route_times("simulate_serve S1", serve_solves)


class _recording_solves:
    """Within the block, every ``auction_solve`` on card tensors appends
    (cost, capacity, eps, max_rounds, its outputs) to ``into``."""

    def __init__(self, into: list):
        self.into = into

    def __enter__(self):
        from repro_torch.kernels import auction as A

        self.solve = solve = A.auction_solve

        def recorded(cost, capacity, eps, max_rounds):
            out = solve(cost, capacity, eps, max_rounds)
            if cost.is_cuda:
                self.into.append((cost, capacity, eps, max_rounds, out))
            return out

        A.auction_solve = recorded

    def __exit__(self, *exc):
        from repro_torch.kernels import auction as A

        A.auction_solve = self.solve


def _route_times(what: str, solves: list):
    """A caller's recorded solves again, by shape, on each route that
    takes the shape: bit for bit the recorded outputs; the device ms of
    the shape's solves in sequence and the us a round over the sum of each
    solve's longest auction; the route ``solve_route`` picks not slower
    than the other (within 5 %)."""
    from repro_torch.kernels import auction as A

    check(len(solves) > 0, f"{what}: recorded the card's solves")
    by_shape = {}
    for rec in solves:
        cost, cap = rec[0], rec[1]
        by_shape.setdefault((*cost.shape, cap), []).append(rec)
    slow = []
    for (B, k, n, cap), group in sorted(by_shape.items()):
        picked = A.solve_route(k, n, cap)
        rounds = sum(int(out[3].sum(dim=1).max()) for *_, out in group)
        times = {}
        for route in ["block"] + (["warp"] if A.warp_fits(k, n, cap)
                                  else []):
            for cost, c, eps, max_rounds, out in group:
                got = A._launch_solve(cost, c, eps, max_rounds, route)
                check(all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(got, out)),
                      f"{what}: the {route} route bit for bit the recorded "
                      f"solve")

            def run():
                for cost, c, eps, max_rounds, _ in group:
                    A._launch_solve(cost, c, eps, max_rounds, route)

            times[route], _ = device_ms(run, reps=5)
        print(f"[kernel] auction_solve {what}: {len(group)} solves of (B, k,"
              f" n, c) = {(B, k, n, cap)}, {picked} route picked, {rounds} "
              f"rounds; " + ", ".join(
                  f"{r} {t:.4f} ms ({t / max(rounds, 1) * 1e3:.3f} us a "
                  f"round)" for r, t in times.items()))
        if times[picked] > 1.05 * min(times.values()):
            slow.append((B, k, n, cap, times))
    check(not slow, f"{what}: solve_route picks a route more than 5 % "
                    f"slower than the other at {slow}")


# simulate() at S1 with ESD and the auction (phase 8's configuration,
# calibrated decisions, seed 0) on the CPU: scripts/auction_rounds.py
# --device cpu
S1_AUCTION_CPU = dict(rounds=1_045_650, cost=0.8131805183999999,
                      itps=23.408870950827136, hit_ratio=0.268820068282525)

# the paper's Table 2: CUDA-parallel Hungarian ms by samples per worker
PAPER_TABLE2_MS = {32: 21, 64: 28, 128: 82, 256: 186, 512: 811, 1024: 1385}


def phase_table2() -> dict:
    """Table 2's solver sweep: ``auction_dispatch(exact=False)`` on the
    draws of ``benchmarks/table2.py`` (``default_rng(0)``, 8 workers)."""
    from repro_torch.core.auction import auction_dispatch

    rng = np.random.default_rng(0)
    costs = {bpw: rng.random((8 * bpw, 8)) for bpw in PAPER_TABLE2_MS}
    # the CPU's answers first, outside the counted run
    refs = {bpw: auction_dispatch(c, bpw, exact=False, device="cpu",
                                  return_rounds=True)
            for bpw, c in costs.items()}
    _zero_launches()
    solves = 0
    recorded = []
    for bpw, cost in costs.items():
        before = _read_launches()["auction_solve"]
        with _recording_solves(recorded):
            assign, rounds = auction_dispatch(cost, bpw, exact=False,
                                              device="cuda",
                                              return_rounds=True)
        launched = _read_launches()["auction_solve"] - before
        check(launched == 1, f"table 2 bpw {bpw}: one auction_solve launch "
                             f"a decision ({launched})")
        ref, ref_rounds = refs[bpw]
        check(np.array_equal(assign, ref) and rounds == ref_rounds,
              f"table 2 bpw {bpw}: assignment and rounds equal on card and "
              f"CPU")
        check(bool((np.bincount(assign, minlength=8) == bpw).all()),
              f"table 2 bpw {bpw}: every worker takes its {bpw} samples")
        times = []
        for _ in range(3):
            t = time.perf_counter()
            auction_dispatch(cost, bpw, exact=False, device="cuda")
            times.append((time.perf_counter() - t) * 1e3)
        solves += 4
        print(f"[table2] bpw {bpw} (k = {8 * bpw}, n = 8): {rounds} rounds, "
              f"{statistics.median(times):.3f} ms per decision (median of "
              f"3 after a warm call, host clock; "
              f"{statistics.median(times) / rounds * 1e3:.3f} us a round), "
              f"{launched} auction_solve launch; paper's CUDA Hungarian "
              f"{PAPER_TABLE2_MS[bpw]} ms")
    launches = {k: v for k, v in _read_launches().items() if v}
    check(launches == {"auction_solve": solves},
          "table 2: one auction_solve launch a decision, nothing else")
    _route_times("table2 sweep", recorded)
    return launches


def phase_simulate(seed: int) -> dict:
    """The paper's simulator at S1 on the card, each mechanism in turn.
    ESD with the auction runs the calibrated decision model, so that its
    cost, ItpS and hit ratio do not hold the host's wall time and equal
    the CPU's (``S1_AUCTION_CPU``) at seed 0; the others measure their
    decisions."""
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import auction as A
    from repro_torch.serve import ServeKnobs, simulate_serve

    base = dict(workload=WORKLOADS["S1"], n_workers=8, batch_per_worker=32,
                cache_ratio=0.08, embedding_dim=512, iters=8, warmup=2,
                seed=seed, decision_model="measured", device="cuda")
    launches: dict = {}
    costs = {}
    for name, kw in (("esd-auction", dict(mechanism="esd", opt="auction",
                                          decision_model="calibrated")),
                     ("esd-ssp", dict(mechanism="esd", opt="ssp")),
                     ("laia", dict(mechanism="laia")),
                     ("het", dict(mechanism="het")),
                     ("fae", dict(mechanism="fae")),
                     ("random", dict(mechanism="random"))):
        A.ROUNDS_LOG = []
        _zero_launches()
        t = time.perf_counter()
        try:
            res = simulate(SimConfig(**{**base, **kw}))
        finally:
            wall = time.perf_counter() - t
            run = {k: v for k, v in _read_launches().items() if v}
            log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        rounds = [int(r.sum()) for r in log]
        solves = run.get("auction_solve", 0)
        check(bool(np.isfinite(res.per_iter_cost).all())
              and len(res.per_iter_cost) == 6 and 0 <= res.hit_ratio <= 1,
              f"simulate {name}: six finite iteration costs, hit ratio in "
              f"[0, 1]")
        check(solves == len(rounds) and (solves > 0) == (name == "esd-auction")
              and "auction_bids" not in run,
              f"simulate {name}: the auction runs only for ESD with the "
              f"auction, one auction_solve launch a decision")
        if name == "esd-auction" and seed == 0:
            got = dict(rounds=sum(rounds), cost=res.cost, itps=res.itps,
                       hit_ratio=res.hit_ratio)
            check(got == S1_AUCTION_CPU, f"simulate esd-auction: rounds, "
                  f"cost, ItpS and hit ratio equal the CPU's ({got} against"
                  f" {S1_AUCTION_CPU})")
        costs[name] = res.cost
        extra = (f", auction_solve launches {solves}, rounds {sum(rounds)} "
                 f"{rounds} ({wall / max(sum(rounds), 1) * 1e6:.3f} us a "
                 f"round of the wall)" if solves else "")
        print(f"[simulate] S1 {name}: cost {res.cost!r} s, itps "
              f"{res.itps!r}, hit ratio {res.hit_ratio!r}, decision "
              f"{res.decision_time_mean * 1e3:.3f} ms (mean of iterations "
              f"2-7{', calibrated' if solves else ''}){extra}, wall "
              f"{wall:.1f} s")
    check(costs["esd-auction"] < costs["random"],
          "ESD with the auction moves less than random dispatch")
    A.ROUNDS_LOG = []
    _zero_launches()
    try:
        res = simulate_serve(SimConfig(
            workload=WORKLOADS["S1"], n_workers=8, opt="auction", seed=seed,
            device="cuda", serve=ServeKnobs(qps=2000.0, duration_s=0.5)))
    finally:
        run = {k: v for k, v in _read_launches().items() if v}
        log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v
    solves = run.get("auction_solve", 0)
    check(solves == len(log) > 0 and res.n_requests > 0
          and np.isfinite(res.p99_s),
          "simulate_serve with the auction served the stream, one "
          "auction_solve launch a decision")
    print(f"[simulate] serve S1, 8 workers, 2,000 QPS for 0.5 s, opt "
          f"auction: p50 {res.p50_s * 1e3:.4f} ms, p99 "
          f"{res.p99_s * 1e3:.4f} ms, slo_violation_rate "
          f"{res.slo_violation_rate:.4f}, {res.n_requests} requests in "
          f"{res.n_batches} batches, auction_solve launches {solves}, "
          f"rounds {sum(int(r.sum()) for r in log)}")
    return launches


def _was_forward(lib, q, k, v, causal):
    """(out, lse) from the f32 forward kernel of another checkout's
    ``flash_attn`` library (``--was DIR``: the CUDA-core kernel that the
    split-TF32 route replaced), called as that checkout's wrapper calls
    it."""
    B, Sq, KV, G, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, k.shape[1], KV, G, hd, int(causal),
        *q.stride(), *k.stride(), *v.stride(),
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the --was forward kernel launched (cudaError {rc})")
    return out, lse


def _was_backward(lib, q, k, v, out, lse, dout, causal):
    """(dq, dk, dv) from the f32 backward kernel of another checkout's
    ``flash_attn_bwd`` library (``--was DIR``: the CUDA-core kernel that
    the split-TF32 route replaced, D's scratch beside it), called as that
    checkout's wrapper calls it on contiguous inputs."""
    B, Sq, KV, G, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], KV, G, hd,
        int(causal), *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:4], torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"the --was backward kernel launched (cudaError {rc})")
    return dq, dk, dv


# B8's shapes in phase 3, each timed in bf16 and in f32: the LM path's
# (smollm-360m, also phase 11's prefill), non-causal, hd 128 at B 2,
# phi3.5-moe's and pixtral-12b's training shape, pixtral's prefill, hd 32
FLASH_SHAPES = [(4, 2048, 5, 3, 64, True), (2, 1024, 5, 3, 64, False),
                (2, 2048, 2, 4, 128, True), (1, 2048, 8, 4, 128, True),
                (4, 2048, 8, 4, 128, True), (2, 2048, 4, 2, 32, True)]
FLASH_BWD_SHAPES = FLASH_SHAPES[:4]
# B8's time at the LM shape by dtype, for phase 11's share of the prefill
FLASH_LM_MS: dict = {}


def phase_flash_kernels(seed: int, was_libs=None) -> dict:
    """B8, the flash attention, and its backward kernel, at the LM path's
    shape and around it, in bf16 and in f32; with ``was_libs`` (``--was
    DIR``'s ``flash_attn`` and ``flash_attn_bwd``) the f32 kernels these
    replace, timed beside them on the same inputs."""
    from repro_torch.kernels import flash_attn as FA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    rec = {}

    def qkv(B, S, KV, G, hd, dtype):
        return (torch.randn((B, S, KV, G, hd), generator=g,
                            device=dev).to(dtype),
                torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype),
                torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype))

    def sdpa(q, k, v, causal):
        """The library yardstick on the (B, H, S, hd) layout it takes,
        back in B8's layout."""
        B, S, KV, G, hd = q.shape
        out = torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, S, KV * G, hd).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=causal, enable_gqa=True)
        return out.transpose(1, 2).reshape(B, S, KV, G, hd)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def pairs(B, S, KV, G, causal):
        return B * KV * G * (S * (S + 1) // 2 if causal else S * S)

    def bounds(n_bytes, n_ops, bf16):
        """(bound ms, bound_by, its text): bf16 at 989 TFLOP/s; f32 at
        495 TFLOP/s of TF32 over three products (the card's least time
        for f32-accurate products), beside 67 TFLOP/s on the CUDA cores"""
        if bf16:
            b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
            return b_ms, b_by, f"bound {b_ms:.6f} ms ({b_by})"
        b_ms, b_by = bound(n_bytes, n_ops, TF32X3_FLOPS_PER_S)
        c_ms, c_by = bound(n_bytes, n_ops, F32_FLOPS_PER_S)
        return b_ms, b_by, (f"bound {b_ms:.6f} ms ({b_by}, 3xTF32 at "
                            f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; "
                            f"{c_ms:.6f} ms on the CUDA cores, {c_by})")

    for (B, S, KV, G, hd, causal), dtype in itertools.product(
            FLASH_SHAPES, (torch.bfloat16, torch.float32)):
        q, k, v = qkv(B, S, KV, G, hd, dtype)
        out, lse = FA.flash_attention(q, k, v, causal)
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        e, lse_err = err(out, ref), err(lse, ref_lse)
        what = (f"B={B} S={S} KV={KV} G={G} hd={hd} "
                f"{'causal' if causal else 'full'} "
                f"{'bf16' if bf16 else 'f32'}")
        if bf16:
            # P rounded to bf16 for the tensor cores, as SDPA does: 1e-2,
            # or up to 2e-2 within 1.5x SDPA's error on the same inputs
            sdpa_err = err(sdpa(q, k, v, causal), ref)
            ok = e <= 1e-2 or (e <= 2e-2 and e <= 1.5 * sdpa_err)
            tol = (f"1e-2, or 2e-2 and 1.5x SDPA's {sdpa_err:.3g}")
        else:
            ok, tol = e <= 2e-5, "2e-5"
        check(ok and lse_err <= 2e-5 and out.dtype == dtype,
              f"flash_attention {what}: out within {tol} (max err {e}), "
              f"lse within 2e-5 (max err {lse_err}) of plain")
        ms, call_ms = device_ms(lambda: FA.flash_attention(q, k, v, causal))
        was = ""
        if was_libs is not None and not bf16:
            w_out, w_lse = _was_forward(was_libs[0], q, k, v, causal)
            was_ms, was_call = device_ms(lambda: _was_forward(
                was_libs[0], q, k, v, causal))
            # the new kernel again after the old one, in turns
            ms2, _ = device_ms(lambda: FA.flash_attention(q, k, v, causal))
            was = (f", then {ms2:.4f} ms; was {was_ms:.4f} ms (call "
                   f"{was_call:.4f}; max err {err(w_out, ref):.3g}, lse "
                   f"{err(w_lse, ref_lse):.3g})")
        plain_ms, _ = device_ms(
            lambda: FA.flash_attention_ref(q, k, v, causal), reps=10)
        qs = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms, _ = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True))
        # 4 hd operations per visible (query row, key) pair; q, k, v read
        # once, out and lse written once
        n_ops = 4 * hd * pairs(B, S, KV, G, causal)
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by, b_text = bounds(n_bytes, n_ops, bf16)
        route = FA.kernel_route((dtype,) * 3, hd)
        print(f"[kernel] flash_attention {what} ({route}): max err {e:.3g} "
              f"(lse {lse_err:.3g}; tolerance {tol}), {ms:.4f} ms (call "
              f"{call_ms:.4f}), {n_ops / ms / 1e9:.2f} TFLOP/s{was}, "
              f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{lib_ms:.4f} ms, {b_text}")
        if (B, S, hd, causal) == (4, 2048, 64, True):
            FLASH_LM_MS[dtype] = ms
            rec["flash_attention" if bf16 else "flash_attention_f32"] = dict(
                max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)
        del q, k, v, qs, ks, vs, out, ref

    # the backward kernel against the plain backward, and SDPA's backward
    for (B, S, KV, G, hd, causal), dtype in itertools.product(
            FLASH_BWD_SHAPES, (torch.bfloat16, torch.float32)):
        q, k, v = qkv(B, S, KV, G, hd, dtype)
        out, lse = FA.flash_attention(q, k, v, causal)
        dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        got = FA.flash_attention_backward(q, k, v, out, lse, dout, causal)
        again = FA.flash_attention_backward(q, k, v, out, lse, dout, causal)
        # the plain backward in f32 on the same values (for bf16, so that
        # neither error below is a count of output ulps)
        want = FA.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(), causal)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs = [err(a, b) for a, b in zip(got, want)]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        so = sdpa(*leaves, causal)
        sg = torch.autograd.grad(so, leaves, dout, retain_graph=True)
        sdpa_errs = [err(a, b) for a, b in zip(sg, want)]
        mean_ratio = [float((a.float() - w).abs().mean()
                            / (b.float() - w).abs().mean())
                      for a, b, w in zip(got, sg, want)]
        what = (f"B={B} S={S} KV={KV} G={G} hd={hd} "
                f"{'causal' if causal else 'full'} "
                f"{'bf16' if bf16 else 'f32'}")
        for name, e, se, a in zip(("dq", "dk", "dv"), errs, sdpa_errs, got):
            # bf16: P and dS rounded to bf16 for the tensor cores, as in
            # SDPA's backward
            check(a.dtype == dtype and (e <= 1.5 * se if bf16 else e <= 1e-4),
                  f"flash_attention_bwd {what}: {name} max err {e} within "
                  f"{'1.5x SDPA backward' + repr(se) if bf16 else '1e-4'}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {what}: two calls bitwise equal")
        route = FA.backward_route((dtype,) * 3, hd, [
            (t.shape, t.stride(), t.data_ptr()) for t in (q, k, v, dout)])[0]
        ms, call_ms = device_ms(lambda: FA.flash_attention_backward(
            q, k, v, out, lse, dout, causal))
        was = ""
        if was_libs is not None and not bf16:
            was_errs = [err(a, b) for a, b in zip(_was_backward(
                was_libs[1], q, k, v, out, lse, dout, causal), want)]
            was_ms, was_call = device_ms(lambda: _was_backward(
                was_libs[1], q, k, v, out, lse, dout, causal))
            # the new kernel again after the old one, in turns
            ms2, _ = device_ms(lambda: FA.flash_attention_backward(
                q, k, v, out, lse, dout, causal))
            was = (f", then {ms2:.4f} ms; was {was_ms:.4f} ms (call "
                   f"{was_call:.4f}; max err dq, dk, dv "
                   f"{[float(f'{x:.3g}') for x in was_errs]})")
        plain_ms, _ = device_ms(lambda: FA.flash_attention_bwd(
            q, k, v, out, lse, dout, causal), reps=5)
        # SDPA's backward alone, on the (B, H, S, hd) layout it takes
        hs = [t.detach().contiguous().requires_grad_() for t in (
            q.reshape(B, S, KV * G, hd).transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2))]
        hout = torch.nn.functional.scaled_dot_product_attention(
            *hs, is_causal=causal, enable_gqa=True)
        hdout = dout.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
        lib_ms, _ = device_ms(lambda: torch.autograd.grad(
            hout, hs, hdout, retain_graph=True), reps=20)
        # 10 hd operations per visible pair (five products); q, k, v, out,
        # dout and lse read once, dq, dk, dv written once
        n_ops = 10 * hd * pairs(B, S, KV, G, causal)
        n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by, b_text = bounds(n_bytes, n_ops, bf16)
        print(f"[kernel] flash_attention_bwd {what} ({route}): max err dq, "
              f"dk, dv {[float(f'{x:.3g}') for x in errs]} (SDPA's backward "
              f"{[float(f'{x:.3g}') for x in sdpa_errs]}; mean error "
              f"over SDPA's {[round(x, 3) for x in mean_ratio]}; two calls "
              f"bitwise equal), {ms:.4f} ms (call {call_ms:.4f}), "
              f"{n_ops / ms / 1e9:.2f} TFLOP/s{was}, plain {plain_ms:.4f} "
              f"ms, SDPA's backward {lib_ms:.4f} ms, {b_text}")
        if (B, S, hd, causal) == (4, 2048, 64, True):
            rec["flash_attention_bwd" if bf16
                else "flash_attention_bwd_f32"] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, dout, got, again, want, leaves, so, sg, hs, hout

    # gradients through the autograd Function (f32: the tf32x3 forward and
    # backward kernels) against autograd of the plain version
    worst = 0.0
    for causal in (True, False):
        leaves = [t.float() for t in qkv(2, 640, 5, 3, 64, torch.float32)]
        w = torch.randn(leaves[0].shape, generator=g, device=dev)
        grads = []
        for fn in (lambda *a: FA.flash_attn(*a, causal),
                   lambda *a: FA.flash_attention_ref(*a, causal)[0]):
            ts = [t.clone().requires_grad_() for t in leaves]
            grads.append(torch.autograd.grad((fn(*ts) * w).sum(), ts))
        for a, b in zip(*grads):
            e = float((a - b).abs().max())
            check(e <= 1e-4, f"flash_attn gradient (causal {causal}) "
                             f"within 1e-4 of plain (max err {e})")
            worst = max(worst, e)
    print(f"[kernel] flash_attn gradients, B=2 S=640 KV=5 G=3 hd=64 f32, "
          f"causal and full: max abs err {worst:.3g} against autograd of "
          f"the plain version (tolerance 1e-4)")
    return rec


def phase_lm_parity(seed: int):
    """3 steps of ``run_lm`` at smollm-360m's smoke config with S = 2,048
    (every layer on the flash route) on the card and on the CPU from the
    same weights: in f32, losses within 1e-4 (f32 sums in another order,
    and Adam at lr 1e-2 turns a rounding difference of a gradient near 0
    into a step of up to lr); in bf16 (the card's wgmma forward and
    tensor-core backward against the CPU's plain versions, which keep P
    and dS in f32), losses within 5e-2 (bf16 keeps 8 bits: activations
    and P rounded at other places move the loss of about 7 by up to a few
    of its 2**-5 ulps at this magnitude, and Adam turns gradient
    differences near 0 into steps of up to lr)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models import api

    argv = ["--arch", "smollm-360m", "--smoke", "--seq-len", "2048",
            "--batch-per-worker", "1", "--steps", "3", "--seed", str(seed)]
    base = get_config("smollm-360m", smoke=True)
    for cfg, tol in ((base, 1e-4),
                     (dataclasses.replace(base, dtype="bfloat16"), 5e-2)):
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            n0, r0 = dict(FA.LAUNCHES), _routes()
            out = run_lm(build_parser().parse_args(argv + ["--device", dev]),
                         model=model, cfg=cfg)
            runs[dev] = [r["loss"] for r in out["metrics"]]
            ran = {k: FA.LAUNCHES[k] - n0[k] for k in n0}
        err = max(abs(a - b) for a, b in zip(runs["cpu"], runs["cuda"]))
        check(all(np.isfinite(runs["cuda"])) and err <= tol,
              f"LM losses ({cfg.dtype}) on card vs CPU within {tol} (max "
              f"err {err})")
        check(ran == {k: cfg.n_layers * 3 for k in ran},
              f"the card's {cfg.dtype} LM steps ran B8's forward and "
              f"backward kernels once per layer and step ({ran})")
        route = "wgmma" if cfg.dtype == "bfloat16" else "tf32x3"
        on_route = _check_routes(r0, route, f"the card's {cfg.dtype} LM "
                                            f"steps")
        print(f"[parity] 3 LM steps, smollm-360m smoke (2 layers, d 256, 4 "
              f"heads over 2, {cfg.dtype}), B 1, S 2048, card vs CPU: "
              f"losses {runs['cuda']} vs {runs['cpu']}, max abs err "
              f"{err:.3g} (tolerance {tol}); card kernel launches {ran}, "
              f"forward and backward on the {route} route: {on_route}")


def phase_lm_decode_parity(seed: int):
    """The LM serving path and MoE on the card against the CPU from the
    same f32 smoke weights: 8 decode steps of smollm-360m and
    phi3.5-moe (logits within 1e-5: f32 sums in another order), and 3
    ``run_lm`` steps of phi3.5-moe at S = 2,048 (the flash route, then
    the experts; losses within phase 4's 1e-4), with one dispatch block
    and with ``MOE_BLOCKS = 2``."""
    from repro_torch.configs import get_config
    from repro_torch.dist import ctx
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models import api

    for arch in ("smollm-360m", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch, smoke=True)
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (4, 8)))
        step = make_serve_step(cfg)
        caches = [api.init_decode_cache(cfg, 4, 8, d) for d in ("cpu",
                                                                "cuda")]
        err = 0.0
        for pos in range(8):
            a, caches[0] = step(cpu, caches[0], toks[:, pos:pos + 1], pos)
            b, caches[1] = step(gpu, caches[1], toks[:, pos:pos + 1].cuda(),
                                pos)
            err = max(err, float((b.cpu() - a).abs().max()))
        check(err <= 1e-5, f"{arch} smoke decode on card vs CPU within "
                           f"1e-5 (max err {err})")
        print(f"[parity] 8 decode steps, {cfg.name} (f32), B 4, card vs "
              f"CPU: logits max abs err {err:.3g} (tolerance 1e-5)")

    arch = "phi3.5-moe-42b-a6.6b"
    cfg = get_config(arch, smoke=True)
    argv = ["--arch", arch, "--smoke", "--seq-len", "2048",
            "--batch-per-worker", "1", "--steps", "3", "--seed", str(seed)]
    # one dispatch block, then MOE_BLOCKS = 2 (each half of the tokens
    # dispatched with its own capacity)
    for nb in (1, 2):
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        runs = {}
        ctx.MOE_BLOCKS = nb
        try:
            for dev, model in (("cpu", cpu), ("cuda", gpu)):
                n0, r0 = dict(FA.LAUNCHES), _routes()
                out = run_lm(build_parser().parse_args(
                    argv + ["--device", dev]), model=model)
                runs[dev] = [r["loss"] for r in out["metrics"]]
                ran = {k: FA.LAUNCHES[k] - n0[k] for k in n0}
        finally:
            ctx.MOE_BLOCKS = 1
        err = max(abs(a - b) for a, b in zip(runs["cpu"], runs["cuda"]))
        check(all(np.isfinite(runs["cuda"])) and err <= 1e-4,
              f"phi3.5-moe smoke losses (MOE_BLOCKS {nb}) on card vs CPU "
              f"within 1e-4 (max err {err})")
        check(ran == {k: cfg.n_layers * 3 for k in ran},
              f"the card's phi3.5-moe smoke steps ran B8's forward and "
              f"backward once per layer and step ({ran})")
        on_route = _check_routes(r0, "tf32x3", "the card's phi3.5-moe "
                                               "smoke steps")
        print(f"[parity] 3 LM steps, {cfg.name} (2 layers, d 256, 4 experts "
              f"top-2, f32), B 1, S 2048, MOE_BLOCKS {nb}, card vs CPU: "
              f"losses {runs['cuda']} vs {runs['cpu']}, max abs err "
              f"{err:.3g} (tolerance 1e-4); card kernel launches {ran}, "
              f"forward and backward on the tf32x3 route: {on_route}")


def phase_lm_train(seed: int) -> dict:
    """``run_lm`` at smollm-360m's full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_parser, run_lm

    args = build_parser().parse_args(LM_ARGV + ["--seed", str(seed)])
    cfg = get_config(args.arch)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = run_lm(args)
    launches = {k: v for k, v in _read_launches().items() if v}
    recs = out["metrics"]
    losses = [r["loss"] for r in recs]
    print(f"[lm-train] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), B {out['batch']}, S {out['seq_len']}, "
          f"{len(recs)} steps: {out['step_ms_mean']:.3f} ms per step (mean "
          f"of steps 1..), {out['tokens_per_s']:.1f} tokens/s; losses "
          f"{losses}; step s {[r['wall_s'] for r in recs]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    check(all(np.isfinite(losses)), "every LM loss finite")
    check(launches.get("flash_attention") == cfg.n_layers * len(recs),
          "the flash kernel launched once per layer and step")
    check(launches.get("flash_attention_bwd") == cfg.n_layers * len(recs),
          "the flash backward kernel launched once per layer and step")
    _check_bwd_wgmma(cfg.n_layers * len(recs), "LM training")

    # f32 (B8's tf32x3 route): full width, depth cut to LM_F32_LAYERS
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=LM_F32_LAYERS)
    args32 = build_parser().parse_args(
        LM_ARGV[:-4] + ["--steps", "3", "--device", "cuda", "--seed",
                        str(seed)])
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    before = _routes()
    out = run_lm(args32, cfg=cfg32)
    fwd, bwd = _check_routes(before, "tf32x3", "f32 LM training")
    recs = out["metrics"]
    losses = [r["loss"] for r in recs]
    n = cfg32.n_layers * len(recs)
    check(all(np.isfinite(losses)) and fwd == bwd == n,
          f"f32 LM training: finite losses, B8 and its backward once a "
          f"layer and step on the tf32x3 route ({fwd}, {bwd})")
    print(f"[lm-train] {cfg.name} in f32 at full width, {cfg32.n_layers} of "
          f"{cfg.n_layers} layers, B {out['batch']}, S {out['seq_len']}, "
          f"{len(recs)} steps: {out['step_ms_mean']:.3f} ms per step (mean "
          f"of steps 1..), {out['tokens_per_s']:.1f} tokens/s; losses "
          f"{losses}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; B8 on the "
          f"tf32x3 route: {fwd} forward, {bwd} backward launches")
    launches["flash_attention_f32"] = fwd
    launches["flash_attention_bwd_f32"] = bwd
    return launches


# phase 9's f32 run: smollm-360m at full width, 8 of its 32 layers
LM_F32_LAYERS = 8


# the LM serving path: smollm-360m at full width and depth
SERVE_B, SERVE_S, SERVE_PROMPT, SERVE_GEN = 4, 2048, 256, 256
# f32 decode against f32 prefill at positions 0..255: 32 layers of f32
# sums over up to 2,560 terms in other orders (the prefill's GEMMs and
# B8's online softmax against decode's GEMVs and a plain softmax) leave
# errors near 1e-5 on logits of magnitude ~1; 1e-3 keeps a wide margin
# and is 20x tighter than the reference's own check (2e-2)
SERVE_F32_TOL = 1e-3


def _decode_example():
    import runpy

    return runpy.run_path(str(ROOT / "examples" /
                              "serve_llm_decode_torch.py"))


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def phase_lm_serve(seed: int) -> dict:
    """smollm-360m at full width and depth (32 layers, d 960, bf16, tied
    head): a prefill of B 4 x S 2,048 through ``make_prefill_step`` (one
    B8 launch a layer), then the decode example's loop at B 4, its
    prompt the prefill batch's first 256 tokens, teacher-forced, and 256
    greedy tokens into a cache of 512 slots; then the same prefill and
    prompt in f32, the decode logits at positions 0..255 against the
    prefill's within ``SERVE_F32_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api

    dev = torch.device("cuda")
    ex = _decode_example()
    args = ex["build_parser"]().parse_args(
        ["--arch", "smollm-360m", "--batch", str(SERVE_B), "--prompt-len",
         str(SERVE_PROMPT), "--gen-len", str(SERVE_GEN), "--device", "cuda"])
    cfg = get_config("smollm-360m")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_B, SERVE_S)), device=dev)
    model = api.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times = []
    for _ in range(4):
        t = time.perf_counter()
        logits = prefill(model, {"tokens": toks})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        del logits
    prefill_peak = _peak_gib()
    out = ex["run"](args, cfg=cfg, model=model,
                    prompts=toks[:, :SERVE_PROMPT].cpu().numpy())
    launches = {k: v for k, v in _read_launches().items() if v}
    check(launches == {"flash_attention": 4 * cfg.n_layers},
          f"4 prefills launched B8 once a layer each and decode launched "
          f"no kernel ({launches})")
    seq = out["sequences"]
    check(seq.shape == (SERVE_B, SERVE_PROMPT + SERVE_GEN) and bool(
        (seq[:, :SERVE_PROMPT] == toks[:, :SERVE_PROMPT].cpu().numpy())
        .all()) and bool(((seq >= 0) & (seq < cfg.vocab)).all()),
          "decode kept the prompt and emitted tokens of the vocabulary")
    print(f"[lm-serve] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, vocab {cfg.vocab}, "
          f"{cfg.dtype}): prefill B {SERVE_B} x S {SERVE_S} {times[0]:.3f} "
          f"ms first, {statistics.median(times[1:]):.3f} ms (median of 3 "
          f"after), peak {prefill_peak:.2f} GiB; decode B {SERVE_B}, prompt "
          f"{SERVE_PROMPT} + {SERVE_GEN} greedy into {out['steps'] + 1} "
          f"slots, {out['steps']} steps: p50 {out['step_p50_ms']:.3f} ms, "
          f"p99 {out['step_p99_ms']:.3f} ms a step, {out['tok_per_s']:.1f} "
          f"tok/s; peak {_peak_gib():.2f} GiB; launches {launches}")
    del model

    # f32: the decode logits at the prompt's positions against the prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = api.init_model(cfg32, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    prefill32 = make_prefill_step(cfg32)
    before = _routes()
    ms32, logits = _timed_calls(lambda: prefill32(model, {"tokens": toks}),
                                3)
    want = logits[:, :SERVE_PROMPT].clone()
    del logits
    got = torch.empty_like(want)

    def keep(pos, logits):
        got[:, pos] = logits[:, 0]

    args32 = ex["build_parser"]().parse_args(
        ["--batch", str(SERVE_B), "--prompt-len", str(SERVE_PROMPT),
         "--gen-len", "1", "--device", "cuda"])
    ex["run"](args32, cfg=cfg32, model=model,
              prompts=toks[:, :SERVE_PROMPT].cpu().numpy(), on_logits=keep)
    err = float((got - want).abs().max())
    check(err <= SERVE_F32_TOL, f"f32 decode logits at positions 0..255 "
                                f"within {SERVE_F32_TOL} of the prefill's "
                                f"(max err {err})")
    fwd, bwd = _check_routes(before, "tf32x3", "the f32 prefills and decode")
    check(fwd == 3 * cfg.n_layers and bwd == 0,
          f"3 f32 prefills launched B8 once a layer each, decode none "
          f"({fwd}, {bwd})")
    lm_ms = FLASH_LM_MS.get(torch.float32)
    share = (f"{cfg.n_layers} x {lm_ms:.4f} = {cfg.n_layers * lm_ms:.3f} ms "
             f"of B8 a prefill at phase 3's time" if lm_ms else
             "phase 3 not run")
    print(f"[lm-serve] f32: prefill B {SERVE_B} x S {SERVE_S} "
          f"{ms32[0]:.3f} ms first, {statistics.median(ms32[1:]):.3f} ms "
          f"(median of 2 after), B8 on the tf32x3 route {fwd} launches "
          f"({share}); decode logits at positions 0..{SERVE_PROMPT - 1} "
          f"against the prefill's [:, :{SERVE_PROMPT}]: max abs err "
          f"{err:.3g} (tolerance {SERVE_F32_TOL}; |logits| up to "
          f"{float(want.abs().max()):.3g})")
    launches["flash_attention_f32"] = fwd
    return launches


# phi3.5-moe at full width, depth cut to 2 layers (about 2.9 B parameters)
MOE_LAYERS = 2


def phase_lm_moe(seed: int) -> dict:
    """phi3.5-moe at full width (d 4,096, 32 heads over 8, hd 128, 16
    experts top-2, d_ff 6,400, vocab 32,064, bf16), 2 layers: 3 steps of
    ``run_lm`` at B 1, S 2,048 (B8 and its backward at hd 128, once a
    layer and step each), then the decode example at B 4, prompt 64,
    64 greedy tokens; finite losses and a nonzero router aux loss."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models import api, backbone

    dev = torch.device("cuda")
    arch = "phi3.5-moe-42b-a6.6b"
    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS)
    model = api.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    args = build_parser().parse_args(
        ["--arch", arch, "--seq-len", "2048", "--batch-per-worker", "1",
         "--steps", "3", "--seed", str(seed), "--device", "cuda"])
    ex = _decode_example()
    dargs = ex["build_parser"]().parse_args(
        ["--arch", arch, "--batch", "4", "--prompt-len", "64", "--gen-len",
         "64", "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = run_lm(args, model=model, cfg=cfg)
    train_peak = _peak_gib()
    torch.cuda.reset_peak_memory_stats()
    dec = ex["run"](dargs, cfg=cfg, model=model)
    launches = {k: v for k, v in _read_launches().items() if v}
    losses = [r["loss"] for r in out["metrics"]]
    with torch.no_grad():
        tok = torch.as_tensor(dec["sequences"], device=dev)
        _, aux = backbone.forward(model, cfg, tok)
    aux = aux.item()
    print(f"[lm-moe] {cfg.name} at full width, {cfg.n_layers} layers "
          f"({n_params / 1e9:.3f} B parameters, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, {cfg.dtype}), B 1, S 2048, 3 steps: "
          f"{out['step_ms_mean']:.3f} ms per step (mean of steps 1..), "
          f"{out['tokens_per_s']:.1f} tokens/s; losses {losses}; step s "
          f"{[r['wall_s'] for r in out['metrics']]}; peak memory "
          f"{train_peak:.2f} GiB; decode B 4, prompt 64 + 64: p50 "
          f"{dec['step_p50_ms']:.3f} ms, p99 {dec['step_p99_ms']:.3f} ms a "
          f"step, {dec['tok_per_s']:.1f} tok/s, peak {_peak_gib():.2f} GiB; "
          f"router aux on the decoded tokens {aux:.4f}; launches {launches}")
    check(all(np.isfinite(losses)), "every phi3.5-moe loss finite")
    check(np.isfinite(aux) and aux > 0, "the router's aux loss is nonzero")
    n = cfg.n_layers * len(losses)
    check(launches == {"flash_attention": n, "flash_attention_bwd": n},
          f"B8 and its backward once a layer and step, none in decode "
          f"({launches})")
    _check_bwd_wgmma(n, "phi3.5-moe training")
    return launches


# phase 13's plan: a straggler, a graceful crash, a droop and a warm
# rejoin; at most one worker down, so cap 86, budget 128, out_rows 512
ELASTIC_PLAN = "straggle@1:0x4-8; crash@3:1g; bw@4:2x0.25-10; rejoin@7:1w"
ELASTIC_ARGV = ["--steps", "12", "--fault-plan", ELASTIC_PLAN]
ELASTIC_KEYS = ("loss", "miss_pull", "update_push", "evict_push", "cost",
                "alg1_est", "n_active")
# the tiny elastic runs of phase 4: one step down (a dead worker's penalty
# column starts price wars of thousands of rounds on the CPU's auction)
TINY_PLAN = "straggle@1:0x4-3; crash@2:1g; bw@3:2x0.25-5; rejoin@3:1w"


def phase_elastic_parity(seed: int):
    """``run_dlrm --fault-plan`` at wdl-tiny (4 workers x 8, 6 steps) on
    the card and on the CPU from the same weights, at depth 1 (exact and
    ``--codec int8``) and depth 2: integer fields (cache counts,
    ``n_active``) equal, losses, costs and Alg.-1 estimates within 1e-5,
    the tolerances of the elastic slice's CPU tests."""
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.train import build_parser, run_dlrm
    from repro_torch.models.dlrm import init_params

    cfg = DLRM_CONFIGS["wdl-tiny"]
    cpu = init_params(cfg, WORKLOADS[cfg.workload],
                      torch.Generator().manual_seed(seed), "cpu")
    base = ["--arch", "wdl-tiny", "--workers", "4", "--batch-per-worker",
            "8", "--steps", "6", "--esd-alpha", "1", "--exchange", "ragged",
            "--seed", str(seed), "--fault-plan", TINY_PLAN]
    for what, extra in (("depth 1", []), ("int8", ["--codec", "int8"]),
                        ("depth 2", ["--pipeline-depth", "2"])):
        outs = {dev: run_dlrm(build_parser().parse_args(
                    base + extra + ["--device", dev]),
                    model=copy.deepcopy(cpu).to(dev))
                for dev in ("cpu", "cuda")}
        rc, rg = outs["cpu"]["metrics"], outs["cuda"]["metrics"]
        worst = 0.0
        for a, b in zip(rc, rg, strict=True):
            check(set(a) == set(b), f"elastic {what}: the same fields")
            for key, v in a.items():
                if key in ("loss", "alg1_est", "cost"):
                    check(math.isclose(b[key], v, rel_tol=1e-5, abs_tol=0),
                          f"elastic {what}: {key} on card vs CPU within "
                          f"1e-5")
                    worst = max(worst, abs(b[key] - v) / abs(v))
                elif key != "wall_s":
                    check(b[key] == v, f"elastic {what}: {key} equal on "
                                       f"card and CPU")
        check([r["n_active"] for r in rg] == [4, 4, 3, 4, 4, 4],
              f"elastic {what}: n_active follows the plan")
        print(f"[parity] run_dlrm --fault-plan '{TINY_PLAN}' {what}, card "
              f"vs CPU, wdl-tiny, 6 steps: integer fields equal, losses "
              f"{[r['loss'] for r in rg]}, max rel err of losses and costs "
              f"{worst:.3g} (tolerance 1e-5)")


def phase_train_elastic(seed: int) -> dict:
    """Phase 13: ``run_dlrm --fault-plan`` at wdl-s1 (phase 6's
    configuration, 12 steps) at depth 1, at depth 2 and with ``--codec
    int8``: finite records, ``n_active`` 3 at steps 3-6, no sample for
    worker 1 while it is down, depth 2's records bit for bit depth 1's,
    and B1, the exchange's pack and the fused auction launched; then an
    empty plan, whose 10 records equal phase 6's bit for bit."""
    from repro_torch.elastic import FaultPlan
    from repro_torch.kernels import auction as A
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_parser, run_dlrm

    plan = FaultPlan.parse(ELASTIC_PLAN, 4)
    check(plan.max_inactive() == 1, "the plan has one worker down at most")
    total: dict = {}
    outs = {}
    for name, extra in (("depth 1", []),
                        ("depth 2", ["--pipeline-depth", "2"]),
                        ("int8", ["--codec", "int8"])):
        received = []       # samples each worker received, a step
        real = S.esd_decide
        if name == "depth 1":
            def spy(*a, **kw):
                out = real(*a, **kw)
                received.append(torch.bincount(
                    out[0].reshape(-1).long(), minlength=4).tolist())
                return out
            S.esd_decide = spy
        args = build_parser().parse_args(TRAIN_ARGV + ELASTIC_ARGV + extra
                                         + ["--seed", str(seed)])
        A.ROUNDS_LOG = []
        _zero_launches()
        try:
            out = run_dlrm(args)      # raises if a step's exchange overflowed
        finally:
            S.esd_decide = real
            launches = {k: v for k, v in _read_launches().items() if v}
            solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        outs[name] = out
        recs = out["metrics"]
        per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
        pack = "pack_send_all_quant" if name == "int8" else "pack_send_all"
        print(f"[train-elastic] wdl-s1 '{ELASTIC_PLAN}', {name}: wall "
              f"{out['wall_ms_mean']:.3f} ms a step (mean after the first "
              f"{out['pipeline_depth']}); {out['stage_clock']} ms decide "
              f"{out['decide_ms_mean']:.3f}, advance "
              f"{out['advance_ms_mean']:.3f}, train "
              f"{out['train_ms_mean']:.3f}; losses "
              f"{[r['loss'] for r in recs]}; n_active "
              f"{[r['n_active'] for r in recs]}; launches {per_step} per "
              f"step")
        print(f"[train-elastic] {name} step ms (decide, advance, train): "
              + str([tuple(round(x * 1e3, 2) for x in t) for t in zip(
                  *(out["stage_s"][s] for s in ("decide", "advance",
                                                "train")))]))
        check(all(np.isfinite([r["loss"] for r in recs]))
              and all(np.isfinite([r["cost"] for r in recs])),
              f"elastic {name}: every loss and cost finite")
        check([r["n_active"] for r in recs]
              == [3 if 3 <= i <= 6 else 4 for i in range(12)],
              f"elastic {name}: n_active 3 at steps 3-6")
        check(per_step.get("alg1_cost") == 1.0
              and "pooled_lookup" not in per_step
              and per_step.get("auction_solve") == 1.0
              and per_step.get(pack) == 1.0,
              f"elastic {name}: one alg1_cost, one auction_solve and one "
              f"{pack} launch a step, no pooled_lookup ({per_step})")
        print(f"[train-elastic] {name} auction rounds per step, per "
              f"worker: {[r.sum(dim=1).tolist() for r in solves]}")
        if received:
            print(f"[train-elastic] samples received per worker a step: "
                  f"{received}")
            check(all(r[1] == 0 for r in received[3:7]),
                  "worker 1 receives no samples while it is down")
    keys = ELASTIC_KEYS
    check([[r[k] for k in keys] for r in outs["depth 2"]["metrics"]]
          == [[r[k] for k in keys] for r in outs["depth 1"]["metrics"]],
          "elastic depth 2: every record bit for bit depth 1's")
    one, _ = TRAIN_DEPTH1[None]
    print(f"[train-elastic] the raised cap (out_rows 512 a worker, phase 6 "
          f"256): train {outs['depth 1']['train_ms_mean']:.3f} ms a step "
          f"against phase 6's {one['train_ms_mean']:.3f}; advance "
          f"{outs['depth 1']['advance_ms_mean']:.3f} against "
          f"{one['advance_ms_mean']:.3f}; wall ms a step depth 1 "
          f"{outs['depth 1']['wall_ms_mean']:.3f}, depth 2 "
          f"{outs['depth 2']['wall_ms_mean']:.3f}")
    # an empty plan runs the elastic stages with neutral tensors
    args = build_parser().parse_args(TRAIN_ARGV + ["--fault-plan", " ; ",
                                                   "--seed", str(seed)])
    _zero_launches()
    out = run_dlrm(args)
    for k, v in _read_launches().items():
        total[k] = total.get(k, 0) + v
    keys = ELASTIC_KEYS[:-1]
    check([[r[k] for k in keys] for r in out["metrics"]]
          == [[r[k] for k in keys] for r in one["metrics"]],
          "an empty plan: every record bit for bit phase 6's")
    print("[train-elastic] an empty plan: the 10 records equal phase 6's "
          "bit for bit")
    return {k: v for k, v in total.items() if v}


RESUME_LM_LAYERS = 4     # smollm-360m's 32 layers cut to 4


def phase_resume(seed: int) -> dict:
    """Phase 14: resume.  ``run_dlrm`` at phase 13's configuration at
    depth 2, 10 steps with a checkpoint at step 5, then a second run
    resumed from it: its records from step 5 on equal the uninterrupted
    run's bit for bit.  ``run_lm`` at smollm-360m's full width, its depth
    cut to 4 layers, B 4 x S 2,048: 4 steps with a checkpoint at step 2,
    then resumed from a model of other weights: losses bit for bit, B8
    and its backward launched once a layer and step.  Prints each
    checkpoint's bytes and its save and restore ms (host clock, after a
    synchronise)."""
    import repro_torch.launch.train as T
    from repro_torch.configs import get_config
    from repro_torch.models import api

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    times: dict = {"save": [], "restore": []}
    real = {"save": T.save_checkpoint, "restore": T.restore_checkpoint}

    def timed(kind):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[kind](*a, **kw)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    total: dict = {}

    def count():
        for k, v in _read_launches().items():
            total[k] = total.get(k, 0) + v

    T.save_checkpoint, T.restore_checkpoint = timed("save"), timed("restore")
    try:
        d = ckdir / "dlrm"
        argv = TRAIN_ARGV + ["--fault-plan", ELASTIC_PLAN, "--pipeline-depth",
                             "2", "--ckpt-dir", str(d), "--ckpt-every", "5",
                             "--seed", str(seed)]
        _zero_launches()
        full = T.run_dlrm(T.build_parser().parse_args(argv))["metrics"]
        count()
        size = (d / "ckpt_00000005.npz").stat().st_size
        (d / "ckpt_00000010.npz").unlink()
        _zero_launches()
        resumed = T.run_dlrm(T.build_parser().parse_args(
            argv + ["--resume"]))["metrics"]
        count()
        keys = ELASTIC_KEYS
        check([r["step"] for r in resumed] == list(range(5, 10))
              and [[r[k] for k in keys] for r in resumed]
              == [[r[k] for k in keys] for r in full[5:]],
              "resumed DLRM records from step 5 bit for bit the "
              "uninterrupted run's")
        print(f"[resume] wdl-s1 '{ELASTIC_PLAN}', depth 2: checkpoint at "
              f"step 5 of {size} bytes, save {times['save'][0]:.1f} ms, "
              f"restore {times['restore'][0]:.1f} ms; the resumed run's 5 "
              f"records equal the uninterrupted run's bit for bit (losses "
              f"{[r['loss'] for r in resumed]})")
        dlrm_times = (size, times["save"][0], times["restore"][0])
        times["save"].clear()
        times["restore"].clear()

        d = ckdir / "lm"
        cfg = dataclasses.replace(get_config("smollm-360m"),
                                  n_layers=RESUME_LM_LAYERS)
        argv = ["--arch", "smollm-360m", "--seq-len", "2048",
                "--batch-per-worker", "4", "--steps", "4", "--seed",
                str(seed), "--device", "cuda", "--ckpt-dir", str(d),
                "--ckpt-every", "2"]
        runs = []
        for extra, weights in (([], seed), (["--resume"], seed + 1)):
            model = api.init_model(cfg, generator=torch.Generator(
                device="cuda").manual_seed(weights), device="cuda")
            _zero_launches()
            out = T.run_lm(T.build_parser().parse_args(argv + extra),
                           model=model, cfg=cfg)
            launches = {k: v for k, v in _read_launches().items() if v}
            count()
            n = cfg.n_layers * len(out["metrics"])
            check(launches == {"flash_attention": n,
                               "flash_attention_bwd": n},
                  f"LM resume: B8 and its backward once a layer and step "
                  f"({launches})")
            _check_bwd_wgmma(n, "LM resume")
            runs.append(out["metrics"])
            if not extra:
                lm_size = (d / "ckpt_00000002.npz").stat().st_size
                (d / "ckpt_00000004.npz").unlink()
        full, resumed = runs
        check([r["step"] for r in resumed] == [2, 3]
              and [r["loss"] for r in resumed]
              == [r["loss"] for r in full[2:]],
              "resumed LM losses bit for bit the uninterrupted run's")
        print(f"[resume] {cfg.name} at full width, {cfg.n_layers} of 32 "
              f"layers ({cfg.dtype}), B 4, S 2048, 4 steps: checkpoint at "
              f"step 2 of {lm_size} bytes, save {times['save'][0]:.1f} ms, "
              f"restore {times['restore'][0]:.1f} ms; losses "
              f"{[r['loss'] for r in full]}, resumed "
              f"{[r['loss'] for r in resumed]} (bit for bit)")
        print(f"[resume] checkpoint bytes, save ms, restore ms: DLRM "
              f"{dlrm_times}, LM ({lm_size}, {times['save'][0]:.1f}, "
              f"{times['restore'][0]:.1f})")
    finally:
        T.save_checkpoint, T.restore_checkpoint = (real["save"],
                                                   real["restore"])
        shutil.rmtree(ckdir, ignore_errors=True)
    return {k: v for k, v in total.items() if v}


# phase 15: 2 parameter servers at wdl-s1, the last behind 0.5 Gbps links
PS_ARGV = ["--n-ps", "2", "--ps-hetero"]
PS_PLAN = "ps_outage@3:1-7"           # shard 1 at 0.05 of its links, 3-6
PS_RUNS = {"contiguous": PS_ARGV,
           "contiguous, depth 2": PS_ARGV + ["--pipeline-depth", "2"],
           "hashed": PS_ARGV + ["--ps-layout", "hashed"],
           "hashed, depth 2": PS_ARGV + ["--ps-layout", "hashed",
                                         "--pipeline-depth", "2"],
           "hashed, int8": PS_ARGV + ["--ps-layout", "hashed", "--codec",
                                      "int8"],
           "contiguous, PS outage": PS_ARGV + ["--fault-plan", PS_PLAN]}
RECORD_KEYS = ("loss", "miss_pull", "update_push", "evict_push", "cost",
               "alg1_est")


def _stage_line(out) -> str:
    return (f"wall {out['wall_ms_mean']:.3f} ms a step; {out['stage_clock']}"
            f" ms decide {out['decide_ms_mean']:.3f}, advance "
            f"{out['advance_ms_mean']:.3f}, train {out['train_ms_mean']:.3f}")


def _run_counted(argv, total: dict):
    """``run_dlrm`` on ``argv`` with the counts set to 0 just before and
    read just after: (summary, launches a step, auction rounds)."""
    from repro_torch.kernels import auction as A
    from repro_torch.launch.train import build_parser, run_dlrm

    A.ROUNDS_LOG = []
    _zero_launches()
    try:
        out = run_dlrm(build_parser().parse_args(argv))
    finally:
        launches = {k: v for k, v in _read_launches().items() if v}
        solves, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    recs = out["metrics"]
    per_step = {k: round(v / len(recs), 3) for k, v in launches.items()}
    check(all(np.isfinite([r["loss"] for r in recs]))
          and all(np.isfinite([r["cost"] for r in recs])),
          f"{' '.join(argv[-6:])}: every loss and cost finite")
    return out, per_step, [r.sum(dim=1).tolist() for r in solves]


def phase_train_ps(seed: int) -> dict:
    """Phase 15: ``run_dlrm`` at phase 6's wdl-s1 configuration over 2
    parameter servers with the ``--ps-hetero`` links (the tables
    PS-stacked, ids and state planes PS-linearized, Alg. 1 priced per
    shard through B1), contiguous and hashed at depth 1 and 2, hashed
    with ``--codec int8``, and under a PS outage: 4 B1 launches, one
    ``auction_solve`` and one ``pack_send_all`` (``_quant`` with the
    codec) a step, depth 2's records bit for bit depth 1's, the per-shard
    misses on both shards."""
    total: dict = {}
    outs = {}
    one, _ = TRAIN_DEPTH1[None]
    for name, extra in PS_RUNS.items():
        out, per_step, rounds = _run_counted(
            TRAIN_ARGV + extra + ["--seed", str(seed)], total)
        outs[name] = out
        recs = out["metrics"]
        pack = ("pack_send_all_quant" if "--codec" in extra
                else "pack_send_all")
        print(f"[train-ps] wdl-s1, 2 PS {name}: {_stage_line(out)} (phase "
              f"6: wall {one['wall_ms_mean']:.3f}, decide "
              f"{one['decide_ms_mean']:.3f}, advance "
              f"{one['advance_ms_mean']:.3f}, train "
              f"{one['train_ms_mean']:.3f}); losses "
              f"{[r['loss'] for r in recs]}; cost "
              f"{[r['cost'] for r in recs]}; alg1_est "
              f"{[r['alg1_est'] for r in recs]}; launches {per_step} a step")
        print(f"[train-ps] {name} auction rounds per step, per worker: "
              f"{rounds}")
        check(per_step.get("pooled_lookup") == 4.0
              and per_step.get("auction_solve") == 1.0
              and per_step.get(pack) == 1.0 and "gather_rows" not in per_step,
              f"2 PS {name}: B1 once per worker and step, one auction_solve "
              f"and one {pack} launch a step ({per_step})")
        check(all(r["miss_pull"] > 0 for r in recs),
              f"2 PS {name}: miss_pull > 0 each step")
    for layout in ("contiguous", "hashed"):
        a, b = outs[layout], outs[f"{layout}, depth 2"]
        check([[r[k] for k in RECORD_KEYS] for r in b["metrics"]]
              == [[r[k] for k in RECORD_KEYS] for r in a["metrics"]],
              f"2 PS {layout}: depth 2's records bit for bit depth 1's")
    alg1 = [r["alg1_est"] for r in outs["contiguous, PS outage"]["metrics"]]
    base = [r["alg1_est"] for r in outs["contiguous"]["metrics"]]
    check(all(alg1[i] > base[i] for i in range(3, 7))
          and alg1[:3] == base[:3],
          "the outage prices shard 1's misses dearer in steps 3-6 only "
          "(the records before it bit for bit the plain run's)")
    B1_INPUTS["per-shard"]["launches"] = total.get("pooled_lookup", 0)
    return total


def phase_train_dense(seed: int) -> dict:
    """Phase 16: ``run_dlrm --esd-engine dense`` at phase 6's
    configuration (the (4, 502,000) planes updated whole every step) at
    depth 1 and 2, each record bit for bit phase 6's; the README's
    prefetch configuration on the dense engine (one staged_pull a
    step); then ``esd_dispatch`` with the dense cost (B1 over the
    (502,000, 4) per-id table) on the run's final state and the next
    batch: 4 B1 launches, one auction_solve and one pack_send_all, the
    assignment and exchanged samples those of the compact cost (one
    alg1_cost launch), whose cost and assignment are the per-worker
    route's."""
    from repro_torch.core.dispatch import (esd_cost_matrix, esd_dispatch,
                                           hybrid_dispatch)
    from repro_torch.core.simulator import DEFAULT_BANDWIDTHS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels.ops import cost_matrix_batched_kernel

    total: dict = {}
    one, one_launch = TRAIN_DEPTH1[None]
    finals = {}
    for name, extra in (("depth 1", []),
                        ("depth 2", ["--pipeline-depth", "2"]),
                        ("README prefetch", AHEAD_ARGV)):
        out, per_step, rounds = _run_counted(
            TRAIN_ARGV + ["--esd-engine", "dense"] + extra
            + ["--seed", str(seed)], total)
        finals[name] = out
        recs = out["metrics"]
        check(type(out["esd_state"]).__name__ == "EsdState",
              "the dense engine's state")
        print(f"[train-dense] wdl-s1 {name}: {_stage_line(out)} (phase 6: "
              f"wall {one['wall_ms_mean']:.3f}, advance "
              f"{one['advance_ms_mean']:.3f}); launches {per_step} a step")
        if extra == AHEAD_ARGV:
            check(per_step.get("staged_pull") == 1.0
                  and "staged_gather" not in per_step
                  and all(r["prefetch_bytes"] > 0 for r in recs[1:]),
                  "dense engine, README configuration: one staged_pull "
                  "a step, rows prefetched after step 0")
            print(f"[train-dense] README configuration: prefetch_hit_rate "
                  f"{[r['prefetch_hit_rate'] for r in recs]}, n_reassigned "
                  f"{[r['n_reassigned'] for r in recs]}")
            continue
        check([[r[k] for k in RECORD_KEYS] for r in recs]
              == [[r[k] for k in RECORD_KEYS] for r in one["metrics"]],
              f"dense engine {name}: every record bit for bit phase 6's "
              f"(the sparse engine)")
        check(seed != 0 or rounds == TRAIN_ROUNDS[None][:len(rounds)],
              f"dense engine {name}: the auction's rounds the CPU's")
        check(per_step == one_launch,
              f"dense engine {name}: the launches a step phase 6's")
    # the one-call dispatch, the dense cost on the run's final state
    wl = WORKLOADS["S1"]
    n, m = 4, 256
    state = finals["depth 1"]["esd_state"]
    batch = next(itertools.islice(wl.stream(seed + 1, n * m), 10, None))[0]
    samples = torch.as_tensor(batch.astype(np.int32),
                              device="cuda").reshape(n, m, -1)
    t = torch.tensor((512 * 4.0) / DEFAULT_BANDWIDTHS(n), dtype=torch.float32,
                     device="cuda")
    _zero_launches()
    exch, assign = esd_dispatch(samples, state, t, 1.0, sparse_cost=False,
                                exchange="ragged")
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_launches().items() if v}
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    check(launches == {"pooled_lookup": n, "auction_solve": 1,
                       "pack_send_all": 1},
          f"esd_dispatch(sparse_cost=False): 4 B1 launches, one auction and "
          f"one pack ({launches})")
    B1_INPUTS["dense"]["launches"] = launches["pooled_lookup"]
    _zero_launches()
    exch_c, assign_c = esd_dispatch(samples, state, t, 1.0,
                                    exchange="ragged")
    torch.cuda.synchronize()
    compact = {k: v for k, v in _read_launches().items() if v}
    for k, v in compact.items():
        total[k] = total.get(k, 0) + v
    check(compact == {"alg1_cost": 1, "auction_solve": 1,
                      "pack_send_all": 1},
          f"esd_dispatch: one alg1_cost launch prices every worker, one "
          f"auction and one pack ({compact})")
    check(torch.equal(assign, assign_c) and torch.equal(exch, exch_c),
          "esd_dispatch: the dense cost's assignment and exchange are the "
          "compact cost's")
    C_loop = torch.stack([esd_cost_matrix(samples[i], state, t)
                          for i in range(n)])
    check(torch.equal(cost_matrix_batched_kernel(samples, state.latest,
                                                 state.dirty, t), C_loop)
          and torch.equal(hybrid_dispatch(C_loop, m, 1.0), assign_c),
          "esd_dispatch: the one-launch cost and its assignment are the "
          "per-worker route's (B1 a worker)")
    print(f"[train-dense] esd_dispatch at wdl-s1 (4 x 256, the dense "
          f"(502,000, 4) cost table, ragged): launches {launches}; samples "
          f"received a worker {torch.bincount(assign.reshape(-1).long(), minlength=n).tolist()}; "
          f"equal to the compact cost's")
    return total


# phase 8's fault plan on its 8 workers, and the ESD auction's result
# under it on the CPU: scripts/auction_rounds.py --device cpu --fault-plan
SIM_PLAN = "crash@2:3g; rejoin@5:3w; straggle@1:0x4-6; bw@3:5x0.25-7"
S1_FAULTS_AUCTION_CPU = dict(
    rounds=1_637_169, cost=1.2810092544000002, itps=8.275521496441675,
    hit_ratio=0.22006564189747585,
    elastic={"events": [
        {"kind": "straggle", "step": 1, "target": 0, "factor": 4.0,
         "until": 6},
        {"kind": "crash", "step": 2, "target": 3, "graceful": True},
        {"kind": "bw", "step": 3, "target": 5, "factor": 0.25, "until": 7},
        {"kind": "rejoin", "step": 5, "target": 3, "warm": True}],
        "flush_push_ops": 1529, "handoff_rows": 2053,
        "handoff_time_s": 0.0666894336, "min_active": 7},
    per_iter_cost=[0.1747255296, 0.27795456, 0.2620063744,
                   0.22484090880000002, 0.21465006080000001, 0.1268318208],
    alg1_cost=6.364035942399999,
    ingredient={"5Gbps": {"miss_pull": 17212, "update_push": 9451,
                          "evict_push": 0},
                "0.5Gbps": {"miss_pull": 15819, "update_push": 8731,
                            "evict_push": 0}})


def phase_simulate_faults(seed: int) -> dict:
    """Phase 8 under ``SIM_PLAN`` (S1 at phase 8's cut sizes, calibrated
    decisions): ESD with SSP, LAIA, random and HET on the card and on the
    CPU, every ``SimResult`` field equal; FAE, whose cache models no
    churn, refused alike and run on the plan's window events; ESD with
    the auction (one auction_solve launch a decision) against the CPU's
    result at seed 0 (``S1_FAULTS_AUCTION_CPU``); and a multi-PS run (2
    shards) with a PS outage, card against CPU."""
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.elastic import FaultPlan
    from repro_torch.kernels import auction as A

    base = dict(workload=WORKLOADS["S1"], n_workers=8, batch_per_worker=32,
                cache_ratio=0.08, embedding_dim=512, iters=8, warmup=2,
                seed=seed)
    window = "straggle@1:0x4-6; bw@3:5x0.25-7"
    launches: dict = {}

    def same(a, b):
        for f in dataclasses.fields(a):
            u, v = getattr(a, f.name), getattr(b, f.name)
            ok = (np.array_equal(u, v) if isinstance(u, np.ndarray)
                  else u == v)
            check(ok, f"simulate under faults: {f.name} equal on card and "
                      f"CPU")

    for name, kw, spec, n_ps in (
            ("esd-ssp", dict(mechanism="esd", opt="ssp"), SIM_PLAN, 1),
            ("laia", dict(mechanism="laia"), SIM_PLAN, 1),
            ("random", dict(mechanism="random"), SIM_PLAN, 1),
            ("het", dict(mechanism="het"), SIM_PLAN, 1),
            ("fae", dict(mechanism="fae"), window, 1),
            ("esd-ssp n_ps 2", dict(mechanism="esd", opt="ssp"),
             "ps_outage@2:1-6; crash@3:6; rejoin@6:6w", 2)):
        res = {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            res[dev] = simulate(SimConfig(
                device=dev, faults=FaultPlan.parse(spec, 8, n_ps),
                n_ps=n_ps, **base, **kw))
            wall = time.perf_counter() - t if dev == "cuda" else wall
        same(res["cuda"], res["cpu"])
        r = res["cuda"]
        print(f"[simulate-faults] S1 {name} '{spec}': cost {r.cost!r}, itps "
              f"{r.itps!r}, hit ratio {r.hit_ratio!r}, elastic {r.elastic}; "
              f"every field equal on card and CPU; wall {wall:.1f} s")
    try:
        simulate(SimConfig(device="cuda", faults=FaultPlan.parse(SIM_PLAN, 8),
                           mechanism="fae", **base))
        check(False, "FAE refuses a plan with membership churn")
    except ValueError as e:
        check("does not support membership churn" in str(e),
              f"FAE refuses churn with the reference's message ({e})")
    A.ROUNDS_LOG = []
    _zero_launches()
    t = time.perf_counter()
    try:
        res = simulate(SimConfig(device="cuda", mechanism="esd",
                                 opt="auction",
                                 faults=FaultPlan.parse(SIM_PLAN, 8), **base))
    finally:
        wall = time.perf_counter() - t
        run = {k: v for k, v in _read_launches().items() if v}
        log, A.ROUNDS_LOG = A.ROUNDS_LOG, None
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v
    rounds = [int(r.sum()) for r in log]
    check(run.get("auction_solve") == len(rounds) == 8
          and "auction_bids" not in run,
          "simulate esd-auction under faults: one auction_solve launch a "
          "decision")
    got = dict(rounds=sum(rounds), cost=res.cost, itps=res.itps,
               hit_ratio=res.hit_ratio, elastic=res.elastic,
               per_iter_cost=res.per_iter_cost.tolist(),
               alg1_cost=res.alg1_cost, ingredient=res.ingredient)
    if seed == 0 and S1_FAULTS_AUCTION_CPU is not None:
        check(got == S1_FAULTS_AUCTION_CPU,
              f"simulate esd-auction under faults: every field equal to "
              f"the CPU's ({got} against {S1_FAULTS_AUCTION_CPU})")
    print(f"[simulate-faults] S1 esd-auction '{SIM_PLAN}': {got}; rounds a "
          f"decision {rounds}; wall {wall:.1f} s"
          + ("; equal to the CPU's" if seed == 0
             and S1_FAULTS_AUCTION_CPU is not None else ""))
    return launches


# the linear recurrence's shapes on phase 17's paths: falcon-mamba-7b's
# state (d_inner 8,192 x N 16) and recurrentgemma-2b's lru_width, B 1,
# S 2,048; and a ragged one (C not a multiple of 32, S of a tile)
SCAN_SHAPES = {"falcon-mamba-7b": (1, 2048, 8192 * 16),
               "recurrentgemma-2b": (1, 2048, 2560),
               "ragged": (3, 1000, 1000)}
# kernel against plain, relative to the output's largest magnitude: the
# kernel sums each thread's steps in order, the plain version by
# doubling; with every a in (0, 1) a rounding error decays along the
# sequence, and on the CPU either stays within 2e-7 of an f64 scan
SCAN_TOL = 2e-6


def phase_scan_kernels(seed: int) -> dict:
    """``linear_scan`` and ``linear_scan_bwd`` against their plain
    version at ``SCAN_SHAPES``, with device, call and plain ms and the
    byte bound; the autograd Function's gradients against autograd of
    the plain version.  The kernels' records are falcon-mamba's."""
    from repro_torch.kernels import linear_scan as LS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    rec = {}

    def rel_err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    for what, (B, S, C) in SCAN_SHAPES.items():
        # a in [0.5, 0.999): decays from 2 to 1,000 steps, as Mamba's
        # exp(dt A) and RG-LRU's sigmoid(Lambda)^(8 r) span
        a = 0.5 + 0.499 * torch.rand((B, S, C), generator=g, device=dev)
        b = torch.randn((B, S, C), generator=g, device=dev)
        h0 = torch.randn((B, C), generator=g, device=dev)
        gh = torch.randn((B, S, C), generator=g, device=dev)
        gl = torch.randn((B, C), generator=g, device=dev)
        h, h_last = LS.linear_scan(a, b, h0)
        want = LS.linear_scan_ref(a, b, h0)
        fwd_err = max(rel_err(h, want[0]), rel_err(h_last, want[1]))
        del want
        got = LS.linear_scan_backward(a, h, h0, gh, gl)
        want = LS.linear_scan_bwd_ref(a, h, h0, gh, gl)
        bwd_err = max(rel_err(x, y) for x, y in zip(got, want))
        torch.cuda.synchronize()
        del got, want
        check(fwd_err <= SCAN_TOL and bwd_err <= SCAN_TOL,
              f"linear_scan {what} ({B}, {S}, {C}): forward and backward "
              f"within {SCAN_TOL} of max |plain| (errors {fwd_err}, "
              f"{bwd_err})")
        fwd = (lambda: LS.linear_scan(a, b, h0))
        bwd = (lambda: LS.linear_scan_backward(a, h, h0, gh, gl))
        ms, call_ms = device_ms(fwd)
        plain_ms, _ = device_ms(lambda: LS.linear_scan_ref(a, b, h0),
                                reps=10)
        bwd_ms, bwd_call = device_ms(bwd)
        bwd_plain, _ = device_ms(
            lambda: LS.linear_scan_bwd_ref(a, h, h0, gh, gl), reps=10)
        n = B * S * C
        # forward: a, b, h0 read, h, h_last written, an FMA a step;
        # backward: a, h, g, h0, g_last read, da, db, dh0 written, an FMA
        # and a product a step
        b_ms, b_by = bound(3 * n * 4 + 2 * B * C * 4, 2 * n)
        bb_ms, bb_by = bound(5 * n * 4 + 3 * B * C * 4, 3 * n)
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        warps = LS.block_warps(B * -(-C // 32), n_sms)
        print(f"[kernel] linear_scan {what} (B {B}, S {S}, C {C}, {warps} "
              f"warps a block): max err {fwd_err:.3g} of max |h| "
              f"(tolerance {SCAN_TOL}), {ms:.4f} ms (call {call_ms:.4f}), "
              f"{3 * n * 4 / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), library none")
        print(f"[kernel] linear_scan_bwd {what}: max err {bwd_err:.3g} of "
              f"max |da|, |db|, |dh0|, {bwd_ms:.4f} ms (call "
              f"{bwd_call:.4f}), {5 * n * 4 / bwd_ms / 1e6:.1f} GB/s, plain "
              f"{bwd_plain:.4f} ms, bound {bb_ms:.6f} ms ({bb_by}), library "
              f"none")
        if what == "falcon-mamba-7b":
            rec["linear_scan"] = dict(max_abs_err=fwd_err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by)
            rec["linear_scan_bwd"] = dict(max_abs_err=bwd_err, ms=bwd_ms,
                                          plain_ms=bwd_plain, bound_ms=bb_ms,
                                          bound_by=bb_by)
        del a, b, h0, gh, gl, h, h_last
        torch.cuda.empty_cache()

    # the autograd Function (both kernels) against autograd of the plain
    # forward, for a loss that reads h and h_last
    leaves = [0.5 + 0.499 * torch.rand((2, 700, 300), generator=g,
                                       device=dev),
              torch.randn((2, 700, 300), generator=g, device=dev),
              torch.randn((2, 300), generator=g, device=dev)]
    w, wl = (torch.randn(t.shape, generator=g, device=dev)
             for t in leaves[1:])
    grads = []
    for fn in (LS.scan, LS.linear_scan_ref):
        ts = [t.clone().requires_grad_() for t in leaves]
        h, hl = fn(*ts)
        grads.append(torch.autograd.grad((h * w).sum() + (hl * wl).sum(),
                                         ts))
    worst = max(rel_err(x, y) for x, y in zip(*grads))
    check(worst <= SCAN_TOL, f"scan's gradients within {SCAN_TOL} of "
                             f"autograd of the plain version ({worst})")
    print(f"[kernel] scan gradients (2, 700, 300): max err {worst:.3g} of "
          f"the largest against autograd of the plain version (tolerance "
          f"{SCAN_TOL})")
    return rec


def phase_ssm_parity(seed: int):
    """The SSM and hybrid LMs' smoke configs (f32) on the card against
    the CPU from the same weights: 3 ``run_lm`` steps at S 2,048 (losses
    within phase 4's 1e-4; the recurrent layers on the linear-scan
    kernels, recurrentgemma's local layer on the blockwise route, once a
    recurrent layer and step each, B8 never), then 8 decode steps at B 4
    from the CPU's trained weights on both (logits within 1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models import api

    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = get_config(arch, smoke=True)
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        argv = ["--arch", arch, "--smoke", "--seq-len", "2048",
                "--batch-per-worker", "1", "--steps", "3", "--seed",
                str(seed)]
        runs = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            n0 = _read_launches()
            out = run_lm(build_parser().parse_args(argv + ["--device", dev]),
                         model=model)
            runs[dev] = [r["loss"] for r in out["metrics"]]
            ran = {k: v - n0[k] for k, v in _read_launches().items()
                   if v != n0[k]}
        err = max(abs(a - b) for a, b in zip(runs["cpu"], runs["cuda"]))
        n = 3 * sum(k in ("mamba", "rglru") for k in cfg.kinds())
        check(all(np.isfinite(runs["cuda"])) and err <= 1e-4,
              f"{arch} smoke losses on card vs CPU within 1e-4 (max err "
              f"{err})")
        check(ran == {"linear_scan": n, "linear_scan_bwd": n},
              f"{arch} smoke steps ran the scan kernels once a recurrent "
              f"layer and step, and no other kernel ({ran})")
        # decode from one set of weights: Adam at lr 1e-2 moves the two
        # runs' weights apart by up to lr where a gradient is near 0
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (4, 8)))
        caches = [api.init_decode_cache(cfg, 4, 8, d) for d in ("cpu",
                                                                "cuda")]
        derr = 0.0
        for pos in range(8):
            x, caches[0] = api.decode_step(cpu, cfg, toks[:, pos:pos + 1],
                                           caches[0], pos)
            y, caches[1] = api.decode_step(gpu, cfg,
                                           toks[:, pos:pos + 1].cuda(),
                                           caches[1], pos)
            derr = max(derr, float((y.cpu() - x).abs().max()))
        check(derr <= 1e-5, f"{arch} smoke decode on card vs CPU within "
                            f"1e-5 (max err {derr})")
        print(f"[parity] {cfg.name} (f32, {cfg.n_layers} layers): 3 LM "
              f"steps, B 1, S 2048, card vs CPU: losses {runs['cuda']} vs "
              f"{runs['cpu']}, max abs err {err:.3g} (tolerance 1e-4); card "
              f"kernel launches {ran}; 8 decode steps after, B 4: logits "
              f"max abs err {derr:.3g} (tolerance 1e-5)")


# phase 17: falcon-mamba-7b at full width with its 64 layers cut to 8 (at
# 64 the parameters and Adam's f32 moments alone are about 84 GB), and
# recurrentgemma-2b at full width and depth
MAMBA_LAYERS = 8
# f32 decode against f32 prefill at positions 0..255 of falcon-mamba:
# 8 layers whose scan sums in the kernel's order in the prefill and step
# by step in decode, GEMMs against GEMVs over up to 8,192 terms; errors
# near 1e-5 of logits up to ~10, and ``SERVE_F32_TOL``'s 1e-3 keeps the
# margin
SSM_F32_TOL = SERVE_F32_TOL


def _lm_run(arch: str, cfg, seed: int, model) -> tuple[dict, dict, float]:
    """3 ``run_lm`` steps of ``cfg`` (a variant of ``arch``) at B 1, S
    2,048 from zeroed counters: (the summary, the launches, the peak
    GiB)."""
    from repro_torch.launch.train import build_parser, run_lm

    args = build_parser().parse_args(
        ["--arch", arch, "--seq-len", "2048", "--batch-per-worker", "1",
         "--steps", "3", "--seed", str(seed), "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = run_lm(args, model=model, cfg=cfg)
    launches = {k: v for k, v in _read_launches().items() if v}
    return out, launches, _peak_gib()


def phase_lm_ssm(seed: int) -> dict:
    """falcon-mamba-7b (d 4,096, d_inner 8,192, N 16, dt_rank 256, vocab
    65,024, tied, bf16) with ``MAMBA_LAYERS`` layers: 3 ``run_lm`` steps
    at B 1, S 2,048 (the scan's forward and backward once a layer and
    step, B8 never), then in f32 a prefill of B 4 x S 256 against decode
    of the same tokens, teacher-forced, within ``SSM_F32_TOL``.
    recurrentgemma-2b (d 2,560, 10 heads over 1, hd 256, d_ff 7,680
    geglu, lru_width 2,560, window 2,048, vocab 256,000, bf16) at its 26
    layers: 3 ``run_lm`` steps at B 1, S 2,048 (the scan once an RG-LRU
    layer and step each way; its local layers on the blockwise route, B8
    never), a prefill of B 1 x S 4,096 (the window cuts), then the
    decode example at B 4, prompt 64 + 64 greedy."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api

    dev = torch.device("cuda")
    ex = _decode_example()
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def seeded():
        return torch.Generator(device=dev).manual_seed(seed)

    # falcon-mamba-7b
    arch = "falcon-mamba-7b"
    cfg = dataclasses.replace(get_config(arch), n_layers=MAMBA_LAYERS)
    model = api.init_model(cfg, generator=seeded(), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    out, launches, peak = _lm_run(arch, cfg, seed, model)
    add(launches)
    losses = [r["loss"] for r in out["metrics"]]
    print(f"[lm-ssm] {cfg.name} at full width, {cfg.n_layers} of 64 layers "
          f"({n_params / 1e9:.3f} B parameters, d {cfg.d_model}, d_inner "
          f"{cfg.expand * cfg.d_model}, N {cfg.ssm_state}, {cfg.dtype}), B "
          f"1, S 2048, 3 steps: {out['step_ms_mean']:.3f} ms per step (mean "
          f"of steps 1..), {out['tokens_per_s']:.1f} tokens/s; losses "
          f"{losses}; step s {[r['wall_s'] for r in out['metrics']]}; peak "
          f"memory {peak:.2f} GiB; launches {launches}")
    n = 3 * cfg.n_layers
    check(all(np.isfinite(losses)), "every falcon-mamba loss finite")
    check(launches == {"linear_scan": n, "linear_scan_bwd": n},
          f"the scan forward and backward once a layer and step, B8 never "
          f"({launches})")
    del model, out
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = api.init_model(cfg32, generator=seeded(), device=dev)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 256))
    _zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = make_prefill_step(cfg32)(model, {"tokens": torch.as_tensor(
        toks, device=dev)})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    got = torch.empty_like(want)

    def keep(pos, logits):
        got[:, pos] = logits[:, 0]

    dargs = ex["build_parser"]().parse_args(
        ["--batch", "4", "--prompt-len", "256", "--gen-len", "1",
         "--device", "cuda"])
    dec = ex["run"](dargs, cfg=cfg32, model=model, prompts=toks,
                    on_logits=keep)
    launches = {k: v for k, v in _read_launches().items() if v}
    add(launches)
    err = float((got - want).abs().max())
    check(launches == {"linear_scan": cfg.n_layers},
          f"the f32 prefill ran the scan once a layer, decode no kernel "
          f"({launches})")
    check(err <= SSM_F32_TOL, f"falcon-mamba f32 decode logits at positions "
                              f"0..255 within {SSM_F32_TOL} of the "
                              f"prefill's (max err {err})")
    print(f"[lm-ssm] {cfg.name} f32: prefill B 4 x S 256 {prefill_ms:.3f} "
          f"ms (first call); decode B 4 teacher-forced over the same 256 "
          f"tokens: p50 {dec['step_p50_ms']:.3f} ms a step, logits max abs "
          f"err {err:.3g} against the prefill's (tolerance {SSM_F32_TOL}; "
          f"|logits| up to {float(want.abs().max()):.3g}); launches "
          f"{launches}")
    del model, want, got
    torch.cuda.empty_cache()

    # recurrentgemma-2b
    arch = "recurrentgemma-2b"
    cfg = get_config(arch)
    model = api.init_model(cfg, generator=seeded(), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_rec = sum(k == "rglru" for k in cfg.kinds())
    out, launches, peak = _lm_run(arch, cfg, seed, model)
    add(launches)
    losses = [r["loss"] for r in out["metrics"]]
    print(f"[lm-ssm] {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers: {n_rec} RG-LRU, {cfg.n_layers - n_rec} local; "
          f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}), B 1, S 2048, "
          f"3 steps: {out['step_ms_mean']:.3f} ms per step (mean of steps "
          f"1..), {out['tokens_per_s']:.1f} tokens/s; losses {losses}; step "
          f"s {[r['wall_s'] for r in out['metrics']]}; peak memory "
          f"{peak:.2f} GiB; launches {launches}")
    check(all(np.isfinite(losses)), "every recurrentgemma loss finite")
    check(launches == {"linear_scan": 3 * n_rec,
                       "linear_scan_bwd": 3 * n_rec},
          f"the scan once an RG-LRU layer and step each way, B8 never: the "
          f"local layers (hd 256) take the blockwise route ({launches})")
    del out

    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, 4096)), device=dev)
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        logits = prefill(model, {"tokens": toks})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    finite = bool(torch.isfinite(logits).all())
    del logits
    prefill_peak = _peak_gib()
    dargs = ex["build_parser"]().parse_args(
        ["--batch", "4", "--prompt-len", "64", "--gen-len", "64", "--device",
         "cuda"])
    torch.cuda.reset_peak_memory_stats()
    dec = ex["run"](dargs, cfg=cfg, model=model)
    launches = {k: v for k, v in _read_launches().items() if v}
    add(launches)
    seq = dec["sequences"]
    check(finite, "recurrentgemma's S 4,096 prefill logits finite")
    check(launches == {"linear_scan": 3 * n_rec},
          f"3 prefills ran the scan once an RG-LRU layer each, B8 never, "
          f"and decode no kernel ({launches})")
    check(seq.shape == (4, 128) and bool(((seq >= 0) & (seq < cfg.vocab))
                                         .all()),
          "recurrentgemma decode emitted tokens of the vocabulary")
    print(f"[lm-ssm] {cfg.name}: prefill B 1 x S 4096 (window 2048) "
          f"{times[0]:.3f} ms first, {statistics.median(times[1:]):.3f} ms "
          f"(median of 2 after), peak {prefill_peak:.2f} GiB; decode B 4, "
          f"prompt 64 + 64 greedy: p50 {dec['step_p50_ms']:.3f} ms, p99 "
          f"{dec['step_p99_ms']:.3f} ms a step, {dec['tok_per_s']:.1f} "
          f"tok/s, peak {_peak_gib():.2f} GiB; launches {launches}")
    del model
    torch.cuda.empty_cache()
    return total


def _train_batch(cfg, rng, B: int, S: int, dev) -> dict:
    """``api.make_train_batch``'s draws, on ``dev``."""
    from repro_torch.models import api

    return {k: torch.as_tensor(v, device=dev)
            for k, v in api.make_train_batch(rng, cfg, B, S).items()}


# phase 4's VLM and audio smoke parity: (B, S) of the steps; pixtral's S
# counts its 16 patches (16 + 2,032 tokens: B8's route), whisper's is its
# 64 frames (and 64 decoder tokens)
VLM_AUDIO_SMOKE = {"pixtral-12b": (1, 2048), "whisper-large-v3": (2, 64)}


def phase_vlm_audio_parity(seed: int):
    """pixtral-12b's and whisper-large-v3's smoke configs (f32) on the
    card against the CPU from the same weights and ``make_train_batch``
    draws: the loss and 3 ``make_train_step`` steps (Adam, lr 1e-2;
    within phase 4's 1e-4; pixtral at 16 patches + 2,032 tokens, B8 once
    a layer a forward and its backward once a layer a step; whisper at 64
    frames and 64 tokens, no kernel), then 8 decode steps at B 4 from one
    set of weights (logits within 1e-5; whisper over zero cross K/V)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import api
    from repro_torch.optim import get_optimizer

    for arch, (B, S) in VLM_AUDIO_SMOKE.items():
        cfg = get_config(arch, smoke=True)
        cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        runs, ran = {}, {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            batch = _train_batch(cfg, np.random.default_rng(seed), B, S, dev)
            n0, r0 = _read_launches(), _routes()
            with torch.no_grad():
                first = float(api.train_loss(model, cfg, batch))
            step = make_train_step(cfg, model, get_optimizer("adam", 1e-2),
                                   remat=False)
            runs[dev] = [first] + [float(step(batch)) for _ in range(3)]
            ran = {k: v - n0[k] for k, v in _read_launches().items()
                   if v != n0[k]}
        err = max(abs(a - b) for a, b in zip(runs["cpu"], runs["cuda"]))
        n = cfg.n_layers if cfg.family == "vlm" else 0
        want = ({"flash_attention": 4 * n, "flash_attention_bwd": 3 * n}
                if n else {})
        check(all(np.isfinite(runs["cuda"])) and err <= 1e-4,
              f"{arch} smoke loss and 3 steps on card vs CPU within 1e-4 "
              f"(max err {err})")
        check(ran == want, f"{arch} smoke: B8 once a layer a forward and "
                           f"its backward once a layer a step on the VLM, "
                           f"no kernel on the audio model ({ran})")
        on_route = _check_routes(r0, "tf32x3", f"{arch} smoke steps")
        gpu = copy.deepcopy(cpu).to("cuda")
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (4, 8)))
        step = make_serve_step(cfg)
        caches = [api.init_decode_cache(cfg, 4, 8, d) for d in ("cpu",
                                                                "cuda")]
        derr = 0.0
        for pos in range(8):
            a, caches[0] = step(cpu, caches[0], toks[:, pos:pos + 1], pos)
            b, caches[1] = step(gpu, caches[1], toks[:, pos:pos + 1].cuda(),
                                pos)
            derr = max(derr, float((b.cpu() - a).abs().max()))
        check(derr <= 1e-5, f"{arch} smoke decode on card vs CPU within "
                            f"1e-5 (max err {derr})")
        what = ("16 patches + 2032 tokens" if cfg.family == "vlm"
                else "64 frames, 64 tokens")
        print(f"[parity] {cfg.name} (f32, {cfg.n_layers} layers), B {B}, "
              f"{what}: loss and 3 steps, card vs CPU: {runs['cuda']} vs "
              f"{runs['cpu']}, max abs err {err:.3g} (tolerance 1e-4); card "
              f"kernel launches {ran} (B8 forward and backward on the "
              f"tf32x3 route: {on_route}); 8 decode steps after, B 4: "
              f"logits max abs err {derr:.3g} (tolerance 1e-5)")


# phase 18: pixtral-12b at full width, its 40 layers cut to
# PIXTRAL_TRAIN_LAYERS for training (at 40 the bf16 weights and
# gradients and Adam's f32 moments, old and new while it updates, come
# to about 245 GB, three times the card; 6 layers peak at 66.8 GiB, 8 do
# not fit); prefill and decode at full depth
PIXTRAL_TRAIN_LAYERS = 6
VLM_S, VLM_B = 2048, 4            # P + S: 256 patches + 1,792 tokens
# whisper-large-v3 at full width and depth: 1,500 frames (its 30 s
# encoder window), 448 decoder tokens; decode 64 steps
AUDIO_FRAMES, AUDIO_B, AUDIO_DECODE = 1500, 4, 64
# whisper's f32 decode over filled cross K/V against decode_train's
# logits, and pixtral's f32 prefill with a prefix on the card against the
# CPU, at the smoke configs: f32 sums in other orders (GEMMs against
# GEMVs, B8's f32 kernel against its plain version) over up to 2,048
# terms leave errors near 1e-6 on logits of magnitude ~1
VLM_AUDIO_F32_TOL = 1e-4


def _timed_steps(step, batches) -> tuple[list, list]:
    """``step`` on each batch, each ended by a synchronise: (losses,
    ms)."""
    losses, ms = [], []
    for batch in batches:
        t = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


def _timed_calls(fn, n: int) -> tuple[list, object]:
    """``fn()`` n times, each ended by a synchronise: (ms, the last
    output)."""
    out, ms = None, []
    for _ in range(n):
        del out
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, out


def phase_lm_vlm_audio(seed: int) -> dict:
    """pixtral-12b at full width (d 5,120, 32 heads over 8, hd 128, d_ff
    14,336, vocab 131,072, untied head, bf16): 3 ``make_train_step``
    steps (Adam, lr 1e-2) at ``PIXTRAL_TRAIN_LAYERS`` layers, B 1, 256
    patches + 1,792 tokens (B8 and its backward once a layer and step);
    at its 40 layers 4 prefills of B 4 x (256 + 1,792) (B8 once a layer)
    and decode of text tokens at B 4, prompt 64 + 64 greedy.
    whisper-large-v3 at full width and depth (32 + 32 layers, d 1,280, 20
    heads, hd 64, geglu d_ff 5,120, vocab 51,866, bf16): 3 steps at B 1,
    1,500 frames, 448 tokens (the encoder's bidirectional attention on
    the naive route: no kernel), 3 prefills at B 4, and decode at B 4
    over the prefill batch's 1,500 encoded frames (cross K/V filled by
    ``encode`` and ``_enc_kv``), 64 steps.  Then at the smoke configs in
    f32: whisper's decode over filled cross K/V against
    ``decode_train``'s logits, and pixtral's prefill with a prefix on the
    card against the CPU, within ``VLM_AUDIO_F32_TOL`` (these comparing
    launches are not counted)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import api, whisper
    from repro_torch.optim import get_optimizer

    dev = torch.device("cuda")
    ex = _decode_example()
    total: dict = {}

    def read():
        launches = {k: v for k, v in _read_launches().items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return launches

    def seeded():
        return torch.Generator(device=dev).manual_seed(seed)

    def prefix(cfg):
        return f"{cfg.n_patches} patches + {VLM_S - cfg.n_patches} tokens"

    # pixtral-12b: training at a cut depth
    arch = "pixtral-12b"
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=PIXTRAL_TRAIN_LAYERS)
    rng = np.random.default_rng(seed)
    batches = [_train_batch(cfg, rng, 1, VLM_S, dev) for _ in range(3)]
    model = api.init_model(cfg, generator=seeded(), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, model, get_optimizer("adam", 1e-2),
                           remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, ms = _timed_steps(step, batches)
    launches = read()
    step_ms = statistics.mean(ms[1:])
    print(f"[lm-vlm-audio] {cfg.name} at full width, {cfg.n_layers} of "
          f"{full.n_layers} layers ({n_params / 1e9:.3f} B parameters, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
          f"{cfg.hd}, vocab {cfg.vocab}, {cfg.dtype}), B 1, {prefix(cfg)}, "
          f"3 steps: {step_ms:.3f} ms per step (mean of steps 1..), "
          f"{VLM_S / step_ms * 1e3:.1f} tokens/s ({VLM_S} positions a "
          f"step); losses {losses}; step ms {[round(x, 3) for x in ms]}; "
          f"peak memory {_peak_gib():.2f} GiB; launches {launches}")
    n = 3 * cfg.n_layers
    check(all(np.isfinite(losses)), "every pixtral loss finite")
    check(launches == {"flash_attention": n, "flash_attention_bwd": n},
          f"B8 and its backward once a layer and step ({launches})")
    _check_bwd_wgmma(n, "pixtral-12b training")
    del model, step, batches
    torch.cuda.empty_cache()

    # pixtral-12b at full depth: prefill with patches, then text decode
    cfg = full
    model = api.init_model(cfg, generator=seeded(), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    batch = _train_batch(cfg, rng, VLM_B, VLM_S, dev)
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times, logits = _timed_calls(lambda: prefill(model, batch), 4)
    check(tuple(logits.shape) == (VLM_B, VLM_S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "pixtral's prefill logits over all P + S positions, finite")
    del logits
    prefill_peak = _peak_gib()
    dargs = ex["build_parser"]().parse_args(
        ["--arch", arch, "--batch", str(VLM_B), "--prompt-len", "64",
         "--gen-len", "64", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    dec = ex["run"](dargs, cfg=cfg, model=model,
                    prompts=batch["tokens"][:, :64].cpu().numpy())
    launches = read()
    seq = dec["sequences"]
    check(launches == {"flash_attention": 4 * cfg.n_layers},
          f"4 prefills ran B8 once a layer each, decode no kernel "
          f"({launches})")
    check(seq.shape == (VLM_B, 128)
          and bool(((seq >= 0) & (seq < cfg.vocab)).all()),
          "pixtral decode emitted tokens of the vocabulary")
    print(f"[lm-vlm-audio] {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}): prefill B {VLM_B} x ({prefix(cfg)}) "
          f"{times[0]:.3f} ms first, {statistics.median(times[1:]):.3f} ms "
          f"(median of 3 after), peak {prefill_peak:.2f} GiB; decode B "
          f"{VLM_B}, prompt 64 + 64 greedy text tokens: p50 "
          f"{dec['step_p50_ms']:.3f} ms, p99 {dec['step_p99_ms']:.3f} ms a "
          f"step, {dec['tok_per_s']:.1f} tok/s, peak {_peak_gib():.2f} GiB; "
          f"launches {launches}")
    del model, batch, prefill
    torch.cuda.empty_cache()

    # whisper-large-v3 at full width and depth
    arch = "whisper-large-v3"
    cfg = get_config(arch)
    model = api.init_model(cfg, generator=seeded(), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    batches = [_train_batch(cfg, rng, 1, AUDIO_FRAMES, dev)
               for _ in range(3)]
    dec_len = batches[0]["tokens"].shape[1]
    step = make_train_step(cfg, model, get_optimizer("adam", 1e-2),
                           remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, ms = _timed_steps(step, batches)
    launches = read()
    step_ms = statistics.mean(ms[1:])
    # the encoder's naive attention keeps, a layer, softmax's f32 output
    # and its bf16 cast for the product with v: 6 bytes a logit
    attn_gib = (cfg.encoder_layers * cfg.n_heads * AUDIO_FRAMES ** 2 * 6
                / 2**30)
    print(f"[lm-vlm-audio] {cfg.name} at full width and depth "
          f"({cfg.encoder_layers} + {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, d {cfg.d_model}, "
          f"{cfg.n_heads} heads, hd {cfg.hd}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), B 1, {AUDIO_FRAMES} frames, {dec_len} tokens, 3 "
          f"steps: {step_ms:.3f} ms per step (mean of steps 1..), "
          f"{(AUDIO_FRAMES + dec_len) / step_ms * 1e3:.1f} positions/s; "
          f"losses {losses}; step ms {[round(x, 3) for x in ms]}; peak "
          f"memory {_peak_gib():.2f} GiB (of which the encoder's saved "
          f"attention probabilities {attn_gib:.2f} GiB); launches "
          f"{launches}")
    check(all(np.isfinite(losses)), "every whisper loss finite")
    check(launches == {}, f"whisper's steps launch no kernel: the encoder "
                          f"is bidirectional, the decoder at {dec_len} < "
                          f"2,048 ({launches})")
    del step, batches
    torch.cuda.empty_cache()

    batch = _train_batch(cfg, rng, AUDIO_B, AUDIO_FRAMES, dev)
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times, logits = _timed_calls(lambda: prefill(model, batch), 3)
    check(tuple(logits.shape) == (AUDIO_B, dec_len, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "whisper's prefill logits (B, 448, V), finite")
    del logits
    prefill_peak = _peak_gib()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        memory = whisper.encode(model, cfg, batch["frames"])
        cache = whisper.fill_cross_kv(
            model, cfg, api.init_decode_cache(cfg, AUDIO_B, AUDIO_FRAMES,
                                              dev), memory)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t) * 1e3
    dargs = ex["build_parser"]().parse_args(
        ["--arch", arch, "--batch", str(AUDIO_B), "--prompt-len", "16",
         "--gen-len", str(AUDIO_DECODE - 15), "--device", "cuda"])
    dec = ex["run"](dargs, cfg=cfg, model=model, cache=cache,
                    prompts=batch["tokens"][:, :16].cpu().numpy())
    launches = read()
    seq = dec["sequences"]
    check(launches == {}, f"whisper's prefill and decode launch no kernel "
                          f"({launches})")
    check(dec["steps"] == AUDIO_DECODE
          and bool(((seq >= 0) & (seq < cfg.vocab)).all()),
          "whisper decode emitted tokens of the vocabulary")
    print(f"[lm-vlm-audio] {cfg.name}: prefill B {AUDIO_B} x ({AUDIO_FRAMES} "
          f"frames, {dec_len} tokens) {times[0]:.3f} ms first, "
          f"{statistics.median(times[1:]):.3f} ms (median of 2 after), peak "
          f"{prefill_peak:.2f} GiB; encode and cross K/V fill "
          f"{encode_ms:.3f} ms; decode B {AUDIO_B} over {AUDIO_FRAMES} "
          f"encoded frames, prompt 16 + {AUDIO_DECODE - 15} greedy, "
          f"{dec['steps']} steps: p50 {dec['step_p50_ms']:.3f} ms, p99 "
          f"{dec['step_p99_ms']:.3f} ms a step, {dec['tok_per_s']:.1f} "
          f"tok/s, peak {_peak_gib():.2f} GiB")
    del model, batch, prefill, memory, cache
    torch.cuda.empty_cache()

    # f32 at the smoke configs
    cfg = get_config(arch, smoke=True)
    model = api.init_model(cfg, generator=seeded(), device=dev)
    b = _train_batch(cfg, np.random.default_rng(seed), 2, 64, dev)
    with torch.no_grad():
        memory = whisper.encode(model, cfg, b["frames"])
        want = whisper.decode_train(model, cfg, b["tokens"], memory)
        cache = whisper.fill_cross_kv(
            model, cfg, api.init_decode_cache(cfg, 2, 64, dev), memory)
        werr = max(float((api.decode_step(
            model, cfg, b["tokens"][:, t:t + 1], cache, t)[0][:, 0]
            - want[:, t]).abs().max()) for t in range(64))
    check(werr <= VLM_AUDIO_F32_TOL,
          f"whisper smoke f32 decode over filled cross K/V within "
          f"{VLM_AUDIO_F32_TOL} of decode_train's logits (max err {werr})")

    cfg = get_config("pixtral-12b", smoke=True)
    cpu = api.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    got = {}
    n0 = _read_launches()
    for d, m in (("cpu", cpu), ("cuda", gpu)):
        bb = _train_batch(cfg, np.random.default_rng(seed), 2, VLM_S, d)
        got[d] = make_prefill_step(cfg)(m, bb).cpu()
    ran = {k: v - n0[k] for k, v in _read_launches().items() if v != n0[k]}
    perr = float((got["cuda"] - got["cpu"]).abs().max())
    check(ran == {"flash_attention": cfg.n_layers},
          f"the smoke prefill at P + S = 2,048 ran B8 once a layer on the "
          f"card ({ran})")
    check(perr <= VLM_AUDIO_F32_TOL,
          f"pixtral smoke f32 prefill with a prefix, card vs CPU within "
          f"{VLM_AUDIO_F32_TOL} (max err {perr})")
    print(f"[lm-vlm-audio] f32 smoke: whisper decode over filled cross K/V "
          f"(64 frames, 64 steps, B 2) against decode_train's logits: max "
          f"abs err {werr:.3g} (tolerance {VLM_AUDIO_F32_TOL}); pixtral "
          f"prefill B 2 x (16 patches + 2032 tokens), card vs CPU: max abs "
          f"err {perr:.3g} (tolerance {VLM_AUDIO_F32_TOL}; |logits| up to "
          f"{float(got['cpu'].abs().max()):.3g}); card launches {ran}")
    return total


# phase 19: the records' fields a traced run must equal bit for bit
TRACE_KEYS = ("step", "loss", "miss_pull", "update_push", "evict_push",
              "cost", "alg1_est", "prefetch_bytes", "demand_miss_bytes",
              "prefetch_hit_rate")
TRACE_LM_LAYERS = RESUME_LM_LAYERS


def _trace_events(path) -> list:
    """The exported Chrome trace read back as the tracer's events
    (seconds, the track by its ``thread_name`` row)."""
    doc = json.loads(Path(path).read_text())
    check(isinstance(doc.get("traceEvents"), list),
          f"{path.name} is a trace_event document")
    names = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M"}
    events = []
    for ev in doc["traceEvents"]:
        check(ev["ph"] in ("X", "M"), f"{path.name}: X and M events only")
        if ev["ph"] == "X":
            check(all(k in ev for k in ("name", "ts", "dur", "pid", "tid")),
                  f"{path.name}: every span has name, ts, dur, pid, tid")
            args = {k: v for k, v in ev["args"].items() if k != "thread"}
            events.append({"name": ev["name"], "track": names[ev["tid"]],
                           "thread": ev["args"]["thread"],
                           "ts": ev["ts"] * 1e-6, "dur": ev["dur"] * 1e-6,
                           "args": args})
    return events


def phase_trace(seed: int) -> dict:
    """Phase 19: observability.  ``repro_torch.launch.train.main`` at
    phase 6's configuration with ``--trace-out`` and ``--validate-timing``
    at depth 1 and 2: the records bit for bit phase 6's and phase 10's
    untraced ones, the launches a step theirs; the exported trace parses,
    with the tracks ``decide``, ``train/0`` (and ``train/1`` at depth 2);
    at depth 2 every ``decide``, ``advance`` and ``train.sync`` span
    carries a positive ``device_ms`` (at depth 1 none does); the depth-2
    ``hidden_frac`` exceeds depth 1's (0).  Then
    ``benchmarks/obs_bench_torch.py``'s ``run(quick=True)`` on the card,
    its artifact schema-gated by ``write_bench`` (the overhead within 3 %
    among them).  Then ``main`` for smollm-360m at full width, its depth
    cut to 4 of 32 layers (``get_config`` patched, as phase 14 cuts it),
    B 4 x S 2,048, 3 steps with ``--trace-out``: one ``train.sync`` span
    a step on ``train/0``, B8 and its backward once a layer and step."""
    import importlib.util
    import tempfile

    import repro_torch.launch.train as T
    from repro_torch.obs import format_report, validate_timing

    total: dict = {}

    def counted(fn):
        """``fn()`` with the counts set to 0 just before and read just
        after: (its result, its launches)."""
        _zero_launches()
        out = fn()
        launches = {k: v for k, v in _read_launches().items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out, launches

    with tempfile.TemporaryDirectory() as td:
        hidden = {}
        for depth, (plain, plain_launch) in ((1, TRAIN_DEPTH1[None]),
                                             (2, TRAIN_DEPTH2[None])):
            path = Path(td) / f"dlrm_depth{depth}.json"
            argv = TRAIN_ARGV + ["--seed", str(seed), "--pipeline-depth",
                                 str(depth), "--trace-out", str(path),
                                 "--validate-timing"]
            out, launches = counted(lambda: T.main(argv))
            recs = out["metrics"]
            per_step = {k: round(v / len(recs), 3)
                        for k, v in launches.items()}
            check([[r.get(k) for k in TRACE_KEYS] for r in recs]
                  == [[r.get(k) for k in TRACE_KEYS]
                      for r in plain["metrics"]],
                  f"traced depth {depth}: every record bit for bit the "
                  f"untraced run's")
            check(per_step == plain_launch,
                  f"traced depth {depth}: the launches a step the untraced "
                  f"run's ({per_step} vs {plain_launch})")
            events = _trace_events(path)
            tracks = {ev["track"] for ev in events}
            want = {"decide"} | {f"train/{s}" for s in range(depth)}
            check(want <= tracks, f"traced depth {depth}: tracks {want} "
                                  f"in the trace ({sorted(tracks)})")
            staged = [ev for ev in events
                      if ev["name"] in ("decide", "advance", "train.sync")]
            check(len(staged) == 3 * len(recs),
                  f"traced depth {depth}: one decide, advance and "
                  f"train.sync span a step")
            if depth == 1:
                check(not any("device_ms" in ev["args"] for ev in events),
                      "depth 1: no span carries device_ms (each ends at a "
                      "synchronise)")
            else:
                check(all(ev["args"].get("device_ms", 0) > 0
                          for ev in staged),
                      "depth 2: every decide, advance and train.sync span "
                      "carries a positive device_ms")
                for name, stage in (("decide", "decide"),
                                    ("advance", "advance"),
                                    ("train.sync", "train")):
                    by_step = sorted((ev["args"]["step"],
                                      ev["args"]["device_ms"])
                                     for ev in staged if ev["name"] == name)
                    check([round(ms, 6) for _, ms in by_step]
                          == [round(x * 1e3, 6)
                              for x in out["stage_s"][stage]],
                          f"depth 2: {name}'s device_ms are the stage's "
                          f"CUDA-event times, step by step")
            report = validate_timing(events, recs)
            hidden[depth] = report["overlap"]["hidden_frac"]
            print(f"[trace] wdl-s1 depth {depth}, traced: wall "
                  f"{out['wall_ms_mean']:.3f} ms a step, untraced (phase "
                  f"{6 if depth == 1 else 10}) {plain['wall_ms_mean']:.3f}; "
                  f"{len(events)} spans; hidden_frac {hidden[depth]}; "
                  f"launches {per_step} a step (the untraced run's)")
            if depth == 2:
                ms = {name: [round(ev["args"]["device_ms"], 3)
                             for ev in staged if ev["name"] == name]
                      for name in ("decide", "advance", "train.sync")}
                print(f"[trace] depth 2 device_ms by step: {ms}")
            print(format_report(report))
        check(hidden[1] == 0.0,
              f"depth 1: no decide time inside a train window ({hidden[1]})")
        check(hidden[2] > hidden[1],
              f"depth 2 hides decide time under train windows "
              f"({hidden[2]} > {hidden[1]})")

        spec = importlib.util.spec_from_file_location(
            "obs_bench_torch", ROOT / "benchmarks" / "obs_bench_torch.py")
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        t = time.perf_counter()
        art = Path(td) / "BENCH_obs_quick.json"
        rep, launches = counted(lambda: bench.run(quick=True, out=art,
                                                  device="cuda"))
        check(art.exists(), "obs_bench_torch wrote its schema-gated "
                            "artifact")
        print(f"[trace] obs_bench_torch --quick on the card in "
              f"{time.perf_counter() - t:.1f} s: bitwise "
              f"{rep['bitwise']}, overhead {rep['overhead']}, overlap "
              f"{rep['overlap']}, trace {rep['trace']}; launches "
              f"{launches}")
        check(launches.get("staged_pull", 0) > 0
              and "staged_gather" not in launches,
              "obs_bench_torch's prefetch pull launched staged_pull")

        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config("smollm-360m"),
                                  n_layers=TRACE_LM_LAYERS)
        real = T.get_config
        T.get_config = lambda arch, smoke=False: cfg
        path = Path(td) / "lm.json"
        try:
            out, launches = counted(lambda: T.main(
                ["--arch", "smollm-360m", "--seq-len", "2048",
                 "--batch-per-worker", "4", "--steps", "3", "--seed",
                 str(seed), "--device", "cuda", "--trace-out", str(path)]))
        finally:
            T.get_config = real
        events = _trace_events(path)
        syncs = [ev for ev in events if ev["name"] == "train.sync"]
        n = cfg.n_layers * 3
        check([ev["args"]["step"] for ev in syncs] == [0, 1, 2]
              and {ev["track"] for ev in syncs} == {"train/0"},
              "LM: one train.sync span a step on train/0")
        check(launches == {"flash_attention": n, "flash_attention_bwd": n},
              f"LM traced: B8 and its backward once a layer and step "
              f"({launches})")
        _check_bwd_wgmma(n, "LM traced")
        check(all(np.isfinite([r["loss"] for r in out["metrics"]])),
              "LM traced: finite losses")
        print(f"[trace] {cfg.name} at full width, {cfg.n_layers} of 32 "
              f"layers, B 4, S 2048, 3 steps traced: train.sync ms "
              f"{[round(ev['dur'] * 1e3, 3) for ev in syncs]}; losses "
              f"{[r['loss'] for r in out['metrics']]}; launches "
              f"{launches}")
    return total


# phase 20: remat and the spec layer.  falcon-mamba-7b's depths tried
# with remat, each a multiple of MAMBA_LAYERS, until one does not fit
REMAT_MAMBA_DEPTHS = (16, 24, 32, 40)
REMAT_MOE_BLOCKS = 4
# the dry runs, with the reference's analytic per-device state bytes on
# the 16x16 mesh (tests/test_torch_dryrun.py holds the port's equal to
# them for every arch and shape)
DRYRUNS = {("smollm-360m", "train_4k"): 964_128_004,
           ("falcon-mamba-7b", "train_4k"): 4_383_096_836,
           ("llama4-scout-17b-a16e", "decode_32k"): 41_686_798_336}
DRYRUN_KEYS = {"arch", "shape", "mesh", "family", "params", "active_params",
               "attn_mode", "lower_s", "compile_s", "state_bytes_per_device",
               "memory_analysis", "cost_analysis", "collectives",
               "hlo_bytes", "cost_analysis_extrapolated",
               "collectives_extrapolated", "probe_compile_s"}


def _remat_run(cfg, seed: int, remat: bool, batches, aux_of=None) -> dict:
    """3 ``make_train_step`` steps (Adam, lr 1e-2) of ``cfg`` from the
    seed's weights, counted from zero: losses, ms a step (each ended by
    a synchronise), peak GiB, launches; with ``aux_of`` (a batch) also
    the trained model's router aux loss on its tokens."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api, backbone
    from repro_torch.optim import get_optimizer

    dev = torch.device("cuda")
    model = api.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    step = make_train_step(cfg, model, get_optimizer("adam", 1e-2),
                           remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    try:
        losses, ms = _timed_steps(step, batches)
        out = {"losses": losses, "ms": ms, "peak": _peak_gib(),
               "launches": {k: v for k, v in _read_launches().items() if v},
               "bwd_routes": _bwd_routes()}
        if aux_of is not None:
            with torch.no_grad():
                out["aux"] = backbone.forward(model, cfg,
                                              aux_of["tokens"])[1].item()
    finally:
        del model, step
    torch.cuda.empty_cache()
    return out


def _fits(cfg, seed: int, remat: bool, batches):
    """``_remat_run``'s record, or None where the card runs out of
    memory."""
    import gc

    try:
        return _remat_run(cfg, seed, remat, batches)
    except torch.cuda.OutOfMemoryError:
        pass
    # out of the handler, the failed step's frames are gone: free them
    gc.collect()
    torch.cuda.empty_cache()
    return None


def phase_remat(seed: int) -> dict:
    """Phase 20: remat and the spec layer.  (a) smollm-360m at full width
    and depth (32 layers, bf16), B 4 x S 2,048, 3 ``make_train_step``
    steps with ``remat=True`` and with ``remat=False`` from the same
    weights: losses bit for bit, B8 twice a layer and step forward with
    remat (the recompute) and its backward once, both peaks and ms a
    step.  (b) falcon-mamba-7b at full width: at ``MAMBA_LAYERS`` layers
    the same pair (bit-equal losses, the remat peak lower), then the
    deepest of ``REMAT_MAMBA_DEPTHS`` that trains with remat, the scan
    twice a layer and step forward and once backward, and the same depth
    without remat out of memory.  (c) phi3.5-moe at full width, 2
    layers, B 1 x S 2,048, ``MOE_BLOCKS = 4`` and remat: finite losses
    and router aux.  (d) ``run_dryrun`` on ``meta`` for ``DRYRUNS``:
    the reference's record keys, its state bytes, the extrapolated
    FLOPs.  Launches from (a) to (c) are counted run by run and summed."""
    from repro_torch.configs import get_config
    from repro_torch.dist import ctx
    from repro_torch.launch import dryrun

    dev = torch.device("cuda")
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def pair(cfg, batches, what):
        runs = {}
        for remat in (True, False):
            runs[remat] = _remat_run(cfg, seed, remat, batches)
            add(runs[remat]["launches"])
        r, n = runs[True], runs[False]
        print(f"[remat] {what}, 3 steps: remat "
              f"{statistics.mean(r['ms'][1:]):.3f} ms a step (mean of steps "
              f"1..), peak {r['peak']:.2f} GiB, launches {r['launches']}; "
              f"no remat {statistics.mean(n['ms'][1:]):.3f} ms, peak "
              f"{n['peak']:.2f} GiB, launches {n['launches']}; losses "
              f"{r['losses']} and {n['losses']}")
        check(all(np.isfinite(r["losses"])), f"{what}: finite losses")
        check(r["losses"] == n["losses"],
              f"{what}: remat and no remat give bit-equal losses")
        check(r["peak"] < n["peak"], f"{what}: the remat peak is lower")
        return r, n

    # (a) smollm-360m at full width and depth
    cfg = get_config("smollm-360m")
    rng = np.random.default_rng(seed)
    batches = [_train_batch(cfg, rng, 4, 2048, dev) for _ in range(3)]
    r, n = pair(cfg, batches, f"{cfg.name} ({cfg.n_layers} layers, "
                              f"{cfg.dtype}), B 4, S 2048")
    L = cfg.n_layers
    check(r["launches"] == {"flash_attention": 2 * 3 * L,
                            "flash_attention_bwd": 3 * L},
          f"smollm-360m with remat: B8 forward twice and backward once a "
          f"layer and step ({r['launches']})")
    check(n["launches"] == {"flash_attention": 3 * L,
                            "flash_attention_bwd": 3 * L},
          f"smollm-360m without remat: B8 once a layer and step each way "
          f"({n['launches']})")
    for run, what in ((r, "with"), (n, "without")):
        _check_bwd_wgmma(3 * L, f"smollm-360m {what} remat",
                         run["bwd_routes"])
    del batches

    # (b) falcon-mamba-7b at full width
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=MAMBA_LAYERS)
    batches = [_train_batch(cfg, rng, 1, 2048, dev) for _ in range(3)]
    r, n = pair(cfg, batches, f"{cfg.name} at full width, {cfg.n_layers} "
                              f"of {full.n_layers} layers, B 1, S 2048")
    deepest, rec = None, None
    for depth in REMAT_MAMBA_DEPTHS:
        got = _fits(dataclasses.replace(full, n_layers=depth), seed, True,
                    batches)
        print(f"[remat] {full.name} at {depth} layers with remat: "
              + ("out of memory" if got is None else
                 f"{statistics.mean(got['ms'][1:]):.3f} ms a step (mean of "
                 f"steps 1..), peak {got['peak']:.2f} GiB, losses "
                 f"{got['losses']}, launches {got['launches']}"))
        if got is None:
            break
        deepest, rec = depth, got
        add(got["launches"])
    check(deepest is not None, "falcon-mamba trains with remat past "
                               f"{MAMBA_LAYERS} layers")
    check(all(np.isfinite(rec["losses"])), "falcon-mamba's deepest remat "
                                           "run: finite losses")
    check(rec["launches"] == {"linear_scan": 2 * 3 * deepest,
                              "linear_scan_bwd": 3 * deepest},
          f"falcon-mamba with remat: the scan twice a layer and step "
          f"forward, once backward ({rec['launches']})")
    without = _fits(dataclasses.replace(full, n_layers=deepest), seed,
                    False, batches)
    if without is not None:
        add(without["launches"])
    print(f"[remat] {full.name} at {deepest} layers without remat: "
          + ("out of memory" if without is None
             else f"peak {without['peak']:.2f} GiB"))
    check(without is None, f"falcon-mamba at {deepest} layers does not fit "
                           f"without remat")
    del batches

    # (c) phi3.5-moe at full width, 2 layers, MOE_BLOCKS = 4
    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    batches = [_train_batch(cfg, rng, 1, 2048, dev) for _ in range(3)]
    ctx.MOE_BLOCKS = REMAT_MOE_BLOCKS
    try:
        r = _remat_run(cfg, seed, True, batches, aux_of=batches[0])
    finally:
        ctx.MOE_BLOCKS = 1
    add(r["launches"])
    aux = r["aux"]
    print(f"[remat] {cfg.name} at full width, {cfg.n_layers} of "
          f"{full.n_layers} layers, B 1, S 2048, MOE_BLOCKS "
          f"{REMAT_MOE_BLOCKS}, remat, 3 steps: "
          f"{statistics.mean(r['ms'][1:]):.3f} ms a step (mean of steps "
          f"1..), peak {r['peak']:.2f} GiB, losses {r['losses']}, router "
          f"aux {aux:.4f}, launches {r['launches']}")
    check(all(np.isfinite(r["losses"])) and np.isfinite(aux) and aux > 0,
          "phi3.5-moe at MOE_BLOCKS 4: finite losses and router aux")
    check(r["launches"] == {"flash_attention": 2 * 3 * cfg.n_layers,
                            "flash_attention_bwd": 3 * cfg.n_layers},
          f"phi3.5-moe with remat: B8 forward twice and backward once a "
          f"layer and step ({r['launches']})")
    _check_bwd_wgmma(3 * cfg.n_layers, "phi3.5-moe with remat",
                     r["bwd_routes"])
    del batches

    # (d) the dry runs, on meta
    for (arch, shape), want in DRYRUNS.items():
        t = time.perf_counter()
        rec = dryrun.run_dryrun(arch, shape, verbose=False)
        ext = rec["cost_analysis_extrapolated"]
        print(f"[dryrun] {arch} x {shape} x {rec['mesh']}: attn_mode "
              f"{rec['attn_mode']}, state_bytes_per_device "
              f"{rec['state_bytes_per_device']:.0f}, extrapolated FLOPs a "
              f"device {ext['flops']:.6g} ({time.perf_counter() - t:.1f} s "
              f"on meta)")
        check(set(rec) == DRYRUN_KEYS, f"the dry-run record has the "
                                       f"reference's keys ({sorted(rec)})")
        check(rec["state_bytes_per_device"] == want,
              f"{arch} x {shape}: state bytes a device equal the "
              f"reference's {want}")
        check(ext["flops"] > 0, f"{arch} x {shape}: FLOPs counted")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--was", type=Path, default=None,
                    help="a checkout of the parent commit (git archive): "
                         "phase 3 times its f32 B8 kernels (forward and "
                         "backward) beside this one's")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    was_libs = phase_build(args.was)
    rec = phase_kernels(args.seed)
    rec.update(phase_train_kernels(args.seed))
    rec.update(phase_quant_kernels(args.seed))
    rec.update(phase_auction_kernels(args.seed))
    rec.update(phase_flash_kernels(args.seed, was_libs))
    rec.update(phase_scan_kernels(args.seed))
    phase_parity(args.seed)
    phase_train_parity(args.seed)
    phase_train_parity(args.seed, codec="int8")
    phase_sim_parity(args.seed)
    before = _routes()
    phase_lm_parity(args.seed)
    phase_lm_decode_parity(args.seed)
    phase_train_pipeline_parity(args.seed)
    phase_train_pipeline_parity(args.seed, PS_PARITY)
    phase_elastic_parity(args.seed)
    phase_ssm_parity(args.seed)
    phase_vlm_audio_parity(args.seed)
    (f0, b0), (f1, b1) = before, _routes()
    print(f"[parity] B8's f32 launches in phase 4, all on the tf32x3 route: "
          f"{f1['tf32x3'] - f0['tf32x3']} forward, "
          f"{b1['tf32x3'] - b0['tf32x3']} backward")
    # launches on the main paths: each run counted from zero, then summed
    launches: dict = {}
    for run in (lambda: phase_serve(args.seed),
                lambda: phase_serve(args.seed, codec="int8", duration=0.5),
                lambda: phase_train(args.seed),
                lambda: phase_train(args.seed, codec="int8"),
                phase_table2,
                lambda: phase_simulate(args.seed),
                lambda: phase_lm_train(args.seed),
                lambda: phase_train_pipeline(args.seed),
                lambda: phase_lm_serve(args.seed),
                lambda: phase_lm_moe(args.seed),
                lambda: phase_simulate_faults(args.seed),
                lambda: phase_train_elastic(args.seed),
                lambda: phase_resume(args.seed),
                lambda: phase_train_ps(args.seed),
                lambda: phase_train_dense(args.seed),
                lambda: phase_lm_ssm(args.seed),
                lambda: phase_lm_vlm_audio(args.seed),
                lambda: phase_trace(args.seed),
                lambda: phase_remat(args.seed)):
        t = time.perf_counter()
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
        print(f"[wall] phase took {time.perf_counter() - t:.1f} s")
    # B5, the row pack and the pack-quantize alone, the standalone bid
    # kernel and the out-of-place staged_gather run on no driver path
    # (phase 3 holds them); every other kernel must have launched on a
    # main path
    for k in SOURCES:
        check(k in ("pooled_lookup_quant", "auction_bids", "gather_rows",
                    "gather_rows_quant", "staged_gather")
              or launches.get(k, 0) > 0, f"{k} launched on a main path")
    for what, r in B1_INPUTS.items():
        print(f"[kernel] pooled_lookup, the {what} table (phases 3, "
              f"{15 if what == 'per-shard' else 16}): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, embedding_bag "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), launches {r['launches']}")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches.get(k, 0),
                    **{"library_ms": None, **rec[k]})
               for k in SOURCES]
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
