#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # 1 GiB blob at the production layout
    python3 chip_smoke.py --blob-mib 256   # a smaller blob
    python3 chip_smoke.py --das-blobs 1024 # fewer blobs in the DAS phase
    python3 chip_smoke.py --pod-only       # the kernels' build, then the pod world alone
    python3 chip_smoke.py --examples-only  # the kernels' build, then the examples alone

Phases, each ended by ``torch.cuda.synchronize()`` so a kernel fault shows in
the phase that caused it; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from the checkout's sources, one ``nvcc`` each, in parallel;
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (``gf_matmul`` also at the serving path's Clay (4,2)
   encode and repair, at the production (10,6) repair, at an N = 8
   (mod 16) decode and at the DAS extension's small-and-wide shapes (one
   put's column and row stages, the batched extension of every blob of
   phase 7, a 1 x k recovery), at the decode of one Clay (4,2) 64 KiB
   chunkset of phases 12-14 and at phase 14's Clay (4,2) MSR repair and DAS
   extension of six blobs, with its ptxas lines printed in phase 1):
   ``gf_matmul`` and ``sample_hash`` with exact equality (their
   arithmetic is exact), ``flash_attention`` within the
   tolerance stated at ``ATTN_TOL``; kernel and plain version timed in turns
   with CUDA events beside the least time the card could take; ``gf_matmul``
   and attention also by their device time from a ``torch.profiler`` trace
   (the ``ms`` they report), attention in turns with
   its earlier CUDA-core kernel and ``scaled_dot_product_attention`` (a
   yardstick the port never calls), with the kernel the dispatch rule picked,
   also at phase 15's microbatch and at phase 16's shapes (hymba: a GQA
   group of 5, hd 64, its training step, serving step and long-mode decode
   over a wrapped and an unfilled 2,048-slot ring; qwen3-moe's prefill) and
   at phase 17's (whisper-tiny non-causal over 1,500 frames: its encoder,
   its cross-attention in training and in decode; deepseek's MLA at hd 192 /
   hd_v 128 through ``models/layers.py``, V at its own width on "tile"'s
   (192, 128) instance, beside SDPA at Ev 128), and "split" with its row
   log-sum-exp at phase 19's decode (a rank's 2 rows over its 2,048 of
   4,096 slots, granite-8b's widths; the second model rank's shard, which
   sees no key, too; hymba's long mode: a
   rank's 1,024 slots of the 2,048-slot ring under the window, after the ring
   wrapped, and the second rank's half before it was written) against
   ``flash_attention_lse_ref``, timed beside SDPA; ``flash_attention_bwd``
   against its plain version within
   ``BWD_TOL`` at phase 15's shape (B 4, S 4096, H 24, Hkv 2, hd 128), at
   phase 16's (B 1, S 4096, H 25, Hkv 5, hd 64), at phase 17's (B 1, S
   4096, H 16, hd 192, hd_v 128: the "wgmma" design's (192, 128) instance)
   and at edge cases (window, explicit positions with Sq != Sk and ragged
   tiles, hd 256, g = 1, rows that see no key; at (192, 128) a window with
   GQA and ragged tiles with rows that see no key), each twice and equal bit
   for bit, the forward with its row log-sum-exp equal to the forward
   without it, timed beside its bound and SDPA's backward (at MLA's shape at
   Ev 192 on a zero-padded V and at Ev 128, its backend named); each case's
   design ("wgmma" up to hd 192 with hd_v up to 128, "mma" above, from the
   launch counts), tiles, stages and instance; phase 1 prints every backward
   kernel's registers and spill bytes from ptxas and fails if a "wgmma"
   kernel spills;
3. the storage path at production size: a (10,6) Clay / 10 MiB-chunkset
   cluster of 24 SPs in 5 DCs, put a seeded blob, read it whole and at 3
   ranges across chunksets, crash 2 SPs and read again, mark one SP
   corrupt and read again, settle; bytes compared with the input, kernel
   launches counted per phase (each must be > 0); the put also extends the
   blob's DAS square (two more launches) and places its 64 shares; the RPC
   node's synchronous ``read_range`` across a chunkset boundary and
   ``read_blob`` of the whole blob;
4. the audit path: the bulk digests of every 1 KiB sample of every chunk
   the put stored, checked against the plain version on the CPU;
5. Clay MSR repair on the same cluster (``RepairCoordinator.repair_all``):
   an SP that lost every chunk (timed, then wiped and repaired again under
   the profiler for device ms and idle share), a crashed SP whose chunks move to new SPs, and two chunks of one chunkset
   (the first through the MDS fallback); every report verified, every MSR repair one
   ``gf_matmul`` launch reading the MSR optimum of helper bytes; then the
   whole blob read back from a cold cache;
6. membership churn on the same cluster (``MembershipPlane``): three epochs
   of seeded crashes, departures and joins above a floor of 21 live SPs,
   the re-dispersal backlog repaired on the card while paid Zipf reads
   replay on the same event loop; no chunkset lost, every read right;
7. data-availability sampling on a fresh ``build_cluster`` (8 SPs, Clay
   (4,2), ``CONFIG.das()``): put ``--das-blobs`` seeded blobs of one square
   each (8 KiB), each put extending its square on the card; one batched
   extension of every blob in exactly two ``gf_matmul`` launches, equal to
   the puts' records (timed, then profiled for device ms and idle share);
   a paid sampling round over every blob (all verified, settlement
   conserves); 5% of the shares of half the blobs withheld, then a round
   whose detection rate must lie within 0.05 of ``1-(1-3/64)^16`` with no
   false detection; a 20,000-sample storm replayed with one SP crashed
   (detections equal the withheld or crashed coordinates drawn); 64
   squares rebuilt on the card from k rows and from k columns;
8. a device encode/decode against the CPU plain path on one chunkset;
9. the put's and a read's steps timed alone over the blob's first 256 MiB
   (partition, device encode, device-to-host copy, host SHA-256 Merkle
   commitments, decode);
10. the device's busy and idle share over a put and a whole read of those
   256 MiB on a fresh cluster, from a ``torch.profiler`` trace of the card
   (kernels, copies and memsets, overlaps merged), and the device ms of all
   ``gf_matmul`` launches in each (kernel events by name);
11. the serving path at yi-9b's published widths, depth cut to 1 layer:
   publish the weights through Shelby, crash an SP, restore them by paid
   k-of-n reads, serve batch 4 x (prompt 8 + 16 generated tokens); the
   served model teacher-forced for two steps on the card and on the CPU
   plain path; decode tok/s as the median of nine warm generations;
12. the cohort fast path in the ``engine`` scenario's world and fleets
   (``repro_torch.scenarios.engine``): 500 SPs,
   50 RPC nodes, 192 single-chunkset blobs at Clay (4,2); Zipf storms of
   10k, 100k and 1M requests through ``session.replay(batch)`` on fresh
   fleets (wall, requests/s, the cohort split, sim p50/p99, goodput,
   ``gf_matmul`` launches of the de-opted decodes; the 10k rung under the
   profiler for the device busy share); no fallback; the 10k digest equal to a heap
   task-per-request replay and to the JAX package's, which also times the
   100k rung for the events/s speedup; settlement conserves;
13. overload control in the ``concurrent`` scenario's world and fleets
   (``repro_torch.scenarios.serving``): 12 SPs
   (a 250 ms straggler, a crashed SP), 3 RPC nodes with 10 Gbps NICs, 400
   Poisson Zipf reads at 200/1000/5000 rps, free-running and with a fetch
   budget of 6; digest, sheds 0/3/26, coalesced legs and both p99s at 5000
   rps equal to the JAX package's, every read's bytes right;
14. the registered scenarios on the card (``repro_torch.scenarios``):
   ``serve_grid``, ``concurrent``, ``background``, ``churn``, ``das`` and
   ``tune_admission`` at full size through ``run_scenario(..., device=
   "cuda")``, not profiled (phases 7, 10 and 12 profile the same
   kernels), every declared SLO a gate; digests
   and headline numbers equal to live CPU runs of the JAX package; then
   ``engine`` with its events/s SLO reported, not raised (the one open
   finding: its 100k speedup), every other number gated; ``churn`` again
   under ``SHELBY_SIMSAN=1`` (same digest) and a sanitized one-epoch
   ``run_sim`` equal to the CPU's; a 3-point sweep of ``tune_admission``'s
   fetch budget whose digests and argmax equal the JAX package's;
15. training over Shelby (``launch/train.py``'s ``train``) at starcoder2-3b's
   published widths, depth cut to 1 layer, on ``build_cluster``: a
   16,777,216-token corpus blob, batches of 8 x 4096 in two microbatches
   (each batch one paid ``get_many``), a coded checkpoint at step 3, an SP crashed
   at step 4, the k-of-n restore equal to the saved state, the SP wiped and
   every chunk repaired (all verified), steps 4-5 again; gates: finite
   losses, ``gf_matmul`` and attention launches, a backward launch per
   layer, microbatch and step; then one step under the profiler and a
   1 x 256 loss and gradient on the card against the CPU plain path;
16. the MoE, SSM, hybrid and embedding-input families (``families_phase``,
   counted as the path ``families``): hymba-1.5b at its published widths,
   depth cut to 2 layers, served from Shelby (publish, an SP crashed, the
   restore equal to the published weights, batch 4 x (8 + 16)), three warm
   generations, the same prompts in long mode (the same tokens), one
   long-mode generation over 2,100 positions past the 2,048-slot ring
   (finite logits, a "split" launch per layer and position), two training
   steps at 1 x 4096 (a "wgmma" backward per layer and step); qwen3-moe at
   its published widths cut to 1 layer, a 1 x 512 prefill (each expert's
   load, the drops); phi-3-vision-smoke through ``launch/train.py``'s
   ``train`` (stub embeddings from the corpus blob, an SP crash, the
   restore, the repair); then the card against the CPU plain path: hymba
   teacher-forced and its 1 x 256 gradient, qwen3-moe's prefill logits,
   falcon-mamba, qwen3-moe and phi-3-vision at smoke widths (gradient and 8
   decode positions), hymba-smoke in long mode over 48 positions;
17. MLA and the encoder-decoder (``mla_encdec_phase``, counted as the path
   ``mla_encdec``): whisper-tiny at its published size (56,477,184
   parameters, nothing cut) served from Shelby over seeded stub frames
   (publish, an SP crashed, the restore equal to the published weights,
   batch 4 x (8 + 16)), three warm generations (the same tokens), two
   training steps at 8 x 448 over 1,500 zero frames ("wgmma" backward);
   deepseek-v2-lite at its published widths cut to 2 layers (its dense layer
   and one MLA + MoE layer, 1,085,287,424 parameters made on the card): a 1
   x 4096 prefill ("tile" at hd 192; each expert's load, the drops), the
   absorbed decode of batch 4 x (8 + 16) (no attention kernel), two training
   steps at 1 x 4096 ("wgmma" backward, (192, 128)); then the card against the CPU plain
   path: whisper's decode (over zero frames; over the seeded ones, and
   deepseek's 1 x 256 prefill logits, within 0.15 plus three times the
   CPU's own bf16 error: attention one-hot at init, ROADMAP Queue 3 item 5)
   and 1 x 64 gradient over seeded frames; both at smoke widths
   (whisper-smoke's decode relative to the CPU's own error too); deepseek at
   published widths is not held against the CPU (cut for time);
18. the dry-run against the card (path ``dryrun``): for starcoder2-3b
   train_4k (16 x 4096 in 4 microbatches), yi-9b decode_32k (batch 8 over
   32,768 slots), hymba-1.5b long_500k (batch 1 at position 524,287 over its
   ring) and deepseek-v2-lite prefill_32k (2 x 32,768), at published widths
   with depth cut to 2 layers and the single-pod mesh's per-device batch,
   ``launch/dryrun.py::estimate`` predicts the step's peak memory and FLOPs
   on the meta device; the card runs the same step (after a warm run) from
   ``reset_peak_memory_stats``: the arguments plus what it allocated above
   the memory held at the reset within 15% of the prediction, the
   arguments' bytes equal, and the attention launches equal to those the
   trace declared; the step's wall time and FLOPs per second as a share of
   the bf16 peak printed;
19. the mesh (path ``mesh``, ``mesh_phase``): a 2 x 2 ("data", "model")
   world of four processes on the one card over Gloo (``launch/mesh.py``),
   granite-8b at published widths with depth cut to 1 and fan-in scaled
   weights that rank 0 makes on the card and hands out as every rank's
   shards; every rank serves a generation with ``ServeEngine`` and a
   ``MeshCtx`` (batch 4 over data, a 4,096-slot cache over model: "split"
   with lse, the partial attentions combined), then a train step of 4 x 4096
   in 2 microbatches with ``shard_grad_accum``; qwen3-moe's widths at one
   layer, the expert-parallel MoE over 1 x 4096; then every other family on
   the same world: hymba-1.5b at published widths cut to 2 layers (served,
   long mode teacher-forced at positions 2,040-2,060 from a seeded whole
   2,048-slot ring split 1,024 slots a rank, one 2 x 4096 step), whisper-tiny
   whole (served over seeded frames, one step), falcon-mamba, deepseek-v2-lite
   and phi-3-vision at smoke widths (served, one step); a hymba-smoke train
   state checkpointed from the mesh through rank 0's Shelby cluster (an SP
   loses its chunks, the repair, the restore into the mesh and into one
   process, the bytes one process writes); launches counted per rank and
   block, each rank's peak memory and collective bytes printed; then against
   one process on the card: the MoE, the losses, and gates on decode logits,
   caches and the gradient of every family, which three faults planted in
   the mesh (the combine ignoring lse, the data replicas' gradients not
   summed, hymba's in_proj split contiguously) must fail; the f32 partial
   products timed against bf16.  Then the pod world (path ``mesh_pod``,
   ``pod_phase``): a 2 x 2 x 2 ("pod", "data", "model") world of eight
   processes on the card, granite-8b as above served (batch 4 over ``("pod",
   "data")``, a row a rank), prefilled (4 x 4096) and trained (8 x 4096 in 2
   microbatches, FSDP over ``("pod", "data")``), qwen3-moe's MoE layer over 4
   x 1024 tokens (data over both axes); against one process on the card
   under the same gates, which a planted fault (the ``("pod", "data")``
   ranks taken data-major) must fail; rank 0's collectives equal to the
   dry-run's trace on a 2 x 2 x 2 mesh; each rank's peak and bytes per
   collective kind printed.  Four or eight ranks share one card: nothing
   here measures multi-GPU speed;
20. the port's six examples (path ``examples``, ``examples_phase``):
   ``examples/torch/*.py`` run in this process on the card at their own
   sizes (``video_streaming`` at 24 MiB in 1 MiB chunksets), their asserts
   the gates, then each with ``--device cpu``: every printed line equal but
   the wall clock; ``gf_matmul`` launches in each, ``serve_llm``'s attention
   one "split" launch a layer and decode step;
21. the script's seconds, the card again, one JSON line per kernel, then the
   result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the nearest listed integer rate
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
H100_FP32_OPS_PER_S = 67e12  # 32-bit CUDA-core peak (fp32), the rate of sample_hash's u32 ops
KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "gf_matmul": ("src/repro_torch/kernels/csrc/gf_matmul.cu",
                  "src/repro/kernels/gf_matmul.py:69"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "sample_hash": ("src/repro_torch/kernels/csrc/sample_hash.cu",
                    "src/repro/kernels/sample_hash.py:49"),
    # no Pallas kernel: the JAX package lets XLA differentiate this function
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:123"),
}
# flash_attention against its plain version: f32 to summation order; bf16
# outputs are the same f32 result rounded, so within one rounding step
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2**-7, 2**-7)}  # (atol, rtol)
# flash_attention_bwd (bf16) against its plain version (f32 inside): each of dq, dk, dv
# within BWD_TOL of its largest entry; the kernel rounds P and dS to bf16 as tensor-core
# operands (2^-9 relative per term) and each gradient to bf16 once
BWD_TOL = 2**-6
# the row log-sum-exp of the forward kernel against the plain version's, absolute
LSE_ATOL = 1e-3
# phase 15: training over Shelby at starcoder2-3b's published widths, depth cut 30 -> 1 (2
# until PR 27: its checkpoint's host-bound save, restore and repair took 146 s of a run)
TRAIN_ARCH, TRAIN_LAYERS = "starcoder2-3b", 1
TRAIN_CORPUS_TOKENS = 16 * 2**20  # 64 MiB of seeded int32 tokens, one blob
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 4096, 2  # train_4k's sequence
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 5, 3, 4
TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 1, 256  # the card-vs-CPU step
# the card-vs-CPU step, bf16 on both (rounded at different places: cuBLAS and the CPU's
# products, the kernels' bf16 P and dS): loss within TRAIN_LOSS_ATOL; gradients (one
# vector of every parameter) within TRAIN_NOISE_FACTOR times bf16's own error on the CPU
# (bf16 against f32 compute there) plus TRAIN_GRAD_FLOOR of their norm.  At the JAX
# package's initial weights the attention scores have a spread of ~440 (its "scaled" init
# divides by the head count, ROADMAP Queue 3 item 5): the softmax is one-hot to bf16
# precision and the q/k gradients are rounding noise in any bf16 computation
TRAIN_LOSS_ATOL, TRAIN_NOISE_FACTOR, TRAIN_GRAD_FLOOR = 0.02, 3.0, 0.01
SERVE_ARCH, SERVE_LAYERS = "yi-9b", 1  # published widths; depth cut from 48 (host-bound publish)
# phase 16: the MoE, SSM, hybrid and embedding-input families
FAMILY_ARCH, FAMILY_LAYERS = "hymba-1.5b", 2  # published widths; depth cut from 32
FAMILY_WARM = 3  # warm generations of the served hybrid, the median reported
FAMILY_LONG_POSITIONS = 2100  # one long-mode generation past hymba's 2,048-slot ring
FAMILY_TRAIN_SEQ = 4096  # one sequence of train_4k's length
FAMILY_TRAIN_STEPS = 2
FAMILY_MOE_ARCH, FAMILY_MOE_LAYERS, FAMILY_MOE_SEQ = "qwen3-moe-30b-a3b", 1, 512  # from 48
FAMILY_SMOKE_ARCHS = ("falcon-mamba-7b", "qwen3-moe-30b-a3b", "phi-3-vision-4.2b")
FAMILY_SMOKE_BATCH, FAMILY_SMOKE_SEQ, FAMILY_SMOKE_DECODE = 2, 64, 8
FAMILY_SMOKE_LONG = 48  # positions past hymba-smoke's 32-slot window
# phase 17: MLA (deepseek-v2-lite) and the encoder-decoder (whisper-tiny)
ENCDEC_ARCH = "whisper-tiny"  # its published config, nothing cut
ENCDEC_WARM = 3  # warm generations, the median reported
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 448  # 448: whisper's published text context
ENCDEC_CMP_SEQ = 64  # the card-vs-CPU gradient: 1 x 64 tokens over 1,500 seeded frames
MLA_ARCH, MLA_LAYERS = "deepseek-v2-lite-16b", 2  # published widths; depth cut from 27
MLA_SEQ = 4096  # train_4k's sequence: the prefill and the training steps
MLA_ENCDEC_SMOKE = (MLA_ARCH, ENCDEC_ARCH)
# phase 18: the dry-run against the card, at published widths with depth cut to 2 layers,
# each cell at its per-device batch on the single-pod (16 x 16) mesh: global batch / 16
DRYRUN_LAYERS = 2
DRYRUN_PEAK_TOL = 0.15  # measured peak within 15% of the prediction
# and the measured temporaries (peak less arguments) within 5% of the predicted ones or
# 256 KiB, whichever is larger: the caching allocator rounds each block to 512 B, so 256 KiB
# is 512 blocks' rounding.  Without it a decode cell's gate would barely see the
# temporaries, which are ~1% of its peak (yi-9b decode_32k: 17.4 MB of 2.8 GB)
DRYRUN_TEMP_TOL, DRYRUN_TEMP_SLACK = 0.05, 256 * 1024


def _dryrun_cells():
    from repro_torch.configs.base import ShapeCell

    return [("starcoder2-3b", ShapeCell("train_4k", 4096, 16, "train")),
            ("yi-9b", ShapeCell("decode_32k", 32768, 8, "decode")),
            ("hymba-1.5b", ShapeCell("long_500k", 524288, 1, "decode")),
            ("deepseek-v2-lite-16b", ShapeCell("prefill_32k", 32768, 2, "prefill"))]


# warm decode is host-bound and single generations swing by a third: the median of nine
# phase 19 (the mesh): a 2 x 2 ("data", "model") world of four processes on the one card
MESH_ARCH, MESH_LAYERS = "granite-8b", 1  # published widths, depth 36 -> 1 (see below)
MESH_DATA, MESH_MODEL = 2, 2
MESH_SLOTS = 4096  # the decode cache, split over model: 2,048 slots a rank
MESH_BATCH, MESH_PROMPT, MESH_GEN = 4, 8, 16  # the batch over data: 2 rows a rank
MESH_GENERATIONS = 2  # the first pays one-time costs; the second is timed for tok/s
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_MICROBATCHES, MESH_TRAIN_STEPS = 4, 4096, 2, 1
MESH_GRAD_BATCH, MESH_GRAD_SEQ = 2, 64  # the gradient: its f32 yardstick runs on the CPU
# The phase's first full run (2 layers, 2 train steps) took 237 s of a script that ended at
# 1,191 s: one layer and one step keep the script inside its 1,200 s (PERF.md section 5)
MESH_TF_SLOTS = 32  # the teacher-forced comparison's cache: 16 slots a rank, so that the
# 23 decode positions reach the second model rank's shard and two partial attentions combine
MESH_MOE_ARCH, MESH_MOE_SEQ = "qwen3-moe-30b-a3b", 4096  # 1 layer: 128 experts, 64 a rank
MESH_MOE_ATOL, MESH_AUX_ATOL = 0.05, 1e-5
MESH_CACHE_NOISE_FACTOR = 3.0  # the caches' relative L2 distance from one process's, in
# multiples of that process's own bf16 error (its caches against f32 compute)
MESH_PREFILL_SEQ = 4096  # the prefill under SERVE_RULES: MESH_BATCH x 4096 tokens, 2 rows
# and 2,048 cache slots a rank
MESH_PREFILL_CACHE_FLOOR = 0.01  # its cache: within 3x the one process's own error + this
# every other family in the same world
MESH_HYMBA_LAYERS = 2  # hymba-1.5b's published widths, depth 32 -> 2, as phase 16
MESH_LONG_POSITIONS = range(2040, 2061)  # long mode teacher-forced across the 2,048-slot ring's
# wrap (1,024 slots a rank) from a seeded whole ring: no 2,000 decode steps to get there
MESH_HYMBA_TRAIN = (2, 4096)  # one step of two train_4k rows, a row a data rank
MESH_WHISPER_TRAIN = (2, 64)  # whisper-tiny, 64 tokens over 1,500 seeded frames
MESH_SMOKE_ARCHS = ("falcon-mamba-7b", "deepseek-v2-lite-16b", "phi-3-vision-4.2b")
MESH_SMOKE_TRAIN = (4, 64)
MESH_TIMEOUT = 900  # seconds the world may take, or it fails
# phase 19's pod world: a 2 x 2 x 2 ("pod", "data", "model") world of eight processes on the
# one card, granite-8b as above; the batches over ("pod", "data")
POD_WORLD = (2, 2, 2)  # pod, data, model
POD_TRAIN_BATCH = 8  # 8 x 4096 in MESH_MICROBATCHES microbatches: 2 rows a (pod, data) rank
POD_GRAD_BATCH = 4  # the gradient's rows, one a (pod, data) rank
POD_MOE_BATCH, POD_MOE_SEQ = 4, 1024  # qwen3-moe at 1 layer: a row a (pod, data) rank
# phase 20: the port's examples (examples/torch/), on the card and on the CPU
EXAMPLES = ("quickstart", "repair_storm", "audit_epoch", "multi_rpc_cdn", "video_streaming",
            "serve_llm")
EXAMPLE_WALL = re.compile(r" \[decode wall [0-9.]+s on [^\]]+\]")  # video_streaming's clock
WARM_GENERATIONS = 9
CHURN_EPOCHS = 3
CHURN_READS = 300  # paid Zipf reads replayed beside the churned epochs
# half the largest batch of the JAX package's DAS sweep (benchmarks/gf_kernel.py): the puts
# are host-bound (84 s of a run at 4,096); 1,024 withheld-from trials keep the detection
# rate's gate at ~3.2 sigma
DAS_BLOBS = 2048
BREAKDOWN_MIB = 256  # phases 9 and 10 time and profile a put and a read of the blob's prefix
DAS_WITHHOLD = 0.05  # of a square's 64 shares: exactly 3 withheld
DAS_STORM = 20_000  # samples in the replayed storm
DAS_STORM_GAP_MS = 0.05
DAS_REBUILT = 64  # squares reconstructed on the card
DAS_RATE_TOL = 0.05  # detection rate vs 1-(1-q)^s over 1,024 withheld-from squares: ~3.2 sigma
# the `engine` scenario's ramp (repro_torch/scenarios/engine.py, as the JAX package's)
ENGINE_HEAP_RUNGS = (10_000, 100_000)  # rungs also replayed task-per-request on the heap
ENGINE_PROFILED = (10_000,)  # rungs under the profiler (device busy share)
ENGINE_DIGEST_10K = "5cb923036ace9559"  # a live run of the JAX package on the CPU
# the `concurrent` scenario (repro_torch/scenarios/serving.py): 400 Poisson Zipf reads
# through 3 nodes with 10 Gbps NICs, free-running and with a fetch budget of 6
OVERLOAD_RATES = (200, 1000, 5000)
OVERLOAD_REQUESTS = 400
OVERLOAD_DIGEST_200 = "f691cbe9e5a3bbdf"  # live JAX package runs on the CPU, as these:
OVERLOAD_SHED = {200: 0, 1000: 3, 5000: 26}  # admitted sheds per rate
OVERLOAD_COALESCED_5000 = 313
OVERLOAD_P99_5000 = {"free": 1894.4, "admitted": 67.0}  # ms, to 0.1
# phase 14: the registered scenarios at full size; digests and headline numbers
# from live runs of the JAX package on the CPU (`concurrent` prints its digest)
SCENARIOS = ("serve_grid", "concurrent", "background", "churn", "das", "tune_admission")
SCENARIO_DIGESTS = {"concurrent": "f691cbe9e5a3bbdf", "churn": "1bc184e8531f028f",
                    "das": "85ab3ef5108a7122", "tune_admission": "c1556c3dd6076921"}
SCENARIO_HEADLINES = {
    "serve_grid": {"affinity_zipf.goodput_mbps": 963.7652444759353,
                   "affinity_zipf.p99_ms": 67.34528218908011,
                   "affinity_zipf.cache_hit_rate": 0.944},
    "concurrent": {"5000rps.admitted.p99_ms": 66.9937597276077,
                   "5000rps.free.p99_ms": 1894.3813484713874,
                   "5000rps.admitted.shed_rate": 0.065,
                   "5000rps.admitted.goodput_mbps": 1450.6629631907954},
    "background": {"p99_inflation": 1.025824167285706, "audit_ops": 168, "repairs_ok": 20,
                   "background_bytes": 1706608},
    "churn": {"p99_inflation": 1.1296410686942202, "lost_chunksets": 0, "sps_departed": 4,
              "repairs_enqueued": 65},
    "das": {"bytes_to_detect": 2694.289303289303, "storm.detections": 33,
            "streaming.cache_hit_under_storm": 0.8466666666666667,
            "streaming.p99_under_storm_ms": 80.71843664552334},
    "tune_admission": {"goodput_mbps": 1275.2513420433397, "p99_ms": 67.77299059450574,
                       "shed_rate": 0.14, "digest": "c1556c3dd6076921"},
}
# the `engine` SLO the card does not meet (events/s speedup at 100k, ROADMAP Queue 2
# item 4): reported with its value, never raised; every other SLO stays a gate
ENGINE_OPEN_SLO = "speedup_events_per_sec_100k"
# a sweep of tune_admission's fetch budget: each point's digest, as the JAX package's
SWEEP_FETCHES = (3, 6, 12)
SWEEP_DIGESTS = {None: "c1556c3dd6076921", 3: "c3f6770a6d6255d4", 6: "c1556c3dd6076921",
                 12: "875830cd51af074f"}  # None: the baseline, the registered budget of 6
SWEEP_BEST = 12


_STARTED = time.perf_counter()


def _phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _STARTED:.1f} s)", flush=True)


def _time_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gf_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for C = A (x) B: each input byte read once, each output
    byte written once, or 2*M*K*N operations at the int8 peak."""
    bytes_ms = (m * k + k * n + m * n) / H100_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * k * n / H100_INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def gf_shapes(blob_mib: int, das_blobs: int) -> dict[str, tuple[int, int, int]]:
    """The (M, K, N) shapes at which phase 2 times ``gf_matmul``, by name:
    Clay (10,6) at the production layout (M 6; K 12 known flats per plane,
    10 data + 2 virtual) for a blob of ``blob_mib`` MiB, one MSR repair at
    (10,6) (6 column nodes from 12 known flats over alpha/q = 36 repair
    planes), the serving path's Clay (4,2) encode and repair, and the DAS
    extension (``CONFIG.das()``: k parity lines from k data lines per axis)
    of one put and of ``das_blobs`` squares at once, one line of each of
    ``das_blobs`` squares rebuilt from k, the engine, overload and scenario
    phases' decode of one Clay (4,2) 64 KiB chunkset, and the scenario
    phase's MSR repair at that layout and DAS extension of its six blobs."""
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.storage.blob import BlobLayout

    lay = CONFIG.layout
    alpha, w, m, kk = lay.code.alpha, lay.w, lay.m, lay.code.N - lay.m
    n_cs = -(-blob_mib * 2**20 // lay.chunkset_bytes)
    serve = build_cluster(device="cuda")[2].layout
    shapes = {"encode_one_chunkset": (m, kk, alpha * w),
              "ragged_byte_path": (m, kk, 3 * alpha * w + 17)}
    shapes.update({f"decode_{g}_planes": (m, kk, g * w * n_cs) for g in (6, 48, 60, 102)})
    shapes["encode_blob"] = (m, kk, alpha * w * n_cs)  # the put's encode of the whole blob
    # an odd plane group x an odd chunkset count: N = 8 (mod 16), the 8-byte path
    shapes["decode_5_planes_8byte_path"] = (m, kk, 5 * w * (n_cs | 1))
    # as many chunksets as one solve stacks
    shapes["serve_encode_clay_4_2"] = (
        serve.m, serve.code.N - serve.m,
        serve.code.alpha * serve.w * serve.code.stack_limit(serve.w))
    # one MSR repair: q unknown column nodes from N - q known flats, every repair plane
    shapes["repair_10_6"] = (m, kk, alpha // m * w)
    shapes["serve_repair_clay_4_2"] = (serve.m, serve.code.N - serve.m,
                                       serve.code.alpha // serve.m * serve.w)
    dk, ds = CONFIG.das().k, CONFIG.das().share_bytes
    shapes["das_put_col"] = (dk, dk, dk * ds)  # columns: (k, B*k*S), B = 1
    shapes["das_put_row"] = (dk, dk, 2 * dk * ds)  # rows: (k, B*2k*S)
    shapes["das_batch_col"] = (dk, dk, das_blobs * dk * ds)
    shapes["das_batch_row"] = (dk, dk, das_blobs * 2 * dk * ds)
    shapes["das_recover_1xk"] = (1, dk, das_blobs * ds)
    # the engine and overload phases: one Clay (4,2) 64 KiB chunkset decoded from
    # its k data chunks (both parities unknown: one product over every plane)
    eng = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device="cuda")
    shapes["engine_decode_clay_4_2"] = (eng.m, eng.code.N - eng.m, eng.code.alpha * eng.w)
    shapes["scenario_repair_clay_4_2"] = (eng.m, eng.code.N - eng.m,
                                          eng.code.alpha // eng.m * eng.w)
    shapes["scenario_das_col"] = (dk, dk, 6 * dk * ds)  # background/das: six blobs at once
    shapes["scenario_das_row"] = (dk, dk, 6 * 2 * dk * ds)
    return shapes


def _traced(fn) -> tuple[float, list[dict]]:
    """Run ``fn`` under ``torch.profiler`` with CUDA activity only; return
    its wall seconds and the card's activities as trace-style events
    (``cat`` kernel, gpu_memcpy or gpu_memset; ``ts`` and ``dur`` in
    microseconds), read from the profiler's own kineto events: no
    chrome-trace file is written and parsed.  The program's span marks
    (``trace_mark_kernel<N>``, launched while a profiler records) are left
    out, so that no device time or busy share here counts them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation", bool)():
            continue
        name = e.name()
        if "trace_mark_kernel" in name:
            continue
        cat = ("gpu_memcpy" if name.startswith("Memcpy")
               else "gpu_memset" if name.startswith("Memset") else "kernel")
        events.append({"ph": "X", "cat": cat, "name": name, "ts": e.start_ns() / 1e3,
                       "dur": e.duration_ns() / 1e3})
    return wall, events


PROFILER_TRIES = 3  # a trace now and then comes back without its kernel events


def _device_ms(fn, iters: int) -> tuple[float, int]:
    """Device time per call of ``fn``: the durations of the CUDA kernels in a
    ``torch.profiler`` trace of ``iters`` calls (after one untraced call),
    summed and divided by ``iters``; and the number of traces it took.  Host
    time between launches is left out.  A trace without kernel events is
    taken again, up to ``PROFILER_TRIES`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILER_TRIES + 1):
        _, events = _traced(lambda: [fn() for _ in range(iters)])
        kernels = [float(e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels:
            return sum(kernels) / iters / 1e3, tries  # trace times are microseconds
    raise SystemExit(f"{PROFILER_TRIES} profiler traces show no kernel on the card")


def device_busy(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``; return its wall seconds and the
    seconds the card spent in kernels, copies or memsets (the union of their
    intervals from the trace)."""
    wall, events = _traced(fn)
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in spans:
            spans[e["cat"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def union_s(intervals) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in sorted(intervals):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6  # trace times are microseconds

    every = [iv for ivs in spans.values() for iv in ivs]
    busy = union_s(every)
    gf = [float(e["dur"]) for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
          and "gf_matmul" in e.get("name", "")]
    return {"wall_s": wall, "device_busy_s": busy if every else None,
            "kernel_s": union_s(spans["kernel"]), "copy_s": union_s(spans["gpu_memcpy"]),
            "device_events": len(every),
            "idle_share": 1.0 - busy / wall if every else None,
            "gf_matmul_kernels": len(gf), "gf_matmul_device_ms": sum(gf) / 1e3}


def check_gf_matmul(shapes, gen, timed: set) -> list[dict]:
    import torch

    from repro_torch.kernels import gf_matmul as gk

    rows = []
    for m, k, n in shapes:
        a = torch.randint(0, 256, (m, k), dtype=torch.uint8, device="cuda", generator=gen)
        if m > 1:
            a[m // 2] = 0  # an all-zero coefficient row
        b = torch.randint(0, 256, (k, n), dtype=torch.uint8, device="cuda", generator=gen)
        out = gk.gf_matmul(a, b)
        ref = gk.gf_matmul_ref(a, b)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum())
        max_err = int((out.int() - ref.int()).abs().max())
        row = {"m": m, "k": k, "n": n, "mismatches": mismatches, "max_abs_err": max_err}
        if (m, k, n) in timed:
            iters = 10 if n > 10**7 else 50
            plain_a = _time_ms(lambda: gk.gf_matmul_ref(a, b), 2)
            kern_a = _time_ms(lambda: gk.gf_matmul(a, b), iters)
            kern_b = _time_ms(lambda: gk.gf_matmul(a, b), iters)
            plain_b = _time_ms(lambda: gk.gf_matmul_ref(a, b), 2)
            # device time from a profiler trace: at small N the wrapper's host
            # time per call exceeds the kernel's, and CUDA events around a
            # loop of calls measure the host
            dev, traces = _device_ms(lambda: gk.gf_matmul(a, b), iters)
            bound, by = gf_bound_ms(m, k, n)
            row.update(ms=dev, host_ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=bound, bound_by=by, traces=traces)
        print(json.dumps({"gf_matmul_check": row}), flush=True)
        if mismatches:
            raise SystemExit(f"gf_matmul disagrees with its plain version at {(m, k, n)}")
        rows.append(row)
        del a, b, out, ref
    torch.cuda.synchronize()
    return rows


def sample_hash_bound_ms(leaves: int, words: int) -> tuple[float, str]:
    """Least time for the digests: each word read once, each digest written
    once, or 4 u32 operations per word plus 8 per digest at the 32-bit rate."""
    bytes_ms = 4 * leaves * (words + 1) / H100_BYTES_PER_S * 1e3
    ops_ms = leaves * (4 * words + 8) / H100_FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_sample_hash(cases, gen, timed: set) -> list[dict]:
    import torch

    from repro_torch.kernels import sample_hash as sh

    rows = []
    for leaves, words, seed in cases:
        w = torch.randint(-2**31, 2**31, (leaves, words), dtype=torch.int32, device="cuda",
                          generator=gen).view(torch.uint32)
        out = sh.sample_hash(w, seed=seed).view(torch.int32)
        ref = sh.sample_hash_ref(w, seed=seed).view(torch.int32)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum())
        row = {"leaves": leaves, "words": words, "seed": seed, "mismatches": mismatches,
               "max_abs_err": int((out.long() - ref.long()).abs().max())}
        if (leaves, words, seed) in timed:
            plain_a = _time_ms(lambda: sh.sample_hash_ref(w, seed=seed), 2)
            kern_a = _time_ms(lambda: sh.sample_hash(w, seed=seed), 20)
            kern_b = _time_ms(lambda: sh.sample_hash(w, seed=seed), 20)
            plain_b = _time_ms(lambda: sh.sample_hash_ref(w, seed=seed), 2)
            bound, by = sample_hash_bound_ms(leaves, words)
            row.update(ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=bound, bound_by=by, library_ms=None)
        print(json.dumps({"sample_hash_check": row}), flush=True)
        if mismatches:
            raise SystemExit(f"sample_hash disagrees with its plain version at {(leaves, words)}")
        rows.append(row)
        del w, out, ref
    torch.cuda.synchronize()
    return rows


def attention_bound_ms(q, k, vis) -> tuple[float, str]:
    """Least time for attention with the (Sq, Sk) visibility ``vis``: 4 * hd
    operations per visible (query, key) pair and query head at the bf16 peak,
    or Q and O moved once, K and V once for each slot some query sees (a
    slot no query sees need not be read) and both position arrays once."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ops_ms = 4.0 * hd * int(vis.sum()) * b * h / H100_BF16_FLOPS * 1e3
    kv_bytes = 2 * b * int(vis.any(0).sum()) * hkv * hd * k.element_size()
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + 4 * (sq + sk)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _launched_design(fn):
    """(fn's result, the variant and the "tile" design, or None, that its one launch took)."""
    from repro_torch.kernels import flash_attention as fa

    variants = dict(fa.flash_attention.variant_launches)
    designs = dict(fa.flash_attention.design_launches)
    out = fn()
    ran = [n for n, c in fa.flash_attention.variant_launches.items() if c > variants[n]]
    design = [n for n, c in fa.flash_attention.design_launches.items() if c > designs[n]]
    assert len(ran) == 1 and len(design) == (ran == ["tile"]), (ran, design)
    return out, ran[0], design[0] if design else None


def check_flash_attention_ptxas() -> dict[str, dict]:
    """The forward kernels' registers and spill bytes from ptxas; fails if a
    "wgmma" kernel spills (or none is reported)."""
    from repro_torch.kernels import _build

    lines = _build.ptxas_report("flash_attention")
    regs, spills = ptxas_registers(lines), ptxas_spills(lines)
    if not any("wgmma" in k for k in spills) or any(n for k, n in spills.items() if "wgmma" in k):
        raise SystemExit(f"flash_attention: a wgmma kernel spills (or no ptxas report): {spills}")
    return {name: {"registers": regs.get(name), "spill_bytes": spills.get(name)} for name in regs}


def check_flash_attention(cases, gen) -> list[dict]:
    """cases: (name, b, sq, sk, h, hkv, hd, causal, window, q_positions, k_positions).

    Each case: the kernel the wrapper's rule picks (its variant, and for
    "tile" its design, which must be the one ``tile_design`` names) against
    the plain version within ``ATTN_TOL``, a second call equal bit for bit
    and, for "tile", the row log-sum-exp within ``LSE_ATOL`` of the plain
    version's with the output unchanged by asking for it; then timed in
    turns with the kernel it replaced (``previous``: the "mma" design for a
    row that "wgmma" takes, else the earlier CUDA-core "general" kernel) and
    with ``scaled_dot_product_attention`` (``library``): CUDA events around
    a loop of calls give the host-inclusive time per call (``*host_ms``); a
    ``torch.profiler`` trace of the same calls gives the device time per
    call (``ms``, ``previous_ms``, ``library_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    rows = []
    for name, b, sq, sk, h, hkv, hd, causal, window, qpos, kpos in cases:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
        kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
        out, variant, design = _launched_design(lambda: fa.flash_attention(q, k, v, **kw))
        same = torch.equal(out, fa.flash_attention(q, k, v, **kw))
        ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
        lse_err, same_o = None, True
        if variant == "tile":  # the training forward: the same O and its lse
            o_lse, lse = fa.flash_attention_lse(q, k, v, **kw)
            same_o = torch.equal(o_lse, out)
            lse_err = float((lse - lse_ref).abs().max())
            del o_lse, lse
        del lse_ref
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        atol, rtol = ATTN_TOL["bfloat16"]
        bad = int((err > atol + rtol * ref.float().abs()).sum())
        vis = fa.visible(qpos, kpos, causal, window)
        # the library yardstick: SDPA on (B, H, S, hd) views; its boolean mask is "may attend"
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        arange = sq == sk and torch.equal(qpos, torch.arange(sk, dtype=qpos.dtype, device="cuda"))
        mask = None if (causal and not window and arange) else vis
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)

        seen = vis.any(1)  # SDPA gives NaN for a row that sees no key
        lib_err = float((lib().transpose(1, 2).float() - ref.float())[:, seen].abs().max())
        def kern():
            return fa.flash_attention(q, k, v, **kw)

        previous = "mma" if design == "wgmma" else "general"

        def prev():
            if previous == "mma":
                return fa.flash_attention_variant("tile", q, k, v, design="mma", **kw)
            return fa.flash_attention_variant("general", q, k, v, **kw)

        iters = 20 if sq * sk < 10**6 else 5
        plain_a = _time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 3)
        host = {"previous": [_time_ms(prev, iters)], "kernel": [_time_ms(kern, iters)]}
        host["library"] = [_time_ms(lib, iters)]
        host["kernel"].append(_time_ms(kern, iters))
        host["previous"].append(_time_ms(prev, iters))
        plain_b = _time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 3)
        dev, traces = {}, 0
        for what, fn in (("kernel", kern), ("previous", prev), ("library", lib)):
            dev[what], tries = _device_ms(fn, iters)
            traces += tries
        bound, by = attention_bound_ms(q, k, vis)
        row = {"case": name, "shape": [b, sq, sk, h, hkv, hd], "causal": causal,
               "window": window, "dtype": "bfloat16", "variant": variant, "design": design,
               "violations": bad, "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err,
               "deterministic": same, "forward_with_lse_equal": same_o,
               "library_max_abs_err": lib_err, "ms": dev["kernel"],
               "host_ms": min(host["kernel"]), "previous": previous,
               "previous_ms": dev["previous"], "previous_host_ms": min(host["previous"]),
               "library_ms": dev["library"], "library_host_ms": host["library"][0],
               "plain_ms": min(plain_a, plain_b), "bound_ms": bound, "bound_by": by,
               "faster_than_previous": dev["kernel"] < dev["previous"], "traces": traces}
        print(json.dumps({"flash_attention_check": row}), flush=True)
        if bad or not same or not same_o or (lse_err is not None and lse_err > LSE_ATOL):
            raise SystemExit(f"flash_attention disagrees with its plain version in case {name} "
                             f"(or is not deterministic, or its lse is off)")
        if variant == "tile" and design != fa.tile_design(q.dtype, hd, hd, sq):
            raise SystemExit(f"flash_attention ran the {design!r} design in case {name}")
        rows.append(row)
        del q, k, v, out, ref
    # f32 inputs too, at one shape of each kind: the "general" kernel
    for b, sq, sk, h, hkv, hd, causal, window in [(2, 300, 300, 32, 4, 128, True, 0),
                                                   (4, 1, 25, 32, 4, 128, True, 0),
                                                   (2, 37, 91, 6, 3, 64, False, 7)]:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda")
        k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda")
        v = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda")
        kw = dict(q_positions=torch.arange(sk - sq, sk, device="cuda"), causal=causal,
                  window=window)
        general = fa.flash_attention.variant_launches["general"]
        out, ref = fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL["float32"]
        bad = int(((out - ref).abs() > atol + rtol * ref.abs()).sum())
        print(json.dumps({"flash_attention_check": {
            "shape": [b, sq, sk, h, hkv, hd], "causal": causal, "window": window,
            "dtype": "float32", "variant": "general", "violations": bad,
            "max_abs_err": float((out - ref).abs().max())}}), flush=True)
        if bad:
            raise SystemExit(f"flash_attention disagrees with its plain version in f32 at {b, sq, sk}")
        if fa.flash_attention.variant_launches["general"] != general + 1:
            raise SystemExit("f32 attention did not go to the general kernel")
    torch.cuda.synchronize()
    return rows


def check_mla_attention(name: str, b: int, s: int, h: int, hd: int, hd_v: int, gen) -> dict:
    """MLA's attention at q/k head dim ``hd`` and v head dim ``hd_v``, causal,
    MHA, bf16, through ``models/layers.py::flash_attention`` (V at its own
    width, the "tile" kernel's "wgmma" (192, 128) instance, nothing padded):
    against the plain version on the same inputs (``flash_attention_lse_ref``
    at hd_v) within ``ATTN_TOL``, its lse within ``LSE_ATOL``, a second call
    equal bit for bit.  Device ms of the layer's call (``ms``), of the
    kernel's wrapper alone (``kernel_ms``) and of the "mma" design
    (``previous_ms``), in turns, beside SDPA at Ev = hd_v (``library_ms``),
    the plain version and the bound (2 (hd + hd_v) operations per visible
    pair and head; q, k, v and o moved once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, h, hd_v), generator=gen, device="cuda").bfloat16()
    mask, scale = layers.MaskSpec(causal=True), hd ** -0.5
    out, variant, design = _launched_design(
        lambda: layers.flash_attention(q, k, v, mask=mask, scale=scale))
    same = torch.equal(out, layers.flash_attention(q, k, v, mask=mask, scale=scale))
    ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, scale=scale)
    o_lse, lse = fa.flash_attention_lse(q, k, v, scale=scale)
    same_o, lse_err = torch.equal(o_lse, out), float((lse - lse_ref).abs().max())
    del o_lse, lse, lse_ref
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    atol, rtol = ATTN_TOL["bfloat16"]
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return layers.flash_attention(q, k, v, mask=mask, scale=scale)

    def kern():
        return fa.flash_attention(q, k, v, scale=scale)

    def prev():  # the "mma" design at the same instance
        return fa.flash_attention_variant("tile", q, k, v, scale=scale, design="mma")

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

    lib_err = float((lib().transpose(1, 2).float() - ref.float()).abs().max())
    host = {"call": [_time_ms(call, 5)], "previous": [_time_ms(prev, 5)],
            "library": [_time_ms(lib, 5)]}
    host["library"].append(_time_ms(lib, 5))
    host["previous"].append(_time_ms(prev, 5))
    host["call"].append(_time_ms(call, 5))
    dev = {what: _device_ms(fn, 5)[0] for what, fn in (("call", call), ("kernel", kern),
                                                         ("previous", prev), ("library", lib))}
    pairs = s * (s + 1) // 2
    ops_ms = 2.0 * (hd + hd_v) * pairs * b * h / H100_BF16_FLOPS * 1e3
    nbytes = (2 * q.numel() + 2 * v.numel()) * q.element_size() + 8 * s  # q k v o, positions
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    row = {"case": name, "shape": [b, s, s, h, h, hd], "hd_v": hd_v, "causal": True, "window": 0,
           "dtype": "bfloat16", "variant": variant, "design": design, "violations": bad,
           "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err, "deterministic": same,
           "forward_with_lse_equal": same_o, "library_max_abs_err": lib_err,
           "ms": dev["call"], "kernel_ms": dev["kernel"], "host_ms": min(host["call"]),
           "previous": "mma", "previous_ms": dev["previous"],
           "previous_host_ms": min(host["previous"]), "library_ms": dev["library"],
           "library_host_ms": min(host["library"]),
           "plain_ms": _time_ms(lambda: fa.flash_attention_ref(q, k, v, scale=scale), 2),
           "bound_ms": bound, "bound_by": by,
           "faster_than_previous": dev["kernel"] < dev["previous"]}
    print(json.dumps({"flash_attention_check": row}), flush=True)
    if (bad or variant != "tile" or design != "wgmma" or out.shape[-1] != hd_v or not same
            or not same_o or lse_err > LSE_ATOL):
        raise SystemExit(f"flash_attention at hd {hd} / hd_v {hd_v}: {bad} violations, ran "
                         f"{variant} {design}, deterministic {same}, lse error {lse_err}")
    del q, k, v, out, ref
    torch.cuda.synchronize()
    return row


def attention_bwd_bound_ms(q, k, v, vis) -> tuple[float, str]:
    """Least time for attention's gradient with the (Sq, Sk) visibility
    ``vis``: five products per visible (query, key) pair and query head at
    the bf16 peak, each at its own width (S again, dK, dQ: 2 * hd; dP again,
    dV: 2 * hd_v), or q, k, v, o, dO, lse read once and dq, dk, dv written
    once (o, dO, v and dv at hd_v)."""
    b, sq, h, hd = q.shape
    hd_v = v.shape[3]
    ops_ms = 2.0 * (3 * hd + 2 * hd_v) * int(vis.sum()) * b * h / H100_BF16_FLOPS * 1e3
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * b * sq * h * hd_v) \
        * q.element_size() + 4 * b * h * sq
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def backward_cases() -> list[tuple]:
    """Phase 2's cases of ``flash_attention_bwd``, on the card: (name, b, sq,
    sk, h, hkv, hd, hd_v, causal, window, q_positions, k_positions)."""
    import torch

    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int32, device="cuda")

    return [
        ("train_microbatch", TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, TRAIN_SEQ, 24, 2, 128,
         128, True, 0, ar(TRAIN_SEQ), ar(TRAIN_SEQ)),
        # phase 16's hymba step: a GQA group of 5, hd 64
        ("hymba_train", 1, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_SEQ, 25, 5, 64, 64, True, 0,
         ar(FAMILY_TRAIN_SEQ), ar(FAMILY_TRAIN_SEQ)),
        # phase 17's deepseek step: MLA's q/k head dim 192, V at 128, MHA: "wgmma" (192, 128)
        ("mla_train", 1, MLA_SEQ, MLA_SEQ, 16, 16, 192, 128, True, 0, ar(MLA_SEQ), ar(MLA_SEQ)),
        # the same instance under a window with GQA, and at Sq != Sk with ragged tiles and
        # rows that see no key (queries -5..94 over 333 keys)
        ("mla_window_gqa", 2, 300, 300, 8, 2, 192, 128, True, 64, ar(300), ar(300)),
        ("mla_ragged_blind_rows", 1, 100, 333, 4, 2, 192, 128, True, 0, ar(100, -5), ar(333)),
        ("window", 2, 300, 300, 24, 2, 128, 128, True, 64, ar(300), ar(300)),
        # a block of queries at the end of a longer cache; Sq != Sk, ragged last tiles
        ("explicit_positions_ragged", 2, 100, 333, 8, 2, 64, 64, True, 0, ar(100, 233), ar(333)),
        ("noncausal_hd256_sq_ne_sk", 1, 130, 200, 4, 2, 256, 256, False, 0, ar(130), ar(200)),
        ("g1_mha", 2, 257, 257, 8, 8, 128, 128, True, 0, ar(257), ar(257)),
        # queries -5..10: the first five see no key (weights 1/Sk, no score gradient)
        ("rows_see_no_key", 1, 16, 24, 4, 2, 16, 16, True, 0, ar(16, -5), ar(24)),
    ]


def _ptxas_kernel(line: str) -> str | None:
    """The attention kernel a ptxas "Compiling entry" line names, with its
    template arguments (``attn_bwd_dkdv_wgmma_kernel<192,128>``,
    ``attn_fwd_wgmma_kernel<128,128>``)."""
    m = re.search(r"(attn_\w+?_kernel)(?:I((?:Li\d+E)+)E)?", line)
    if not m:
        return None
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_spills(lines: list[str]) -> dict[str, int]:
    """Spill bytes (stores and loads) per kernel from ``_build.ptxas_report``
    lines, keyed by the kernel's name and its template arguments
    (``attn_bwd_dkdv_wgmma_kernel<192,128>``)."""
    spills, name = {}, None
    for ln in lines:
        if "Compiling entry" in ln:
            name = _ptxas_kernel(ln)
        elif name and "spill" in ln:
            spills[name] = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))
    return spills


def ptxas_registers(lines: list[str]) -> dict[str, int]:
    """Registers per kernel from ``_build.ptxas_report`` lines, keyed as
    :func:`ptxas_spills` keys them."""
    regs, name = {}, None
    for ln in lines:
        if "Compiling entry" in ln:
            name = _ptxas_kernel(ln)
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            regs[name] = int(m.group(1))
    return regs


def sdpa_backward(q, k, v, do):
    """SDPA's backward (a yardstick the port never calls) on (B, H, S, E)
    views of the (B, S, H, E) bf16 inputs, causal, by PyTorch's own choice of
    backend: a function that runs it once, and the backward node that names
    the backend (``ScaledDotProductFlashAttentionBackward0``, ...; flash may
    refuse Ev != E and leave it to another).  Its forward is not timed."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=q.shape[2] != k.shape[2])
    dot = do.transpose(1, 2)
    return (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)), \
        ot.grad_fn.name()


def check_flash_attention_bwd(cases, gen, timed: tuple[str, ...]) -> list[dict]:
    """cases: (name, b, sq, sk, h, hkv, hd, hd_v, causal, window, q_positions,
    k_positions), bf16; v and dO at hd_v.

    Each case: the forward with its row log-sum-exp ("tile") equal to the
    forward without it and its lse within ``LSE_ATOL`` of the plain
    version's; ``flash_attention_bwd`` against ``flash_attention_bwd_ref``
    (one batch element at a time) within ``BWD_TOL`` of each gradient's
    largest entry, and a second call equal to the first bit for bit; the
    design that ran (``design_launches``: "wgmma" up to hd 192 with hd_v up
    to 128, "mma" above) with its tiles, stages and instance.  The cases
    named in ``timed`` are also timed: the kernel in turns with SDPA's
    backward (``library``; at hd_v != hd, SDPA at Ev = hd on V and dO
    zero-padded, ``library_ms``, and at Ev = hd_v, ``library_native_ms``,
    each with the backend PyTorch chose) by CUDA events (``*host_ms``) and by device
    time from a profiler trace (``ms``, ``library_ms``), the plain version
    (per batch element, summed) by CUDA events; its row carries each
    backward kernel's spill bytes from ptxas.  Fails if a "wgmma" kernel
    spills."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    spills = ptxas_spills(_build.ptxas_report("flash_attention_bwd"))
    if not spills or any(n for k, n in spills.items() if "wgmma" in k):
        raise SystemExit(f"flash_attention_bwd: a wgmma kernel spills (or no ptxas report): {spills}")
    rows = []
    for name, b, sq, sk, h, hkv, hd, hd_v, causal, window, qpos, kpos in cases:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, sk, hkv, hd_v), generator=gen, device="cuda").bfloat16()
        do = torch.randn((b, sq, h, hd_v), generator=gen, device="cuda").bfloat16()
        kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        same_o = torch.equal(o, fa.flash_attention_variant("tile", q, k, v, **kw))
        before = dict(fab.flash_attention_bwd.design_launches)
        grads = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        again = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        ran = [d for d, c in fab.flash_attention_bwd.design_launches.items() if c > before[d]]
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
        lse_err = err = rel = 0.0
        for i in range(b):  # the plain version one batch element at a time (its f32 scores)
            sl = slice(i, i + 1)
            _, lse_ref = fa.flash_attention_lse_ref(q[sl], k[sl], v[sl], **kw)
            lse_err = max(lse_err, float((lse[sl] - lse_ref).abs().max()))
            ref = fab.flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], **kw)
            for g, r in zip(grads, ref):
                e = float((g[sl].float() - r.float()).abs().max())
                err, rel = max(err, e), max(rel, e / float(r.float().abs().max()))
            del ref, lse_ref
        row = {"case": name, "shape": [b, sq, sk, h, hkv, hd], "hd_v": hd_v, "causal": causal,
               "window": window, "forward_with_lse_equal": same_o, "lse_max_abs_err": lse_err,
               "max_abs_err": err, "max_rel_err": rel, "tol": BWD_TOL, "deterministic": same,
               "config": fab.kernel_config(hd, hd_v)}
        if name in timed:
            vis = fa.visible(qpos, kpos, causal, window)
            assert causal and not window and sq == sk  # SDPA's own causal mask is the same here
            pad = (0, hd - hd_v)
            lib, backend = sdpa_backward(q, k, F.pad(v, pad), F.pad(do, pad))

            def kern():
                return fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)

            def plain():
                for i in range(b):
                    sl = slice(i, i + 1)
                    fab.flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], **kw)

            host = {"kernel": [_time_ms(kern, 10)], "library": [_time_ms(lib, 10)]}
            host["library"].append(_time_ms(lib, 10))
            host["kernel"].append(_time_ms(kern, 10))
            dev = {what: _device_ms(fn, 10)[0] for what, fn in (("kernel", kern), ("library", lib))}
            bound, by = attention_bwd_bound_ms(q, k, v, vis)
            row.update(ms=dev["kernel"], host_ms=min(host["kernel"]), library_ms=dev["library"],
                       library_backend=backend, library_host_ms=min(host["library"]),
                       plain_ms=_time_ms(plain, 1), bound_ms=bound, bound_by=by,
                       spill_bytes=spills)
            del lib
            if hd_v != hd:  # SDPA at V's own width, where a backend takes it
                native, backend = sdpa_backward(q, k, v, do)
                row.update(library_native_ms=_device_ms(native, 10)[0],
                           library_native_backend=backend)
                del native
        print(json.dumps({"flash_attention_bwd_check": row}), flush=True)
        if not same_o or lse_err > LSE_ATOL or rel > BWD_TOL or not same:
            raise SystemExit(f"flash_attention_bwd disagrees with its plain version in case {name}")
        want = fab.design(hd, hd_v)
        if ran != [want] or row["config"]["design"] != want:
            raise SystemExit(f"flash_attention_bwd ran {ran} at hd {hd} / hd_v {hd_v}, "
                             f"not {want!r}")
        rows.append(row)
        del q, k, v, do, o, lse, grads
    torch.cuda.synchronize()
    return rows


def audit_samples(sps, meta, chunk_bytes: int) -> np.ndarray:
    """Every 1 KiB sample of every chunk the put stored, as (L, 1024) uint8,
    each chunk zero-padded to whole samples as ``commitments.chunk_samples`` does."""
    from repro_torch.core.commitments import SAMPLE_BYTES

    per = -(-chunk_bytes // SAMPLE_BYTES)
    keys = sorted(meta.placement)
    out = np.zeros((len(keys), per * SAMPLE_BYTES), np.uint8)
    for row, (cs, c) in enumerate(keys):
        chunk, _ = sps[meta.placement[(cs, c)]].serve_chunk(meta.blob_id, cs, c)
        out[row, :chunk_bytes] = chunk.reshape(-1)
    return out.reshape(-1, SAMPLE_BYTES)


def repair_phase(contract, sps, client, meta, gk) -> dict:
    """Clay MSR repair at the production layout on the card, three ways:
    an SP that lost every chunk (restored in place: timed, then wiped again
    and repaired under the profiler for device ms and idle share), a crashed
    SP (its chunks move to new SPs), and two chunks of one chunkset gone (the
    first rebuilt through the MDS fallback, the second by MSR once the first
    is back).  Every report must be verified, every MSR repair must read the
    MSR optimum of helper bytes and make exactly one ``gf_matmul`` launch;
    then the whole blob is read back from a cold cache."""
    import torch

    from repro_torch.storage.repair import RepairCoordinator

    lay = client.layout
    msr_bytes = lay.code.repair_bandwidth_bytes(lay.chunk_bytes)
    rc = RepairCoordinator(contract, sps, lay)

    def step(name, fn, profile=False):
        seen, first = gk.gf_matmul.launches, len(rc.reports)
        if profile:  # its wall time carries the profiler's cost: no GB/s from it
            busy = device_busy(fn)
        else:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            busy = {"wall_s": time.perf_counter() - t}
        reports = rc.reports[first:]
        launches = gk.gf_matmul.launches - seen
        msr = [r for r in reports if r.mode == "msr"]
        rebuilt = lay.chunk_bytes * len(reports)
        row = {"step": name, "profiled": profile, "repairs": len(reports), "msr": len(msr),
               "mds": len(reports) - len(msr), "bytes_rebuilt": rebuilt,
               "helper_bytes_read": sum(r.helper_bytes_read for r in reports),
               "helper_bytes_per_msr_repair": sorted({r.helper_bytes_read for r in msr}),
               "helper_bytes_per_mds_repair": sorted(
                   {r.helper_bytes_read for r in reports if r.mode == "mds"}),
               "gf_matmul_launches": launches,
               "GB/s": None if profile else rebuilt / busy["wall_s"] / 1e9,
               "failures": len(rc.failures), **busy}
        print(json.dumps({"repair": row}), flush=True)
        if not reports or rc.failures or not all(r.verified for r in reports):
            raise SystemExit(f"repair step {name!r}: {len(reports)} reports, "
                             f"failures {rc.failures}")
        if any(r.helper_bytes_read != msr_bytes for r in msr):
            raise SystemExit(f"an MSR repair read other than {msr_bytes} helper bytes")
        return row, reports, launches

    # an SP that lost its disk: recovered, then wiped (examples/quickstart.py step 4)
    victim = meta.placement[(0, 0)]
    sps[victim].recover()
    wiped = []
    for profile in (False, True):  # timed, then wiped again for the trace
        sps[victim].wipe()
        row, reports, launches = step("wipe_one_sp", rc.repair_all, profile=profile)
        if row["mds"] or launches != row["msr"] or any(r.new_sp != victim for r in reports):
            raise SystemExit(f"wiped-SP repair: {row['msr']} MSR repairs, {launches} launches")
        wiped.append(row)
    # a crashed SP: its chunks are rebuilt on SPs the contract picks
    crashed = next(sp for sp in meta.placement.values() if sp != victim)
    sps[crashed].crash()
    moved, reports, launches = step("crash_one_sp", rc.repair_all)
    if moved["mds"] or launches != moved["msr"] or any(r.new_sp == crashed for r in reports):
        raise SystemExit(f"crashed-SP repair: {moved['msr']} MSR repairs, {launches} launches")
    # two chunks of one chunkset gone: the first has no MSR pattern (k verified
    # helpers decoded); once it is back, the second is an MSR repair again
    cs = meta.num_chunksets // 2
    for ck in (1, 2):
        sps[meta.placement[(cs, ck)]]._chunks.pop((meta.blob_id, cs, ck))
    mds, reports, launches = step("two_of_one_chunkset", rc.repair_all)
    if [r.mode for r in reports] != ["mds", "msr"] or launches <= 1:
        raise SystemExit(f"MDS fallback: modes {[r.mode for r in reports]}, {launches} launches")
    return {"steps": [*wiped, moved, mds], "wiped_sp": victim, "crashed_sp": crashed}


def churn_phase(contract, sps, client, meta, data, gk, seed: int, reads: int) -> dict:
    """Three churned epochs (crashes, departures, one join each, a floor of
    21 live SPs) with their re-dispersal backlog repaired on the card,
    while paid Zipf reads of the blob replay on the same event loop."""
    import torch

    from repro_torch.net.workloads import zipf_hotset
    from repro_torch.storage.membership import ChurnSpec, MembershipPlane
    from repro_torch.storage.repair import RepairCoordinator

    lay = client.layout
    rc = RepairCoordinator(contract, sps, lay)
    plane = MembershipPlane(
        contract, sps, lay,
        ChurnSpec(p_crash=0.05, p_leave=0.05, joins_per_epoch=1, min_active=21, seed=seed),
        repair=rc, fleet=client.fleet, epochs=CHURN_EPOCHS)
    # the reads spread over the churned epochs (250 ms of simulated time each)
    reqs = zipf_hotset([meta], clients=["reader"], num_requests=reads,
                       interarrival_ms=plane.epoch_ms * CHURN_EPOCHS / reads, seed=seed,
                       arrival="poisson")
    # every MSR attempt must be taken: a rebuilt chunk that failed its
    # commitment would fall back to MDS unseen, so count the attempts on
    # this layout's code (an instance attribute on the frozen dataclass,
    # removed after the run; other ClayCode objects are untouched)
    attempts = []
    code = lay.code
    object.__setattr__(code, "repair", lambda failed, helpers: (
        attempts.append(failed) or type(code).repair(code, failed, helpers)))
    seen = gk.gf_matmul.launches
    t = time.perf_counter()
    try:
        with client.session() as session:
            receipts, result = session.replay(reqs, background=plane.planes())
        torch.cuda.synchronize()
    finally:
        object.__delattr__(code, "repair")
    wall = time.perf_counter() - t
    served = [(q, r) for q, r in zip(reqs, receipts) if r is not None]
    wrong = sum(r.data != data[q.offset:q.offset + q.length] for q, r in served)
    msr = sum(r.mode == "msr" for r in rc.reports)
    row = {
        "epochs": CHURN_EPOCHS, "wall_s": wall,
        "events": [[e.kind, e.epoch, e.t_ms, e.sp_id] for e in plane.events],
        "epoch_stats": [{"epoch": st.epoch, "joins": st.joins, "crashes": st.crashes,
                         "departures": st.departures, "slashes": st.slashes,
                         "reassigned": st.reassigned, "backlog": st.enqueued,
                         "lost_new": st.lost_new, "drain_ms": st.drain_ms()}
                        for st in plane.epoch_stats],
        "lost_chunksets": plane.lost_chunksets, "repairs_msr": msr, "msr_attempts": len(attempts),
        "repairs_mds": len(rc.reports) - msr, "repair_failures": len(plane.repair.failures),
        "backlog_left": plane.repair.backlog(), "reads": len(reqs),
        "reads_served": len(served), "reads_failed": result.dropped, "reads_wrong": wrong,
        "read_p99_ms": result.percentile(99.0), "gf_matmul_launches": gk.gf_matmul.launches - seen,
        "digest": result.digest(),
    }
    print(json.dumps({"churn": row}), flush=True)
    if plane.lost_chunksets or wrong or result.dropped:
        raise SystemExit(f"churn: {plane.lost_chunksets} chunksets lost, {wrong} wrong reads, "
                         f"{result.dropped} failed reads")
    if len(attempts) != msr:
        raise SystemExit(f"churn: {len(attempts) - msr} MSR repairs failed their commitment")
    if plane.repair.failures or plane.repair.backlog() or not plane.events:
        raise SystemExit("churn: the re-dispersal backlog did not drain, or nothing churned")
    return row


def das_phase(gk, seed: int, num_blobs: int, device: str = "cuda") -> dict:
    """Data-availability sampling at the JAX package's ``build_cluster``
    deployment: ``num_blobs`` puts of one DAS square each, one batched
    extension of them all, a paid sampling round, a withholding adversary
    on half the blobs and a round that must catch it at the analytic rate,
    a replayed sample storm, and squares rebuilt on the card."""
    import torch

    from repro_torch.configs.shelby import CONFIG
    from repro_torch.core.extend2d import commit_square, detection_probability
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.net.workloads import das_storm
    from repro_torch.storage import das

    spec = CONFIG.das()
    lay, side = spec.layout(), spec.side
    contract, sps, rpc, client = build_cluster(device=device)
    nbytes = spec.k * spec.k * spec.share_bytes  # one square: no byte of a blob outside it
    bulk = np.random.default_rng(seed).bytes(nbytes * num_blobs)
    datas = [bulk[i * nbytes:(i + 1) * nbytes] for i in range(num_blobs)]
    row: dict = {"blobs": num_blobs, "blob_bytes": nbytes, "k": spec.k,
                 "share_bytes": spec.share_bytes, "samples_per_epoch": spec.samples_per_epoch,
                 "sps": len(sps), "layout": [rpc.layout.k, rpc.layout.m]}

    def launched(fn):
        seen = gk.gf_matmul.launches
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, gk.gf_matmul.launches - seen

    # 1. every put extends its own square on the card
    metas, row["put_s"], row["put_launches"] = launched(lambda: [client.put(d) for d in datas])
    row["put_ms_per_blob"] = row["put_s"] / num_blobs * 1e3
    singles = {m.blob_id: contract.das[m.blob_id] for m in metas}
    if any(len(r.placement) != side * side for r in singles.values()):
        raise SystemExit("das: a put did not place every share of its square")
    blobs = [(m.blob_id, d) for m, d in zip(metas, datas)]

    # 2. every blob at once: two launches, the same records as the puts'
    def batch():
        return das.extend_and_disperse_many(contract, sps, blobs, spec, device=device)

    def same_as_puts(records):
        return all((r.das_root, r.placement, r.proof_bytes) == (
            singles[r.blob_id].das_root, singles[r.blob_id].placement,
            singles[r.blob_id].proof_bytes) for r in records) and len(records) == num_blobs

    records, row["batch_s"], launches = launched(batch)
    if launches != 2 or not same_as_puts(records):
        raise SystemExit(f"das: the batched extension made {launches} launches "
                         f"or differs from the puts' records")
    held = {}
    seen = gk.gf_matmul.launches
    busy = device_busy(lambda: held.update(records=batch()))
    if gk.gf_matmul.launches - seen != 2 or not same_as_puts(held["records"]):
        raise SystemExit("das: the profiled batched extension differs")
    row["batch_profiled"] = busy

    # 3. a paid sampling round over every blob
    verdicts, row["round_s"], _ = launched(
        lambda: client.sample_availability(epoch=0, seed=seed))
    samples = sum(v.verified + v.failures for v in verdicts)
    row.update(round_samples=samples, round_samples_per_s=samples / row["round_s"],
               round_verified=sum(v.verified for v in verdicts),
               round_failures=sum(v.failures for v in verdicts))
    if (len(verdicts) != num_blobs or samples != num_blobs * spec.samples_per_epoch
            or not all(v.available and v.verified == spec.samples_per_epoch for v in verdicts)):
        raise SystemExit("das: an honest sampling round did not verify every sample")
    settlement = client.settle()  # raises unless deposits = refunds + income = receipts
    row["round_paid"] = settlement.total_node_income

    # 4. withhold 3 of 64 shares of half the blobs: caught at 1-(1-q)^s
    half = {m.blob_id for m in metas[:num_blobs // 2]}
    withheld = {das.seed_withholding(contract, sps, b, DAS_WITHHOLD, seed=seed * 1013 + b)
                for b in sorted(half)}
    q = next(iter(withheld)) / (side * side)
    verdicts = client.sample_availability(epoch=1, seed=seed)
    client.settle()
    caught = sum(not v.available for v in verdicts if v.blob_id in half)
    false = sum(not v.available for v in verdicts if v.blob_id not in half)
    rate, analytic = caught / len(half), detection_probability(q, spec.samples_per_epoch)
    row.update(withheld_per_blob=sorted(withheld), q=q, detected=caught,
               detection_rate=rate, analytic=analytic, false_detections=false)
    if withheld != {3} or abs(rate - analytic) > DAS_RATE_TOL or false:
        raise SystemExit(f"das: detection rate {rate} vs {analytic}, {false} false detections")

    # 5. a storm of single samples replayed, one SP crashed
    crashed = 3
    sps[crashed].crash()
    reqs = das_storm(list(contract.das.values()), clients=["light"], num_requests=DAS_STORM,
                     interarrival_ms=DAS_STORM_GAP_MS, seed=seed, cache_bypass=True)

    def hit(r):
        holder = sps[contract.das[r.blob_id].placement[(r.row, r.col)]]
        return holder.behavior.crashed or (r.blob_id, r.row, r.col) in holder._das_withheld

    expected = sum(hit(r) for r in reqs)
    (receipts, result), row["storm_s"], _ = launched(lambda: client.replay(reqs))
    client.settle()
    sps[crashed].recover()
    row.update(storm_samples=result.das_samples, storm_detections=result.das_detections,
               storm_expected=expected, storm_samples_per_s=len(reqs) / row["storm_s"],
               storm_p99_ms=result.percentile(99.0, kind="das"), storm_digest=result.digest(),
               storm_paid_receipts=sum(r is not None for r in receipts))
    if result.das_samples != DAS_STORM or result.das_detections != expected:
        raise SystemExit(f"das: storm {result.das_samples} samples, "
                         f"{result.das_detections} detections, {expected} expected")

    # 6. squares rebuilt on the card from k rows and from k columns
    rng = np.random.default_rng(seed + 1)
    pick = sorted(int(i) for i in rng.choice(num_blobs, size=min(DAS_REBUILT, num_blobs),
                                             replace=False))
    ext = lay.extend_batch([lay.pad_square(datas[i], spec.share_bytes) for i in pick],
                           device=device)
    rebuilt = 0
    for j, i in enumerate(pick):
        if commit_square(ext[j]).commitment.das_root != contract.das[metas[i].blob_id].das_root:
            raise SystemExit("das: a square extended on the card has another DAS root")
        rows = sorted(int(r) for r in rng.choice(side, size=spec.k, replace=False))
        cols = sorted(int(c) for c in rng.choice(side, size=spec.k, replace=False))
        by_rows = lay.reconstruct_from_rows({r: ext[j, r] for r in rows}, device=device)
        by_cols = lay.reconstruct_from_cols({c: ext[j, :, c] for c in cols}, device=device)
        rebuilt += torch.equal(by_rows, ext[j]) and torch.equal(by_cols, ext[j])
    row["rebuilt_equal"] = f"{rebuilt}/{len(pick)}"
    print(json.dumps({"das": row}), flush=True)
    if rebuilt != len(pick):
        raise SystemExit(f"das: {len(pick) - rebuilt} squares rebuilt wrong")
    return row


def engine_phase(gk, device: str = "cuda") -> dict:
    """The `engine` ramp in that scenario's world, fleets and batches
    (``repro_torch.scenarios.engine``): a Zipf storm of 10k, 100k and 1M
    requests through ``session.replay(batch)`` (the cohort fast path) on
    fresh fleets, each rung under the profiler; the cold-key leaders de-opt
    to real tasks and decode on the card (one cold-key leader per blob).
    The 10k digest must equal a task-per-request replay on the heap engine
    and the JAX package's; ``ENGINE_HEAP_RUNGS`` also time that baseline
    for the events/s speedup.  Only the ``ENGINE_PROFILED`` rungs run under
    the profiler (its trace of the 1M rung cost more than the rung); the
    others' device time is not measured."""
    import torch

    from repro_torch.configs.shelby import CONFIG
    from repro_torch.net.workloads import replay_open_loop
    from repro_torch.scenarios import engine as eng
    from repro_torch.storage.sdk import ShelbyClient

    t = time.perf_counter()
    layout, contract, bb, sps, metas = eng._world(device)
    torch.cuda.synchronize()
    rows = {"world": {"sps": eng.NUM_SPS, "rpcs": eng.NUM_RPCS, "blobs": eng.NUM_BLOBS,
                      "cache_chunksets": eng.CACHE_CHUNKSETS, "build_s": time.perf_counter() - t}}
    print(json.dumps({"engine_world": rows["world"]}), flush=True)
    for n in eng.RAMP:
        batch = eng._batch(metas, n)
        reader = ShelbyClient(contract, eng._fleet(CONFIG, layout, contract, bb, sps),
                              deposit=1e9)
        held = {}

        def replay():
            with reader.session(deposit_per_node=1e6) as session:
                held["rb"], held["fast"] = session.replay(batch)
            held["session"] = session

        seen = gk.gf_matmul.launches
        if n in ENGINE_PROFILED:
            busy = device_busy(replay)
        else:
            t = time.perf_counter()
            replay()
            torch.cuda.synchronize()
            busy = dict.fromkeys(("device_busy_s", "idle_share", "gf_matmul_device_ms"))
            busy["wall_s"] = time.perf_counter() - t
        fast, rb, session = held["fast"], held["rb"], held["session"]
        co = fast.cohort
        row = {"requests": n, "wall_s": busy["wall_s"], "requests_per_s": n / busy["wall_s"],
               "events_per_s": fast.engine_events_per_sec,
               "vec_requests": co.vec_requests, "deopt_requests": co.deopt_requests,
               "coalesced_legs": co.coalesced, "fallback_reason": co.fallback_reason,
               "p50_ms": fast.percentile(50.0), "p99_ms": fast.percentile(99.0),
               "goodput_mbps": fast.goodput_mbps, "digest": fast.digest()[:16],
               "gf_matmul_launches": gk.gf_matmul.launches - seen,
               "device_busy_s": busy["device_busy_s"], "idle_share": busy["idle_share"],
               "gf_matmul_device_ms": busy["gf_matmul_device_ms"]}
        if co.fallback_reason is not None or row["gf_matmul_launches"] == 0:
            raise SystemExit(f"engine {n}: fell back ({co.fallback_reason}) "
                             f"or made no gf_matmul launch")
        paid = rb.total_paid + sum(r.total_paid for r in session.receipts)
        if abs(session.settlement.total_node_income - paid) >= 1e-6:
            raise SystemExit(f"engine {n}: settlement does not conserve")
        if n in ENGINE_HEAP_RUNGS:
            t = time.perf_counter()
            base = replay_open_loop(eng._fleet(CONFIG, layout, contract, bb, sps),
                                    batch.to_requests(), engine="heap")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            row["heap"] = {"wall_s": wall, "requests_per_s": n / wall,
                           "events_per_s": base.engine_events_per_sec,
                           "digest": base.digest()[:16]}
            row["speedup_events_per_s"] = (fast.engine_events_per_sec
                                           / base.engine_events_per_sec)
            if n == eng.RAMP[0] and not (fast.digest() == base.digest()
                                         and row["digest"] == ENGINE_DIGEST_10K
                                         and co.deopt_requests == eng.NUM_BLOBS):
                raise SystemExit(f"engine 10k: digest {row['digest']} (heap "
                                 f"{row['heap']['digest']}, JAX package {ENGINE_DIGEST_10K}), "
                                 f"{co.deopt_requests} de-opts")
        print(json.dumps({"engine": row}), flush=True)
        rows[str(n)] = row
    return rows


def overload_phase(gk, device: str = "cuda") -> dict:
    """The `concurrent` ramp in that scenario's world and fleets
    (``repro_torch.scenarios.serving``): 400 Poisson Zipf reads at 200, 1000
    and 5000 rps, each free-running (no admission, no single-flight) and
    admitted (the scenario's fetch budget of 6); every read decodes on the
    card.  Digest, sheds, coalesced legs and both p99s at 5000 rps must
    equal the JAX package's; settlement conserves; every read's bytes are
    the written ones."""
    import torch

    from repro_torch.net.workloads import zipf_hotset
    from repro_torch.scenarios import REGISTRY, load_builtin, serving
    from repro_torch.storage.sdk import ShelbyClient

    load_builtin()
    cfg = REGISTRY.get("concurrent").config()
    nic = cfg.nic()
    layout, contract, bb, sps, metas, written = serving._world(cfg, False, nic=nic, sp_slots=2,
                                                               device=device)
    datas = {meta.blob_id: data for meta, data in zip(metas, written)}

    def one_run(rate, admission=None, single_flight=True):
        fleet = serving._fresh_fleet(cfg, layout, contract, bb, sps, nic=nic, cache_chunksets=8,
                                     admission=admission, single_flight=single_flight)
        reqs = zipf_hotset(metas, clients=["client0", "client1", "client2"],
                           num_requests=OVERLOAD_REQUESTS, interarrival_ms=1000.0 / rate,
                           seed=11, arrival="poisson")
        seen = gk.gf_matmul.launches
        t = time.perf_counter()
        with ShelbyClient(contract, fleet, deposit=1e9).session() as session:
            receipts, result = session.replay(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        paid = sum(r.total_paid for r in session.receipts)
        if abs(session.settlement.total_node_income - paid) >= 1e-3:
            raise SystemExit(f"overload {rate} rps: settlement does not conserve")
        wrong = sum(r.data != datas[q.blob_id][q.offset:q.offset + q.length]
                    for q, r in zip(reqs, receipts) if r is not None and not r.shed)
        return fleet, result, {
            "wall_s": wall, "goodput_mbps": result.goodput_mbps,
            "p50_ms": result.percentile(50.0), "p99_ms": result.percentile(99.0),
            "shed": result.shed, "dropped": result.dropped, "wrong_bytes": wrong,
            "hedges_launched": fleet.hedges_launched(), "hedged_wasted": fleet.hedged_wasted(),
            "coalesced": fleet.coalesced(), "retried_legs": fleet.retried_legs,
            "gf_matmul_launches": gk.gf_matmul.launches - seen}

    _, a, _ = one_run(OVERLOAD_RATES[0])
    _, b, _ = one_run(OVERLOAD_RATES[0])
    rows = {"digest_200rps": a.digest()[:16]}
    if a.digest() != b.digest() or rows["digest_200rps"] != OVERLOAD_DIGEST_200:
        raise SystemExit(f"overload: digest {a.digest()[:16]} / {b.digest()[:16]}, "
                         f"JAX package {OVERLOAD_DIGEST_200}")
    for rate in OVERLOAD_RATES:
        for mode, admission, single_flight in (("free", None, False),
                                               ("admitted", cfg.admission(), True)):
            _, _, row = one_run(rate, admission, single_flight)
            print(json.dumps({"overload": {"rate_rps": rate, "mode": mode, **row}}), flush=True)
            rows[f"{rate}rps_{mode}"] = row
            if row["gf_matmul_launches"] == 0 or row["wrong_bytes"] or row["dropped"]:
                raise SystemExit(f"overload {rate} rps {mode}: {row}")
        if rows[f"{rate}rps_admitted"]["shed"] != OVERLOAD_SHED[rate]:
            raise SystemExit(f"overload {rate} rps: admitted shed "
                             f"{rows[f'{rate}rps_admitted']['shed']}, not {OVERLOAD_SHED[rate]}")
    top = OVERLOAD_RATES[-1]
    p99 = {mode: round(rows[f"{top}rps_{mode}"]["p99_ms"], 1) for mode in OVERLOAD_P99_5000}
    if (p99 != OVERLOAD_P99_5000
            or rows[f"{top}rps_admitted"]["coalesced"] != OVERLOAD_COALESCED_5000):
        raise SystemExit(f"overload {top} rps: p99 {p99}, coalesced "
                         f"{rows[f'{top}rps_admitted']['coalesced']}")
    return rows


def _run_scenario_profiled(name: str, profiled: bool = True, **kw) -> tuple:
    """``run_scenario(name, emit=False, **kw)``, under the profiler unless
    ``profiled`` is false: its result, the device-busy row (wall only when
    not profiled; ``with_trace_s`` adds the trace's processing) and
    everything it printed (shown as well)."""
    import contextlib
    import io

    import torch

    from repro_torch.scenarios import run_scenario

    held, out = {}, io.StringIO()

    def run():
        held["res"] = run_scenario(name, emit=False, **kw)
        torch.cuda.synchronize()

    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if profiled:
            busy = device_busy(run)
        else:
            run()
            busy = {"wall_s": time.perf_counter() - t, "device_busy_s": None,
                    "idle_share": None, "gf_matmul_device_ms": None}
    busy["with_trace_s"] = time.perf_counter() - t
    print(out.getvalue(), end="", flush=True)
    return held["res"], busy, out.getvalue()


def scenario_phase(gk, device: str = "cuda") -> dict:
    """The registered scenarios at full size on ``device``: each of
    ``SCENARIOS`` through ``run_scenario`` (a declared SLO that fails
    raises), its digest and headline numbers held to the JAX package's;
    ``engine`` with ``raise_on_violation=False``, every SLO but
    ``ENGINE_OPEN_SLO`` a gate; ``churn`` again under ``SHELBY_SIMSAN=1``.
    None runs under the profiler: its post-processing took 125 s against
    54 s of the scenarios' own wall time, and phases 7, 10 and 12 profile
    the same kernels;
    a sanitized one-epoch ``run_sim`` against the CPU's; a sweep of
    ``tune_admission``'s fetch budget."""
    from repro_torch.core.simulation import honest_population, run_sim
    from repro_torch.scenarios import KnobAxis, ScenarioProblem, load_builtin
    from repro_torch.scenarios.report import metric_path

    load_builtin()
    rows = {}

    def scenario_row(name, res, busy, printed, launches, digest=None):
        digest = digest or res.digest or next(iter(re.findall(
            rf"# {name} determinism digest: ([0-9a-f]{{16}}) OK", printed)), None)
        row = {"scenario": name, "wall_s": busy["wall_s"], "with_trace_s": busy["with_trace_s"],
               "device_busy_s": busy["device_busy_s"], "idle_share": busy["idle_share"],
               "gf_matmul_launches": launches,
               "gf_matmul_device_ms": busy["gf_matmul_device_ms"], "digest": digest,
               "slos": {r.slo.metric: r.value for r in res.slo_results},
               "slos_ok": {r.slo.metric: r.ok for r in res.slo_results},
               "headline": {p: metric_path(res.payload, p) for p in res.scenario.headline}}
        print(json.dumps({"scenario": row}), flush=True)
        if launches == 0:
            raise SystemExit(f"scenario {name} made no gf_matmul launch")
        return row

    for name in SCENARIOS:
        seen = gk.gf_matmul.launches
        res, busy, printed = _run_scenario_profiled(name, profiled=False, smoke=False,
                                                    device=device)
        row = rows[name] = scenario_row(name, res, busy, printed, gk.gf_matmul.launches - seen)
        if name in SCENARIO_DIGESTS and row["digest"] != SCENARIO_DIGESTS[name]:
            raise SystemExit(f"scenario {name}: digest {row['digest']}, "
                             f"JAX package {SCENARIO_DIGESTS[name]}")
        if row["headline"] != SCENARIO_HEADLINES[name]:
            raise SystemExit(f"scenario {name}: headline {row['headline']}, "
                             f"JAX package {SCENARIO_HEADLINES[name]}")

    # engine: the run asserts no fallback, fast == heap at 10k, determinism and
    # settlement conservation itself; its events/s SLO is the open finding.
    # Not profiled: phase 12 profiles each rung of the same ramp
    seen = gk.gf_matmul.launches
    res, busy, printed = _run_scenario_profiled("engine", profiled=False, device=device,
                                                raise_on_violation=False)
    row = rows["engine"] = scenario_row("engine", res, busy, printed,
                                        gk.gf_matmul.launches - seen,
                                        digest=res.payload["digest_10k"])
    for r in res.slo_results:
        if r.slo.metric == ENGINE_OPEN_SLO:
            print(f"engine SLO (open finding, reported not raised): {r.message()}", flush=True)
        elif not r.ok:
            raise SystemExit(f"scenario engine: {r.message()}")
    if row["digest"] != ENGINE_DIGEST_10K:
        raise SystemExit(f"scenario engine: 10k digest {row['digest']}, "
                         f"JAX package {ENGINE_DIGEST_10K}")

    # simsan on the card: observes, never moves an event
    os.environ["SHELBY_SIMSAN"] = "1"
    try:
        seen = gk.gf_matmul.launches
        res, busy, printed = _run_scenario_profiled("churn", profiled=False, smoke=False,
                                                    device=device)
        san = rows["churn_sanitized"] = scenario_row("churn", res, busy, printed,
                                                     gk.gf_matmul.launches - seen)
    finally:
        del os.environ["SHELBY_SIMSAN"]
    if san["digest"] != rows["churn"]["digest"]:
        raise SystemExit(f"sanitized churn: digest {san['digest']}, "
                         f"unsanitized {rows['churn']['digest']}")
    seen = gk.gf_matmul.launches
    sims = {dev: dataclasses.asdict(run_sim(honest_population(6), epochs=1, seed=5,
                                            read_requests_per_epoch=20, device=dev,
                                            sanitize=True))
            for dev in (device, "cpu")}
    rows["run_sim_sanitized"] = {"equal_to_cpu": sims[device] == sims["cpu"],
                                 "gf_matmul_launches": gk.gf_matmul.launches - seen}
    print(json.dumps({"run_sim_sanitized": rows["run_sim_sanitized"]}), flush=True)
    if not rows["run_sim_sanitized"]["equal_to_cpu"]:
        raise SystemExit("sanitized run_sim on the card differs from the CPU's")

    # the optimiser's objective: each swept point reproduces the JAX package's
    seen = gk.gf_matmul.launches
    t = time.perf_counter()
    prob = ScenarioProblem("tune_admission",
                           (KnobAxis("rpc_max_inflight_fetches", SWEEP_FETCHES),),
                           "goodput_mbps", smoke=False, verbose=False, device=device)
    tuned = prob.sweep()
    digests = {p.knobs.get("rpc_max_inflight_fetches"): p.digest for p in tuned.history}
    rows["sweep"] = {"wall_s": time.perf_counter() - t, "digests": digests,
                     "values": {str(p.knobs.get("rpc_max_inflight_fetches")): p.value
                                for p in tuned.history},
                     "best": tuned.best.knobs, "gf_matmul_launches": gk.gf_matmul.launches - seen}
    print(json.dumps({"sweep": {**rows["sweep"], "digests": {str(k): v for k, v in
                                                              digests.items()}}}), flush=True)
    if digests != SWEEP_DIGESTS or tuned.best.knobs != {"rpc_max_inflight_fetches": SWEEP_BEST}:
        raise SystemExit(f"sweep: digests {digests}, best {tuned.best.knobs}")
    return rows


SERVE_LOGIT_ATOL = 0.15  # bf16 logits, card vs CPU: the two round products differently
# where attention is one-hot at the JAX package's init (ROADMAP Queue 3 item 5: scores
# spread ~64 over 1,500 or 4,096 keys) a bf16 rounding flips rows' winners in any bf16
# computation: there the card is held within SERVE_LOGIT_ATOL plus this many times the
# CPU's own bf16 error (its bf16 against f32 compute), as the gradients are
LOGIT_NOISE_FACTOR = 3.0


def decode_card_vs_cpu(cfg, params, toks, *, long_mode: bool = False, frames=None,
                       exact: bool = False) -> dict:
    """``toks`` (B, T) teacher-forced through ``decode_step`` from empty caches
    on the card (``params``) and on the CPU plain path (a copy): bf16 logits
    within ``atol`` at every position, finite on the card, and the card's
    argmax equal to the CPU's wherever the CPU's top-2 margin exceeds twice
    that (``greedy_equal`` of ``greedy_compared``).  ``atol`` is
    ``SERVE_LOGIT_ATOL``, or with ``exact`` that plus ``LOGIT_NOISE_FACTOR``
    times the CPU's own bf16 error (its bf16 logits against a pass with f32
    compute and caches).  An encoder-decoder's ``frames`` (B, enc_seq,
    d_model) are encoded on each side into its cache's ``enc_out``, as the
    serving engine does."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models.model import build

    model = build(cfg)
    b, steps = toks.shape
    toks = torch.as_tensor(toks, dtype=torch.int64)
    cpu_params = {k: t.cpu() for k, t in params.items()}
    runs = [("cuda", params, torch.bfloat16), ("cpu", cpu_params, torch.bfloat16)]
    runs += [("cpu", cpu_params, torch.float32)] if exact else []
    logits = []
    for dev, p, dtype in runs:
        cache = {k: torch.zeros(s.shape, dtype=torch.float32 if dtype == torch.float32 else s.dtype,
                                device=dev)
                 for k, s in model.cache_specs(b, steps, long_mode=long_mode).items()}
        out = []
        layers.COMPUTE_DTYPE = dtype
        try:
            with torch.inference_mode():
                if frames is not None:
                    enc = model.encode(p, torch.as_tensor(frames, device=dev))
                    cache["enc_out"] = enc.to(cache["enc_out"].dtype)
                for pos in range(steps):
                    step, cache = model.decode_step(p, cache, toks[:, pos:pos + 1].to(dev), pos,
                                                    long_mode=long_mode)
                    out.append(step.float().cpu()[:, 0, :cfg.vocab])
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        logits.append(torch.stack(out))
        del cache
    card, cpu = logits[0], logits[1]
    if not torch.isfinite(card).all():
        raise SystemExit(f"{cfg.name}: non-finite logits on the card")
    own = float((cpu - logits[2]).abs().max()) if exact else None
    atol = SERVE_LOGIT_ATOL + (LOGIT_NOISE_FACTOR * own if exact else 0.0)
    top2 = cpu.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * atol
    del cpu_params
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": b, "steps": steps,
            "long_mode": long_mode, "max_abs_logit_err": float((card - cpu).abs().max()),
            "max_abs_logit": float(cpu.abs().max()), "cpu_bf16_vs_f32_logit_err": own,
            "atol": atol, "greedy_compared": int(clear.sum()),
            "greedy_equal": int((card.argmax(-1) == cpu.argmax(-1))[clear].sum())}


def serve_card_vs_cpu(cfg, run, steps: int = 2, frames=None, exact: bool = False) -> dict:
    """The served model, teacher-forced on the first ``steps`` tokens of its
    own outputs, decoded on the card and on the CPU plain path from the same
    restored weights (an encoder-decoder over its ``frames``): bf16 logits
    within the ``atol`` of :func:`decode_card_vs_cpu`."""
    row = decode_card_vs_cpu(cfg, run.served, run.outputs[:, :steps], frames=frames, exact=exact)
    print(json.dumps({"serve_card_vs_cpu": row}), flush=True)
    if row["max_abs_logit_err"] > row["atol"]:
        raise SystemExit("the served model's decode on the card disagrees with the CPU plain path")
    return row


def model_flops(cfg, params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (no recomputation counted): 6 per
    parameter per token (the tied embedding once, as the head's product),
    and attention's 4 * hd per visible (query, key) pair and head forward,
    three times that with its backward."""
    pairs = seq * (seq + 1) // 2
    return 6.0 * params * batch * seq + 12.0 * cfg.head_dim_ * cfg.num_heads * pairs * batch \
        * cfg.num_layers


def model_batch(cfg, toks, device) -> dict:
    """A loss batch from (B, S + 1) tokens on ``device``: the next token as
    the label; the inputs tokens (an encoder-decoder's beside the stub audio
    frontend's zero frames), or for an embedding-input model the stub
    frontend's embeddings of them (``train/loop.py``)."""
    import torch

    from repro_torch.train.loop import stub_embeddings

    x, y = toks[:, :-1].to(device), toks[:, 1:].to(device)
    if cfg.is_encdec:
        frames = torch.zeros((x.shape[0], cfg.enc_seq, cfg.d_model), device=device)
        return {"frames": frames, "tokens": x, "labels": y}
    if cfg.input_mode == "embeddings":
        return {"embeddings": stub_embeddings(x, cfg.d_model), "labels": y}
    return {"tokens": x, "labels": y}


def train_card_vs_cpu(cfg, params, seed: int, batch: int = TRAIN_CMP_BATCH,
                      seq: int = TRAIN_CMP_SEQ, label: str = "train_card_vs_cpu",
                      frames=None) -> dict:
    """One loss and gradient at ``batch`` x ``seq`` from ``params`` on the
    card (bf16) and on the CPU plain path, in bf16 and with f32 compute (the
    models' COMPUTE_DTYPE set to f32 for that pass): the card within
    TRAIN_NOISE_FACTOR times the CPU's own bf16 error, everything finite.
    An encoder-decoder reads ``frames`` (batch, enc_seq, d_model), or the
    trainer's zero frames."""
    import torch

    from repro_torch.models import layers
    from repro_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen)
    out, times = {}, {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        name = f"{dev}_{str(dtype)[6:]}"
        leaves = {k: t.detach().to(dev).requires_grad_(True) for k, t in params.items()}
        t, layers.COMPUTE_DTYPE = time.perf_counter(), dtype
        try:
            inputs = model_batch(cfg, toks, dev)
            if frames is not None:
                inputs["frames"] = torch.as_tensor(frames, device=dev)
            loss, _ = loss_fn(leaves, inputs)
            # a table the loss never reads (embedding inputs) gets zeros, as the step's
            grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        out[name] = (float(loss.detach()), torch.cat([g.float().cpu().reshape(-1) for g in grads]))
        times[name] = time.perf_counter() - t
        del leaves, grads
    (l_card, g_card), (l_cpu, g_cpu), (l_f32, g_f32) = out.values()
    norm = float(g_f32.norm())
    dist, noise = float((g_card - g_cpu).norm()), float((g_cpu - g_f32).norm())
    row = {"arch": cfg.name, "batch": batch, "seq": seq, "loss_card": l_card,
           "loss_cpu": l_cpu, "loss_cpu_f32": l_f32,
           "grad_rel_dist_card_cpu": dist / norm, "grad_rel_err_cpu_bf16_vs_f32": noise / norm,
           "grad_rel_dist_card_vs_f32": float((g_card - g_f32).norm()) / norm,
           "loss_atol": TRAIN_LOSS_ATOL, "noise_factor": TRAIN_NOISE_FACTOR,
           "grad_floor": TRAIN_GRAD_FLOOR, "s": times}
    print(json.dumps({label: row}), flush=True)
    if not np.isfinite([l_card, dist, noise, norm]).all() or (
            abs(l_card - l_cpu) > TRAIN_LOSS_ATOL
            or dist > TRAIN_NOISE_FACTOR * noise + TRAIN_GRAD_FLOOR * norm):
        raise SystemExit(f"{cfg.name}: a training step on the card disagrees with the CPU "
                         "plain path")
    return row


def train_phase(seed: int, zero_counts, read_counts, variant_launches) -> dict:
    """``launch/train.py``'s flow at starcoder2-3b's published widths, depth
    cut to TRAIN_LAYERS, on ``build_cluster`` (8 SPs, Clay (4,2), 256 KiB
    chunksets): a TRAIN_CORPUS_TOKENS corpus as one blob, batches of
    TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICROBATCHES microbatches, each one paid
    ``get_many``, a coded checkpoint every TRAIN_CKPT_EVERY steps, an SP
    crashed at TRAIN_FAIL_AT, the checkpoint restored k-of-n (equal to the
    saved state), the SP wiped and repaired, the steps after the checkpoint
    run again.  Then one step under the profiler and one loss and gradient
    against the CPU plain path."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import loss_fell, train
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    n_params = build(cfg).param_count()
    print(json.dumps({"train_config": {
        "arch": cfg.name, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "norm": cfg.norm, "mlp": cfg.mlp, "params": n_params,
        "layers": f"{cfg.num_layers} (cut from {get(TRAIN_ARCH).num_layers}: host-bound "
                  "checkpoint I/O)",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICROBATCHES,
        "corpus_tokens": TRAIN_CORPUS_TOKENS, "steps": TRAIN_STEPS,
        "ckpt_every": TRAIN_CKPT_EVERY, "fail_at": TRAIN_FAIL_AT}}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # count the training path only
    run = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_every=TRAIN_CKPT_EVERY, fail_at=TRAIN_FAIL_AT,
                num_microbatches=TRAIN_MICROBATCHES, corpus_tokens=TRAIN_CORPUS_TOKENS,
                device="cuda", seed=seed)
    torch.cuda.synchronize()
    counts = read_counts("train")
    tile_designs = dict(fa.flash_attention.design_launches)
    steps_run = len(run.losses)
    backward = TRAIN_LAYERS * TRAIN_MICROBATCHES * steps_run
    if not all(np.isfinite(run.losses)):
        raise SystemExit(f"non-finite training loss: {run.losses}")
    if (counts["gf_matmul"] == 0 or counts["flash_attention_bwd"] != backward
            or counts["flash_attention"] != 2 * backward  # each forward again in its backward
            or variant_launches["train"]["tile"] != counts["flash_attention"]
            or tile_designs != {"wgmma": counts["flash_attention"], "mma": 0}):
        raise SystemExit(f"the training path's launches are off: {counts}, "
                         f"attention {variant_launches['train']} (tile {tile_designs}), "
                         f"{backward} backward expected, every forward on wgmma")
    if run.restored_step != TRAIN_CKPT_EVERY or not run.restored_equal:
        raise SystemExit(f"restored step {run.restored_step}: equal {run.restored_equal}")
    if not run.repairs or run.repair_failures or not all(r.verified for r in run.repairs):
        raise SystemExit(f"repairs after the crash: {len(run.repairs)}, "
                         f"failures {run.repair_failures[:3]}")
    step_s = [t for rep in run.reports for t in rep.step_s]
    data_s = [t for rep in run.reports for t in rep.data_s]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]  # the median, past the first step
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    mem = torch.cuda.max_memory_allocated()
    x, y = next(run.dataset.batches(1, background=False))
    batch = {"tokens": torch.as_tensor(x, dtype=torch.int64, device="cuda"),
             "labels": torch.as_tensor(y, dtype=torch.int64, device="cuda")}
    busy = device_busy(lambda: run.trainer.step_fn(run.state, batch))
    rep0 = run.reports[0]
    row = {
        "losses": run.losses, "loss_fell": loss_fell(run.losses), "steps_run": steps_run,
        "step_s": step_s, "steady_step_s": steady, "tokens/s": tokens / steady,
        "model_flops_per_step": flops, "mfu_of_989_tflops": flops / steady / H100_BF16_FLOPS,
        "data_wait_s": data_s, "data_wall_share": sum(data_s) / (sum(data_s) + sum(step_s)),
        "profiled_step": busy, "corpus_put_s": run.corpus_put_s,
        "ckpt_bytes": rep0.ckpt_bytes, "ckpt_save_s": rep0.ckpt_s,
        "ckpt_save_GB/s": rep0.ckpt_bytes / rep0.ckpt_s / 1e9,
        "restored_step": run.restored_step, "restored_equal": run.restored_equal,
        "restore_s": run.restore_s, "restore_GB/s": run.restore_bytes / run.restore_s / 1e9,
        "repairs": len(run.repairs), "repairs_msr": sum(r.mode == "msr" for r in run.repairs),
        "repair_s": run.repair_s, "launches": counts, "max_memory_allocated": mem,
    }
    print(json.dumps({"train": row}), flush=True)
    params = run.state["params"]
    del run, batch
    row["card_vs_cpu"] = train_card_vs_cpu(cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def recorded_routes(records: list):
    """Record each MoE layer's router input, weights and chosen experts
    (``models/moe.py::_route``) while the block runs."""
    from repro_torch.models import moe

    real = moe._route

    def recording(x, w, k):
        out = real(x, w, k)
        records.append((x.detach(), w.detach(), out[0].detach()))
        return out

    moe._route = recording
    try:
        yield
    finally:
        moe._route = real


def expert_load(cfg, records) -> list[dict]:
    """Per recorded MoE layer: each expert's routed assignments, the capacity,
    the assignments dropped past it, and the smallest router margin (the
    top-k-th probability against the next) over the tokens."""
    import torch

    from repro_torch.models.moe import capacity_of

    rows = []
    for x, w, idx in records:
        k = cfg.moe.top_k
        load = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts).cpu()
        cap = capacity_of(x.shape[0], cfg)
        probs = torch.softmax(x.float() @ w.float(), dim=-1).topk(k + 1, dim=-1).values
        rows.append({"tokens": x.shape[0], "capacity": cap, "load": load.tolist(),
                     "dropped": int((load - cap).clamp(min=0).sum()),
                     "experts_used": int((load > 0).sum()),
                     "min_router_margin": float((probs[:, k - 1] - probs[:, k]).min())})
    return rows


def families_phase(seed: int, zero_counts, read_counts, variant_launches) -> dict:
    """The MoE, SSM, hybrid and embedding-input families on the card.

    Counted as the path ``families``: hymba at its published widths, depth
    cut to FAMILY_LAYERS, served from Shelby (``launch/serve.py``'s
    ``serve``: publish, an SP crashed, a verified k-of-n restore, batch 4 x
    (8 + 16)), FAMILY_WARM warm generations, the same prompts through
    ``ServeEngine(long_mode=True)`` (its ring never wraps at 25 positions:
    the tokens equal), one long-mode generation over FAMILY_LONG_POSITIONS
    positions (``make_decode_step(long_mode=True)``: the ring wraps), two
    ``make_train_step`` steps at 1 x FAMILY_TRAIN_SEQ, qwen3-moe at its
    published widths cut to FAMILY_MOE_LAYERS layer(s) prefilling 1 x
    FAMILY_MOE_SEQ (each expert's load and the drops reported), and
    ``launch/train.py``'s ``train`` on phi-3-vision-smoke (stub embeddings
    through the blob pipeline, an SP crash, the restore, the repair).  Then,
    uncounted, the card against the CPU plain path: hymba teacher-forced two
    steps and a 1 x 256 loss and gradient; qwen3-moe's prefill logits;
    falcon-mamba, qwen3-moe and phi-3-vision at smoke widths (loss, gradient,
    8 decode positions); hymba-smoke in long mode over FAMILY_SMOKE_LONG
    positions, past its 32-slot window."""
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import loss_fell, train
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get(FAMILY_ARCH), num_layers=FAMILY_LAYERS)
    qcfg = dataclasses.replace(get(FAMILY_MOE_ARCH), num_layers=FAMILY_MOE_LAYERS)
    print(json.dumps({"families_config": {
        "hybrid": {"arch": cfg.name, "d_model": cfg.d_model, "heads": cfg.num_heads,
                   "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
                   "d_inner": cfg.ssm.d_inner, "state": cfg.ssm.state, "vocab": cfg.vocab,
                   "long_window": cfg.long_window, "params": build(cfg).param_count(),
                   "layers": f"{cfg.num_layers} (cut from {get(FAMILY_ARCH).num_layers})"},
        "moe": {"arch": qcfg.name, "d_model": qcfg.d_model, "heads": qcfg.num_heads,
                "kv_heads": qcfg.num_kv_heads, "head_dim": qcfg.head_dim_,
                "experts": qcfg.moe.num_experts, "top_k": qcfg.moe.top_k,
                "expert_d_ff": qcfg.moe.expert_d_ff, "vocab": qcfg.vocab,
                "params": build(qcfg).param_count(),
                "layers": f"{qcfg.num_layers} (cut from {get(FAMILY_MOE_ARCH).num_layers})"},
        "smoke": list(FAMILY_SMOKE_ARCHS)}}), flush=True)
    row: dict = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # count the families path only

    # 1. hymba served from Shelby, warm generations, long mode
    batch, prompt, gen = 4, 8, 16
    run = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, kill_sp=True, device="cuda",
                seed=seed)
    torch.cuda.synchronize()
    if not all(torch.equal(run.served[k], run.published[k]) for k in run.published):
        raise SystemExit("hymba: restored weights differ from the published ones")
    engine = ServeEngine(cfg, run.served, max_len=prompt + gen + 1)
    warm_s = []
    for _ in range(FAMILY_WARM):
        t = time.perf_counter()
        warm = engine.generate(run.prompts, num_tokens=gen)
        warm_s.append(time.perf_counter() - t)
    ring = ServeEngine(cfg, run.served, max_len=prompt + gen + 1, long_mode=True)
    long_out = ring.generate(run.prompts, num_tokens=gen)
    if not (np.array_equal(warm, run.outputs) and np.array_equal(long_out, run.outputs)):
        raise SystemExit("hymba: warm or long-mode generation differs from the served tokens")
    decode = make_decode_step(cfg, long_mode=True)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device="cuda") for k, s in
             build(cfg).cache_specs(1, FAMILY_LONG_POSITIONS + 1, long_mode=True).items()}
    given = torch.as_tensor(run.prompts[:1], dtype=torch.int64, device="cuda")
    tok, finite = given[:, :1], torch.ones((), dtype=torch.bool, device="cuda")
    split0 = fa.flash_attention.variant_launches["split"]
    t = time.perf_counter()
    for pos in range(FAMILY_LONG_POSITIONS):
        logits, cache = decode(run.served, cache, tok, pos)
        finite &= torch.isfinite(logits).all()
        tok = given[:, pos + 1:pos + 2] if pos + 1 < prompt else \
            logits[:, -1].argmax(-1, keepdim=True).clamp_(max=cfg.vocab - 1)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t
    long_split = fa.flash_attention.variant_launches["split"] - split0
    row["serve"] = {
        "weight_bytes": run.record.total_bytes, "publish_s": run.publish_s,
        "publish_GB/s": run.record.total_bytes / run.publish_s / 1e9,
        "restore_s": run.restore_s, "restore_GB/s": run.record.total_bytes / run.restore_s / 1e9,
        "restored_equal": True, "first_decode_s": run.decode_s, "warm_decode_s": warm_s,
        "decode_tok/s": run.decoded_tokens / sorted(warm_s)[FAMILY_WARM // 2],
        "long_mode_tokens_equal": True, "long_positions": FAMILY_LONG_POSITIONS,
        "long_cache_slots": int(cache["k"].shape[2]), "long_s": long_s,
        "long_tok/s": FAMILY_LONG_POSITIONS / long_s, "long_split_launches": long_split,
        "long_logits_finite": bool(finite)}
    print(json.dumps({"families_serve": row["serve"]}), flush=True)
    if not bool(finite) or long_split != FAMILY_LONG_POSITIONS * cfg.num_layers:
        raise SystemExit(f"hymba long mode: finite {bool(finite)}, {long_split} split launches "
                         f"for {FAMILY_LONG_POSITIONS} positions x {cfg.num_layers} layers")
    del engine, ring, cache

    # 2. hymba's training step at 1 x FAMILY_TRAIN_SEQ
    gen_card = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(build(cfg).param_specs(), gen_card, device="cuda")
    state = opt.init_state(params)
    toks = torch.randint(0, cfg.vocab, (1, FAMILY_TRAIN_SEQ + 1), generator=gen_card,
                         device="cuda")
    step_fn = make_train_step(cfg)
    fwd0, bwd0 = fa.flash_attention.variant_launches["tile"], fab.flash_attention_bwd.launches
    wgmma0 = fab.flash_attention_bwd.design_launches["wgmma"]
    fwd_wgmma0 = fa.flash_attention.design_launches["wgmma"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(FAMILY_TRAIN_STEPS):
        t = time.perf_counter()
        state, metrics = step_fn(state, model_batch(cfg, toks, "cuda"))
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t)
    backward = fab.flash_attention_bwd.launches - bwd0
    forward = fa.flash_attention.variant_launches["tile"] - fwd0
    wgmma = fab.flash_attention_bwd.design_launches["wgmma"] - wgmma0
    fwd_wgmma = fa.flash_attention.design_launches["wgmma"] - fwd_wgmma0
    row["train"] = {"batch": 1, "seq": FAMILY_TRAIN_SEQ, "losses": losses, "step_s": step_s,
                    "tokens/s": FAMILY_TRAIN_SEQ / step_s[-1],
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "attention_forward_launches": forward, "attention_backward_launches": backward,
                    "forward_wgmma_launches": fwd_wgmma, "backward_wgmma_launches": wgmma}
    print(json.dumps({"families_train": row["train"]}), flush=True)
    want = FAMILY_TRAIN_STEPS * cfg.num_layers
    if (not all(np.isfinite(losses)) or backward != want or wgmma != want
            or forward != 2 * want or fwd_wgmma != forward):
        raise SystemExit(f"hymba training: losses {losses}, forward {forward} (wgmma "
                         f"{fwd_wgmma}), backward {backward} (wgmma {wgmma}); {want} backward "
                         "expected, every launch on wgmma")
    trained = state["params"]
    del state, params, metrics

    # 3. qwen3-moe's prefill at published widths
    qparams = init_params(build(qcfg).param_specs(), gen_card, device="cuda")
    qtoks = torch.randint(0, qcfg.vocab, (1, FAMILY_MOE_SEQ), generator=gen_card, device="cuda")
    routes: list = []
    designs0 = dict(fa.flash_attention.design_launches)
    with recorded_routes(routes):
        t = time.perf_counter()
        qlogits, qcache = make_prefill_step(qcfg)(qparams, {"tokens": qtoks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    prefill_designs = {d: c - designs0[d] for d, c in fa.flash_attention.design_launches.items()}
    row["moe"] = {"prefill_s": prefill_s, "cache_shape": list(qcache["k"].shape),
                  "layers": expert_load(qcfg, routes), "attention_tile_designs": prefill_designs}
    print(json.dumps({"families_moe": row["moe"]}), flush=True)
    if prefill_designs != {"wgmma": FAMILY_MOE_LAYERS, "mma": 0}:
        raise SystemExit(f"qwen3-moe's prefill launched {prefill_designs}, not "
                         f"{FAMILY_MOE_LAYERS} wgmma")
    del qcache, routes

    # 4. launch/train.py's flow on phi-3-vision-smoke: stub embeddings from the blob corpus
    # (its CLI's loss check is reported, not gated: on random tokens at smoke size the
    # head and tail means of the loss differ by noise)
    vcfg = get_smoke("phi-3-vision-4.2b")
    vrun = train(vcfg, steps=16, batch=4, seq=48, ckpt_every=4, fail_at=6, device="cuda",
                 seed=seed)
    torch.cuda.synchronize()
    row["embeddings_train"] = {"losses": vrun.losses, "loss_fell": loss_fell(vrun.losses),
                               "restored_step": vrun.restored_step,
                               "restored_equal": vrun.restored_equal, "repairs": len(vrun.repairs),
                               "repair_failures": len(vrun.repair_failures)}
    print(json.dumps({"families_embeddings_train": row["embeddings_train"]}), flush=True)
    if (not all(np.isfinite(vrun.losses)) or not vrun.restored_equal or not vrun.repairs
            or vrun.repair_failures or not all(r.verified for r in vrun.repairs)):
        raise SystemExit(f"phi-3-vision training: {row['embeddings_train']}")
    del vrun

    counts = read_counts("families")
    designs = dict(fab.flash_attention_bwd.design_launches)
    row["launches"] = counts
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if (counts["gf_matmul"] == 0 or variant_launches["families"]["tile"] == 0
            or variant_launches["families"]["split"] == 0 or designs["wgmma"] == 0):
        raise SystemExit(f"the families path's launches are off: {counts}, "
                         f"attention {variant_launches['families']}, backward {designs}")

    # 5. the card against the CPU plain path (uncounted)
    row["serve_card_vs_cpu"] = serve_card_vs_cpu(cfg, run)
    row["train_card_vs_cpu"] = train_card_vs_cpu(cfg, trained, seed,
                                                 label="families_train_card_vs_cpu")
    del run, trained
    qcpu = {k: t.cpu() for k, t in qparams.items()}
    with torch.inference_mode():
        qref, _ = make_prefill_step(qcfg)(qcpu, {"tokens": qtoks.cpu()})
    card_l, cpu_l = qlogits.float().cpu()[..., :qcfg.vocab], qref.float()[..., :qcfg.vocab]
    err = float((card_l - cpu_l).abs().max())
    row["moe"]["prefill_card_vs_cpu"] = {"max_abs_logit_err": err, "atol": SERVE_LOGIT_ATOL,
                                         "max_abs_logit": float(cpu_l.abs().max())}
    print(json.dumps({"families_moe_card_vs_cpu": row["moe"]["prefill_card_vs_cpu"]}), flush=True)
    if not torch.isfinite(card_l).all() or err > SERVE_LOGIT_ATOL:
        raise SystemExit("qwen3-moe's prefill on the card disagrees with the CPU plain path")
    del qparams, qcpu, qlogits, qref, card_l, cpu_l
    torch.cuda.empty_cache()
    gen_cpu = torch.Generator().manual_seed(seed)
    for arch in FAMILY_SMOKE_ARCHS + ("hymba-1.5b",):
        scfg = get_smoke(arch)
        sparams = init_params(build(scfg).param_specs(), gen_cpu, device="cpu")
        sparams = {k: t.cuda() for k, t in sparams.items()}
        stoks = torch.randint(0, scfg.vocab, (FAMILY_SMOKE_BATCH, FAMILY_SMOKE_LONG),
                              generator=gen_cpu).numpy()
        if arch == "hymba-1.5b":  # long mode past the window, wrapped
            dec = decode_card_vs_cpu(scfg, sparams, stoks, long_mode=True)
        else:
            row[f"{arch}_train_card_vs_cpu"] = train_card_vs_cpu(
                scfg, sparams, seed, batch=FAMILY_SMOKE_BATCH, seq=FAMILY_SMOKE_SEQ,
                label="families_smoke_train_card_vs_cpu")
            dec = decode_card_vs_cpu(scfg, sparams, stoks[:, :FAMILY_SMOKE_DECODE])
        row[f"{arch}_decode_card_vs_cpu"] = dec
        print(json.dumps({"families_smoke_decode_card_vs_cpu": dec}), flush=True)
        if dec["max_abs_logit_err"] > SERVE_LOGIT_ATOL or dec["greedy_equal"] != dec["greedy_compared"]:
            raise SystemExit(f"{arch}: decode on the card disagrees with the CPU plain path")
    row["s"] = time.perf_counter() - t_phase
    print(json.dumps({"families": {"s": row["s"], "launches": counts, "backward_designs": designs,
                                   "max_memory_allocated": row["max_memory_allocated"]}}),
          flush=True)
    return row


def train_steps(cfg, state, batch, design: str, attentions: int) -> tuple[dict, dict]:
    """Two ``make_train_step`` steps on ``batch`` (its peak memory from a
    reset): ``attentions`` attention calls a forward pass, each a "tile"
    launch of the "wgmma" design, run again in its backward under per-layer
    recomputation, and one backward launch of ``design`` each.  Returns
    (row, the new state)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.train.step import make_train_step

    step_fn = make_train_step(cfg)
    fwd0, bwd0 = fa.flash_attention.variant_launches["tile"], fab.flash_attention_bwd.launches
    design0 = fab.flash_attention_bwd.design_launches[design]
    fwd_wgmma0 = fa.flash_attention.design_launches["wgmma"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(2):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t)
    forward = fa.flash_attention.variant_launches["tile"] - fwd0
    backward = fab.flash_attention_bwd.launches - bwd0
    ran = fab.flash_attention_bwd.design_launches[design] - design0
    fwd_wgmma = fa.flash_attention.design_launches["wgmma"] - fwd_wgmma0
    b, s = batch["labels"].shape
    row = {"arch": cfg.name, "batch": b, "seq": s, "losses": losses, "step_s": step_s,
           "tokens/s": b * s / step_s[-1], "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "attention_forward_launches": forward, "attention_backward_launches": backward,
           "forward_wgmma_launches": fwd_wgmma, f"backward_{design}_launches": ran}
    print(json.dumps({"mla_encdec_train": row}), flush=True)
    want = 2 * attentions
    if (not all(np.isfinite(losses)) or backward != want or ran != want or forward != 2 * want
            or fwd_wgmma != forward):
        raise SystemExit(f"{cfg.name} training: losses {losses}, forward {forward} (wgmma "
                         f"{fwd_wgmma}), backward {backward} ({design} {ran}); {want} backward "
                         "expected, every forward on wgmma")
    return row, state


def mla_encdec_phase(seed: int, zero_counts, read_counts, variant_launches) -> dict:
    """MLA and the encoder-decoder on the card, counted as the path ``mla_encdec``.

    whisper-tiny at its published config (nothing cut) served from Shelby
    (``launch/serve.py``'s ``serve`` over seeded stub frames of enc_seq x
    d_model: publish, an SP crashed, a verified k-of-n restore, batch 4 x (8
    + 16)), ENCDEC_WARM warm generations (the same tokens), two
    ``make_train_step`` steps at ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ over
    zero frames; deepseek-v2-lite at its published widths, depth cut to
    MLA_LAYERS (its leading dense layer and one MLA + MoE layer), made on the
    card from a seed: a 1 x MLA_SEQ prefill (each expert's load, the drops),
    the absorbed decode of batch 4 x (8 + 16) (plain products: no attention
    kernel), two ``make_train_step`` steps at 1 x MLA_SEQ.  Then, uncounted,
    the card against the CPU plain path: whisper teacher-forced two steps over
    zero frames (within SERVE_LOGIT_ATOL) and over the seeded ones (within
    that plus LOGIT_NOISE_FACTOR times the CPU's own bf16 error), its 1 x
    ENCDEC_CMP_SEQ gradient over the first seeded frames at the initial
    weights; both at smoke widths (loss, gradient, 8 decode positions).
    deepseek at its published widths is not held against the CPU (its CPU
    plain prefill and gradient at 1.09 B parameters were the slowest part of
    the script); its smoke config is."""
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_prefill_step

    t_phase = time.perf_counter()
    wcfg = get(ENCDEC_ARCH)
    dcfg = dataclasses.replace(get(MLA_ARCH), num_layers=MLA_LAYERS)
    m = dcfg.mla
    print(json.dumps({"mla_encdec_config": {
        "encdec": {"arch": wcfg.name, "d_model": wcfg.d_model, "heads": wcfg.num_heads,
                   "head_dim": wcfg.head_dim_, "d_ff": wcfg.d_ff, "enc_layers": wcfg.enc_layers,
                   "dec_layers": wcfg.num_layers, "enc_seq": wcfg.enc_seq, "vocab": wcfg.vocab,
                   "params": build(wcfg).param_count(), "cut": "nothing"},
        "mla": {"arch": dcfg.name, "d_model": dcfg.d_model, "heads": dcfg.num_heads,
                "qk_head_dim": m.qk_nope_head_dim + m.qk_rope_head_dim,
                "v_head_dim": m.v_head_dim, "kv_lora_rank": m.kv_lora_rank,
                "experts": dcfg.moe.num_experts, "top_k": dcfg.moe.top_k,
                "shared": dcfg.moe.num_shared, "vocab": dcfg.vocab,
                "params": build(dcfg).param_count(),
                "layers": f"{dcfg.num_layers} (cut from {get(MLA_ARCH).num_layers}: the leading "
                          "dense layer and one MLA + MoE layer)"},
        "smoke": list(MLA_ENCDEC_SMOKE)}}), flush=True)
    row: dict = {}
    zero_counts()  # count this path only

    def launched(before: dict) -> dict:
        return {n: c - before[n] for n, c in fa.flash_attention.variant_launches.items()}

    def tile_designs(before: dict) -> dict:
        return {n: c - before[n] for n, c in fa.flash_attention.design_launches.items()}

    # 1. whisper-tiny served from Shelby at its full size
    batch, prompt, gen = 4, 8, 16
    frames = np.random.default_rng(seed).standard_normal(
        (batch, wcfg.enc_seq, wcfg.d_model)).astype(np.float32)
    before = dict(fa.flash_attention.variant_launches)
    before_designs = dict(fa.flash_attention.design_launches)
    run = serve(wcfg, batch=batch, prompt_len=prompt, gen=gen, kill_sp=True, device="cuda",
                seed=seed, frames=frames)
    torch.cuda.synchronize()
    if not all(torch.equal(run.served[k], run.published[k]) for k in run.published):
        raise SystemExit("whisper: restored weights differ from the published ones")
    if not ((run.outputs >= 0) & (run.outputs < wcfg.vocab)).all():
        raise SystemExit("whisper: generated token ids out of the vocabulary")
    engine = ServeEngine(wcfg, run.served, max_len=prompt + gen + 1)
    warm_s = []
    for _ in range(ENCDEC_WARM):
        t = time.perf_counter()
        warm = engine.generate(run.prompts, num_tokens=gen, frames=frames)
        warm_s.append(time.perf_counter() - t)
        if not np.array_equal(warm, run.outputs):
            raise SystemExit("whisper: a warm generation differs from the served tokens")
    serve_launches = launched(before)
    serve_designs = tile_designs(before_designs)
    gens, steps = 1 + ENCDEC_WARM, prompt + gen - 1
    # per generation: the encoder's layers once ("tile"), then per step and decoder layer
    # self- and cross-attention ("split" at Sq = 1)
    want = {"tile": gens * wcfg.enc_layers, "split": gens * steps * wcfg.num_layers * 2,
            "general": 0}
    row["serve"] = {
        "weight_bytes": run.record.total_bytes, "publish_s": run.publish_s,
        "publish_GB/s": run.record.total_bytes / run.publish_s / 1e9,
        "restore_s": run.restore_s, "restore_GB/s": run.record.total_bytes / run.restore_s / 1e9,
        "restored_equal": True, "first_generation_s": run.decode_s, "warm_generation_s": warm_s,
        "decode_tok/s": run.decoded_tokens / sorted(warm_s)[ENCDEC_WARM // 2],
        "attention_launches": serve_launches, "attention_tile_designs": serve_designs}
    print(json.dumps({"mla_encdec_serve": row["serve"]}), flush=True)
    # the encoder over 1,500 frames: every "tile" launch on "wgmma"
    if serve_launches != want or serve_designs != {"wgmma": want["tile"], "mma": 0}:
        raise SystemExit(f"whisper serving launched {serve_launches} (tile {serve_designs}), "
                         f"not {want}, every tile on wgmma")
    del engine

    # 2. whisper's training steps at ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ over zero frames
    gen_card = torch.Generator(device="cuda").manual_seed(seed)
    wparams = init_params(build(wcfg).param_specs(), gen_card, device="cuda")
    toks = torch.randint(0, wcfg.vocab, (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ + 1),
                         generator=gen_card, device="cuda")
    row["encdec_train"], state = train_steps(wcfg, opt.init_state(wparams),
                                             model_batch(wcfg, toks, "cuda"), "wgmma",
                                             wcfg.enc_layers + 2 * wcfg.num_layers)
    del state

    # 3. deepseek-v2-lite at its published widths, depth MLA_LAYERS
    dparams = init_params(build(dcfg).param_specs(), gen_card, device="cuda")
    dtoks = torch.randint(0, dcfg.vocab, (1, MLA_SEQ + 1), generator=gen_card, device="cuda")
    routes: list = []
    before = dict(fa.flash_attention.variant_launches)
    before_designs = dict(fa.flash_attention.design_launches)
    with recorded_routes(routes):
        t = time.perf_counter()
        _, dcache = make_prefill_step(dcfg)(dparams, {"tokens": dtoks[:, :MLA_SEQ]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    prefill_launches = launched(before)
    prefill_designs = tile_designs(before_designs)
    row["mla_prefill"] = {"seq": MLA_SEQ, "prefill_s": prefill_s,
                          "cache_shapes": {k: list(v.shape) for k, v in dcache.items()},
                          "attention_launches": prefill_launches,
                          "attention_tile_designs": prefill_designs,
                          "layers": expert_load(dcfg, routes)}
    print(json.dumps({"mla_encdec_mla_prefill": row["mla_prefill"]}), flush=True)
    if (prefill_launches != {"tile": MLA_LAYERS, "split": 0, "general": 0}
            or prefill_designs != {"wgmma": MLA_LAYERS, "mma": 0}):
        raise SystemExit(f"deepseek prefill launched {prefill_launches} (tile {prefill_designs})")
    del dcache, routes
    prompts = np.random.default_rng(seed).integers(0, dcfg.vocab, (batch, prompt)).astype(np.int32)
    engine = ServeEngine(dcfg, dparams, max_len=prompt + gen + 1)
    before = dict(fa.flash_attention.variant_launches)
    decode_s = []
    for _ in range(1 + ENCDEC_WARM):
        t = time.perf_counter()
        dout = engine.generate(prompts, num_tokens=gen)
        decode_s.append(time.perf_counter() - t)
    decode_launches = launched(before)
    row["mla_decode"] = {"batch": batch, "first_generation_s": decode_s[0],
                         "warm_generation_s": decode_s[1:],
                         "decode_tok/s": batch * steps / sorted(decode_s[1:])[ENCDEC_WARM // 2],
                         "cache_bytes_per_token_per_layer": 2 * (m.kv_lora_rank
                                                                 + m.qk_rope_head_dim),
                         "attention_launches": decode_launches}
    print(json.dumps({"mla_encdec_mla_decode": row["mla_decode"]}), flush=True)
    if not ((dout >= 0) & (dout < dcfg.vocab)).all() or any(decode_launches.values()):
        raise SystemExit(f"deepseek decode: tokens in range {((dout >= 0) & (dout < dcfg.vocab)).all()}, "
                         f"attention launches {decode_launches} (the absorbed decode has none)")
    del engine
    state = opt.init_state(dparams)
    del dparams
    row["mla_train"], state = train_steps(dcfg, state, model_batch(dcfg, dtoks, "cuda"), "wgmma",
                                          MLA_LAYERS)
    del state

    counts = read_counts("mla_encdec")
    designs = dict(fab.flash_attention_bwd.design_launches)
    row["launches"] = counts
    attn = variant_launches["mla_encdec"]
    if (counts["gf_matmul"] == 0 or attn["tile"] == 0 or attn["split"] == 0
            or designs["mma"] != 0 or designs["wgmma"] == 0):
        raise SystemExit(f"the mla_encdec path's launches are off: {counts}, attention {attn}, "
                         f"backward {designs}")

    # 4. the card against the CPU plain path (uncounted).  Whisper over the stub frames
    # the JAX package's trainer feeds (zeros: a constant encoding) within SERVE_LOGIT_ATOL,
    # and over the served seeded frames relative to the CPU's own bf16 error: there the
    # encoder's attention is one-hot over 1,500 keys (LOGIT_NOISE_FACTOR's comment)
    row["encdec_serve_card_vs_cpu"] = serve_card_vs_cpu(wcfg, run, frames=np.zeros_like(frames))
    row["encdec_serve_card_vs_cpu_frames"] = serve_card_vs_cpu(wcfg, run, frames=frames,
                                                               exact=True)
    del run
    # over the seeded frames: on zero frames every LayerNorm of the encoder normalises
    # zeros, each multiplies the gradient by 1/sqrt(eps) = 1000 and the f32 norm of the
    # encoder's gradient (~8e27) overflows in any computation
    row["encdec_train_card_vs_cpu"] = train_card_vs_cpu(
        wcfg, wparams, seed, batch=1, seq=ENCDEC_CMP_SEQ, label="mla_encdec_train_card_vs_cpu",
        frames=frames[:1])
    del wparams
    # deepseek at its published widths is not held against the CPU here: its CPU plain
    # prefill and gradient took most of this phase; MLA_ENCDEC_SMOKE holds it at smoke widths
    torch.cuda.empty_cache()
    gen_cpu = torch.Generator().manual_seed(seed)
    for arch in MLA_ENCDEC_SMOKE:
        scfg = get_smoke(arch)
        sparams = init_params(build(scfg).param_specs(), gen_cpu, device="cpu")
        sparams = {k: t.cuda() for k, t in sparams.items()}
        stoks = torch.randint(0, scfg.vocab, (FAMILY_SMOKE_BATCH, FAMILY_SMOKE_SEQ + 1),
                              generator=gen_cpu)
        row[f"{arch}_train_card_vs_cpu"] = train_card_vs_cpu(
            scfg, sparams, seed, batch=FAMILY_SMOKE_BATCH, seq=FAMILY_SMOKE_SEQ,
            label="mla_encdec_smoke_train_card_vs_cpu")
        sframes = None
        if scfg.is_encdec:
            sframes = torch.randn((FAMILY_SMOKE_BATCH, scfg.enc_seq, scfg.d_model),
                                  generator=gen_cpu).numpy()
        dec = decode_card_vs_cpu(scfg, sparams, stoks[:, :FAMILY_SMOKE_DECODE].numpy(),
                                 frames=sframes, exact=scfg.is_encdec)
        row[f"{arch}_decode_card_vs_cpu"] = dec
        print(json.dumps({"mla_encdec_smoke_decode_card_vs_cpu": dec}), flush=True)
        if dec["max_abs_logit_err"] > dec["atol"] or dec["greedy_equal"] != dec["greedy_compared"]:
            raise SystemExit(f"{arch}: decode on the card disagrees with the CPU plain path")
    row["s"] = time.perf_counter() - t_phase
    print(json.dumps({"mla_encdec": {"s": row["s"], "launches": counts,
                                     "attention_variants": attn, "backward_designs": designs}}),
          flush=True)
    return row


def _dryrun_inputs(cfg, shape, gen):
    """The arguments of one cell's step on the card, made from ``gen``: the
    train state and a batch of token ids; the bf16 serving weights and a
    prefill batch; or those weights, a zero decode cache, tokens and the
    position of the cache's last slot.  Returns (run, argument bytes)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shapes import num_microbatches, serve_param_specs
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

    model = build(cfg)
    b, s = shape.global_batch, shape.seq_len
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    if shape.kind == "train":
        state = opt.init_state(init_params(model.param_specs(), gen, device="cuda"))
        batch = model_batch(cfg, toks, "cuda")
        step = make_train_step(cfg, num_microbatches=num_microbatches(cfg, shape,
                                                                       make_local_mesh()))
        args = [*state["params"].values(), *state["m"].values(), *state["v"].values(),
                state["step"], *batch.values()]
        return (lambda: step(state, batch)), sum(t.numel() * t.element_size() for t in args)
    params = init_params(serve_param_specs(model), gen, device="cuda", dtype=torch.bfloat16)
    if shape.kind == "prefill":
        batch = {"tokens": toks[:, :-1].contiguous()}
        step = make_prefill_step(cfg)
        args = [*params.values(), *batch.values()]
        return (lambda: step(params, batch)), sum(t.numel() * t.element_size() for t in args)
    long_mode = shape.name.startswith("long")
    cache = {k: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda")
             for k, sp in model.cache_specs(b, s, long_mode=long_mode).items()}
    tokens = toks[:, :1].contiguous()
    step = make_decode_step(cfg, long_mode=long_mode)
    args = [*params.values(), *cache.values(), tokens]
    return ((lambda: step(params, cache, tokens, s - 1)),
            sum(t.numel() * t.element_size() for t in args) + 4)  # + the int32 position


def dryrun_phase(seed: int, zero_counts, read_counts, variant_launches) -> dict:
    """The dry-run against the card, counted as the path ``dryrun``.

    For each of ``_dryrun_cells()`` (published widths, depth cut to DRYRUN_LAYERS,
    the per-device batch of the single-pod mesh on a one-device mesh):
    predict the step's peak memory and its FLOPs with
    ``launch/dryrun.py::estimate`` on the meta device, build the same step
    on the card from a seed, run it once, then once more after
    ``reset_peak_memory_stats``.  The measured peak is the arguments' bytes
    plus what the step allocated above the memory held at the reset (so
    what earlier phases still hold does not count); it must be within
    DRYRUN_PEAK_TOL of the prediction, and the temporaries above the
    arguments within DRYRUN_TEMP_TOL or DRYRUN_TEMP_SLACK of the predicted
    ones.  Prints predicted and measured peak and temporaries and their gaps,
    the predicted FLOPs, the step's wall time and FLOPs over wall time as a
    share of the bf16 peak.  The trace's FLOPs are those executed (the
    recomputed forward of every checkpointed layer, the backward's products,
    padded head dims), so that share is a hardware share, not a model-FLOPs
    share (phase 15's ``mfu_of_989_tflops`` is one)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    mesh = make_local_mesh()
    rows = {}
    zero_counts()  # count this path only
    for arch, shape in _dryrun_cells():
        cfg = dataclasses.replace(get(arch), num_layers=DRYRUN_LAYERS)
        t = time.perf_counter()
        pred = estimate(cfg, shape, mesh)
        predict_s = time.perf_counter() - t
        gen = torch.Generator(device="cuda").manual_seed(seed)
        run, arg_bytes = _dryrun_inputs(cfg, shape, gen)
        if arg_bytes != pred["memory"]["argument_bytes"]:
            raise SystemExit(f"dryrun {arch} {shape.name}: arguments on the card {arg_bytes} B, "
                             f"predicted {pred['memory']['argument_bytes']} B")
        variants0 = dict(fa.flash_attention.variant_launches)
        designs0 = dict(fab.flash_attention_bwd.design_launches)
        out = run()  # warm: kernels loaded, cuBLAS handles made
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        measured = arg_bytes + torch.cuda.max_memory_allocated() - held
        del out
        predicted = pred["memory"]["peak_bytes"]
        flops = pred["cost"]["flops"]
        row = {
            "arch": arch, "shape": shape.name, "layers": DRYRUN_LAYERS,
            "batch": shape.global_batch, "seq": shape.seq_len,
            "num_microbatches": pred["num_microbatches"],
            "predicted_peak_bytes": predicted, "measured_peak_bytes": measured,
            "gap": measured / predicted - 1, "argument_bytes": arg_bytes,
            "predicted_temp_bytes": pred["memory"]["temp_bytes"],
            "measured_temp_bytes": measured - arg_bytes,
            "temp_gap_bytes": measured - arg_bytes - pred["memory"]["temp_bytes"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "predicted_flops": flops, "predicted_kernels": pred["kernels"], "predict_s": predict_s,
            "step_s": wall, "executed_flops/s": flops / wall,
            "executed_flops_share_of_989_tflops": flops / wall / H100_BF16_FLOPS,
            "attention_launches": {k: (v - variants0[k]) // 2
                                   for k, v in fa.flash_attention.variant_launches.items()},
            "backward_launches": {k: (v - designs0[k]) // 2
                                  for k, v in fab.flash_attention_bwd.design_launches.items()},
        }
        print(json.dumps({"dryrun_cell": row}), flush=True)
        rows[f"{arch}__{shape.name}"] = row
        if abs(row["gap"]) > DRYRUN_PEAK_TOL:
            raise SystemExit(f"dryrun {arch} {shape.name}: measured peak {measured} B is "
                             f"{row['gap']:+.1%} from the predicted {predicted} B")
        temp_tol = max(DRYRUN_TEMP_TOL * row["predicted_temp_bytes"], DRYRUN_TEMP_SLACK)
        if abs(row["temp_gap_bytes"]) > temp_tol:
            raise SystemExit(f"dryrun {arch} {shape.name}: measured temporaries "
                             f"{row['measured_temp_bytes']} B are {row['temp_gap_bytes']:+} B from "
                             f"the predicted {row['predicted_temp_bytes']} B (allowed {temp_tol:.0f})")
        want = {"flash_attention": sum(k["launches"] for n, k in pred["kernels"].items()
                                       if n == "flash_attention"),
                "flash_attention_bwd": sum(k["launches"] for n, k in pred["kernels"].items()
                                           if n == "flash_attention_bwd")}
        got = {"flash_attention": sum(row["attention_launches"].values()),
               "flash_attention_bwd": sum(row["backward_launches"].values())}
        if got != want:
            raise SystemExit(f"dryrun {arch} {shape.name}: the card launched {got}, "
                             f"the meta trace declared {want}")
        torch.cuda.empty_cache()
    counts = read_counts("dryrun")
    ran = variant_launches["dryrun"]
    if not (ran["tile"] and ran["split"] and counts["flash_attention_bwd"]):
        raise SystemExit(f"the dryrun path's launches are off: {counts}, attention {ran}")
    props = torch.cuda.get_device_properties(0)
    print(json.dumps({"dryrun": {"total_memory": props.total_memory,
                                 "multi_processor_count": props.multi_processor_count,
                                 "s": time.perf_counter() - t_phase}}), flush=True)
    return rows


def check_split_lse(name: str, b: int, sk: int, h: int, hkv: int, hd: int, pos: int,
                    k_start: int, gen, ring: int = 0) -> dict:
    """"split" with the row log-sum-exp at a rank's decode shape (its data
    shard of the batch, its shard of the cache's slots from ``k_start``; with
    ``ring``, its slice of a ring of that many slots under a window of
    ``ring``: the positions ``ring_positions`` gives, UNWRITTEN for a slot not
    written yet): o within ``ATTN_TOL`` and lse within ``LSE_ATOL`` of the
    plain version (-1e30 exactly for rows that see no key); the kernel timed
    (device ms from the profiler, host ms by CUDA events) beside its bound,
    the plain version and ``scaled_dot_product_attention`` over the same keys."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
    qpos = torch.tensor([pos], dtype=torch.int32, device="cuda")
    if ring:
        from repro_torch.models.attention import ring_positions

        kpos = ring_positions(pos, ring, "cuda")[k_start:k_start + sk].contiguous()
    else:
        kpos = torch.arange(k_start, k_start + sk, dtype=torch.int32, device="cuda")
    kw = dict(q_positions=qpos, k_positions=kpos, causal=True, window=ring)
    split = fa.flash_attention.variant_launches["split"]
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if fa.flash_attention.variant_launches["split"] != split + 1:
        raise SystemExit(f"{name}: the lse call did not take the split kernel")
    vis = fa.visible(qpos, kpos, True, ring)
    atol, rtol = ATTN_TOL["bfloat16"]
    err = (o.float() - o_ref.float()).abs()
    bad = int((err > atol + rtol * o_ref.float().abs()).sum())
    if vis.any():
        lse_err = float((lse - lse_ref).abs().max())
        bad += int(lse_err > LSE_ATOL)
    else:
        lse_err = 0.0
        bad += int(not bool((lse == fa.NEG_INF).all()))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis, enable_gqa=True)

    def kern():
        return ops.flash_attention_lse(q, k, v, **kw)

    host = min(_time_ms(kern, 20), _time_ms(kern, 20))
    plain = _time_ms(lambda: fa.flash_attention_lse_ref(q, k, v, **kw), 3)
    ms, traces = _device_ms(kern, 20)
    lib_ms, lib_traces = _device_ms(lib, 20)
    bound, by = attention_bound_ms(q, k, vis)
    row = {"case": name, "shape": [b, 1, sk, h, hkv, hd], "causal": True, "window": ring,
           "dtype": "bfloat16", "variant": "split", "with_lse": True, "violations": bad,
           "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err,
           "sees_keys": bool(vis.any()), "ms": ms, "host_ms": host, "previous_ms": None,
           "library_ms": lib_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
           "traces": traces + lib_traces}
    print(json.dumps({"flash_attention_check": row}), flush=True)
    if bad:
        raise SystemExit(f"split with lse disagrees with its plain version in case {name}")
    return row


def _shard_err(full, shards, specs, rules, mesh) -> tuple[float, float, float]:
    """(the sum of squares of ``shards`` less rank 0's whole ``full`` leaves,
    the sum of squares of those leaves, the largest absolute difference), over
    the world with each element counted once: rank 0 broadcasts each leaf and
    every rank compares its shard of it."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.sharding import logical_to_spec, shard_params

    sums = torch.zeros(2, device=mesh.device)
    worst = torch.zeros((), device=mesh.device)
    for name, mine in shards.items():
        sp = specs[name]
        t = full[name].float().contiguous() if full is not None else torch.empty(
            sp.shape, dtype=torch.float32, device=mesh.device)
        D.broadcast(t, mesh.world, 0)
        ref = shard_params({name: t}, specs, rules, mesh, mesh.coords)[name]
        d = mine.float() - ref
        worst = torch.maximum(worst, d.abs().max())
        used = {a for e in logical_to_spec(sp.axes, sp.shape, rules, mesh) if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if all(mesh.coords[a] == 0 for a in mesh.shape if a not in used):  # its one holder
            sums += torch.stack([d.square().sum(), ref.square().sum()])
        del t, ref, d
    sums = D.all_reduce(sums, mesh.world)
    return float(sums[0]), float(sums[1]), float(D.all_reduce(worst, mesh.world, "max"))


@contextlib.contextmanager
def _swapped_slots(ctx):
    """A planted fault: ``ctx.cache_part`` cuts each model rank's slots of the
    prefill's cache at the other model rank's coordinate."""
    coords, part = ctx.mesh.coords, ctx.cache_part

    def swapped(t, spec):
        mine = coords["model"]
        coords["model"] = ctx.mesh.shape["model"] - 1 - mine
        try:
            return part(t, spec)
        finally:
            coords["model"] = mine

    ctx.cache_part = swapped
    try:
        yield
    finally:
        del ctx.cache_part


def _combine_ignoring_lse(o, lse, axis):
    """A planted fault: the ranks' partial attentions averaged, their lse ignored."""
    from repro_torch import distributed as D

    return (D.all_reduce(o.float(), axis) / axis.size).to(o.dtype)


def _scatter_unsummed(x, axis, dim: int = 0):
    """A planted fault: the FSDP gathers' backward keeps this rank's slice of
    its own gradient, the data replicas' gradients not summed."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n).contiguous()


def _fan_in(params: dict, specs: dict) -> dict:
    """``params`` with every "scaled" weight rescaled, in place, to a standard
    deviation of 1/sqrt(the dims its product contracts).  The JAX package's
    rule divides by sqrt(shape[-2]), the head count for wq/wk/wv (ROADMAP
    Queue 3 item 5): at granite-8b's widths that makes attention one-hot and
    activations ~100 at init, so that a bf16 rounding anywhere flips some
    row's winner and two bf16 runs differ by chaos, not by their products."""
    import math

    from repro_torch.sharding import CONTRACTED

    for name, t in params.items():
        sp, leaf = specs[name], name.rsplit(".", 1)[-1]
        if sp.init != "scaled" or leaf not in CONTRACTED:
            continue
        lead = 1 if sp.axes[:1] == ("layers",) else 0
        fan_in = math.prod(sp.shape[lead + i] for i in CONTRACTED[leaf])
        t.mul_(math.sqrt(sp.shape[-2] / fan_in))
    return params


def _mesh_rank(mesh, seed: int, layers: int) -> dict:
    """One rank of the mesh phase (``mesh_phase``) at granite-8b's ``layers``
    layers: its main path counted, then the comparisons (rank 0 runs the
    one-process references) and the planted faults; then every other family
    (``_mesh_family``) and the sharded checkpoint (``_mesh_checkpoint``)."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.launch.dryrun import collectives
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import (DECODE_RULES, SERVE_RULES, TRAIN_RULES, MeshCtx,
                                      init_params, shards_from_root)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

    dev = mesh.device
    if dev.type != "cuda":
        raise SystemExit(f"rank {mesh.rank} is on {dev}, not the card")
    root = mesh.rank == 0
    cfg = _mesh_cfg(layers)
    model = build(cfg)
    specs = model.param_specs()
    out: dict = {"rank": mesh.rank, "coords": dict(mesh.coords), "device": str(dev)}

    def sync_all():
        torch.cuda.synchronize()
        torch.distributed.barrier()

    segments: dict[str, dict] = {}  # the counted blocks' launches, by block
    _zero_counts()
    D.reset_moved()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    # 1. rank 0 makes the seeded weights on the card and hands every rank its shards (the
    # Shelby round trip of phase 19 is the sharded train state's checkpoint, below)
    full = None
    if root:
        full = _fan_in(init_params(specs, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev), specs)
        out["weight_bytes"] = sum(t.numel() * t.element_size() for t in full.values())
    t = time.perf_counter()
    dshards, tshards, sshards = shards_from_root(full, specs,
                                                 [DECODE_RULES, TRAIN_RULES, SERVE_RULES], mesh)
    sync_all()
    out["hand_out_s"] = time.perf_counter() - t
    live = {}  # the collectives of one prefill, decode and train step, for the dry-run's trace

    def moved():
        return dict(D.moved), dict(D.calls)

    # 2. serving: the batch over data, the cache's slots over model
    dctx = MeshCtx(DECODE_RULES, mesh, cfg)
    engine = ServeEngine(cfg, dshards, ctx=dctx, max_len=MESH_SLOTS)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)
    gen_s = []
    for _ in range(MESH_GENERATIONS):
        t = time.perf_counter()
        tokens = engine.generate(prompts, num_tokens=MESH_GEN)
        gen_s.append(time.perf_counter() - t)
    out["generation_s"], out["tokens"] = gen_s, tokens
    del engine
    # one decode step over a MESH_SLOTS-slot cache, its collectives counted
    cache = {n: torch.zeros(dctx.local_shape(sp), dtype=sp.dtype, device=dev)
             for n, sp in model.cache_specs(MESH_BATCH, MESH_SLOTS).items()}
    before = moved()
    make_decode_step(cfg, dctx.for_cache(MESH_SLOTS))(
        dshards, cache, torch.as_tensor(prompts[:, :1], device=dev).long(), MESH_SLOTS - 1)
    live["decode"] = collectives(before)
    del cache
    # 2b. prefill under SERVE_RULES: the rows over data, the cache written into each rank's
    # shard (its 2,048 slots, every kv head); the last position's logits whole
    sctx = MeshCtx(SERVE_RULES, mesh, cfg)
    ptoks = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_PREFILL_SEQ), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed + 4))
    prefill = make_prefill_step(cfg, sctx)
    peak = torch.cuda.max_memory_allocated()
    sync_all()
    torch.cuda.reset_peak_memory_stats()
    before = moved()
    t = time.perf_counter()
    plogits, pcache = prefill(sshards, {"tokens": ptoks})
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t
    live["prefill"] = collectives(before)
    out["prefill_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["prefill_cache_shapes"] = {n: list(c.shape) for n, c in pcache.items()}
    # 3. training steps with shard_grad_accum
    tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, tctx, num_microbatches=MESH_MICROBATCHES, shard_grad_accum=True)
    state = opt.init_state(tshards)
    losses, step_s = [], []
    for i in range(MESH_TRAIN_STEPS):
        t = time.perf_counter()
        before = moved()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t)
        if i == 0:
            live["train"] = collectives(before)
    out["losses"], out["step_s"] = losses, step_s
    out["grad_norm"] = float(metrics["grad_norm"])
    del state
    # 4. the expert-parallel MoE: qwen3-moe's widths, one layer, a 1 x MESH_MOE_SEQ batch
    # whose tokens split over data as the JAX package's shard_map splits them
    mcfg = dataclasses.replace(get(MESH_MOE_ARCH), num_layers=1)
    mctx = MeshCtx(TRAIN_RULES, mesh, mcfg)
    mspecs = {f"blocks.moe.{k}": sp for k, sp in moe_mod.moe_specs(mcfg, 1).items()}
    mfull = init_params(mspecs, torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
    mshards = mctx.shard(mfull, mspecs)
    if not root:
        del mfull
    x = torch.randn((2, MESH_MOE_SEQ // 2, mcfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 3)).bfloat16()
    t = time.perf_counter()
    with torch.no_grad():
        lp = {k.rsplit(".", 1)[-1]: mctx.gather(k, v[0]) for k, v in mshards.items()}
        y, aux = moe_mod.apply_moe(lp, mctx.local_batch(x), mcfg, mctx)
        y = mctx.whole_batch(y)
    torch.cuda.synchronize()
    out["moe_s"] = time.perf_counter() - t
    del lp, mshards
    sync_all()
    out["path_s"] = time.perf_counter() - t_path
    segments["granite"] = _read_counts()
    out["moved_bytes"], out["collective_calls"] = dict(D.moved), dict(D.calls)
    out["max_memory_allocated"] = max(peak, torch.cuda.max_memory_allocated())
    out["live_collectives"] = live

    # 5. against one process on the card (rank 0), uncounted.  Every rank first finishes
    # its mesh work and frees the card, so that rank 0's one-process references fit.
    with torch.no_grad():  # the MoE: each data shard's tokens through every expert at once
        if root:
            full_lp = {k.rsplit(".", 1)[-1]: v[0] for k, v in mfull.items()}
            parts = [moe_mod.apply_moe(full_lp, x[i:i + 1], mcfg) for i in range(2)]
            want = torch.cat([p[0] for p in parts])
            out["moe_max_abs_err"] = float((y.float() - want.float()).abs().max())
            out["moe_aux_err"] = abs(float(aux) - float(sum(p[1] for p in parts) / 2))
            out["moe_max_abs"] = float(want.float().abs().max())
            del full_lp, parts, want, mfull
    del x, y
    # the mesh: decode teacher-forced over the generated tokens through a cache of
    # MESH_TF_SLOTS slots (both model ranks' shards hold keys), and the gradient; then each
    # again with a planted fault, which the comparisons must reject
    steps = MESH_PROMPT + MESH_GEN - 1
    cache_specs = model.cache_specs(MESH_BATCH, MESH_TF_SLOTS)
    fed = torch.as_tensor(tokens[:, :steps], device=dev).long()

    def mesh_decode():
        cache = {n: torch.zeros(dctx.local_shape(sp), dtype=sp.dtype, device=dev)
                 for n, sp in cache_specs.items()}
        return _mesh_teacher_forced(model, dshards, cache, fed, range(steps),
                                    dctx.for_cache(MESH_TF_SLOTS))

    mesh_logits, cache = mesh_decode()
    combine, attention.combine_partials = attention.combine_partials, _combine_ignoring_lse
    try:
        fault_logits, fault_cache = mesh_decode()
    finally:
        attention.combine_partials = combine
    del dshards
    # the prefill again with a planted fault: each model rank keeps the other's slots
    with _swapped_slots(sctx):
        fault_plogits, fault_pcache = prefill(sshards, {"tokens": ptoks})
    del sshards
    gtoks = torch.randint(0, cfg.vocab, (MESH_GRAD_BATCH, MESH_GRAD_SEQ + 1), generator=gen,
                          device=dev)
    gbatch = {"tokens": gtoks[:, :-1], "labels": gtoks[:, 1:]}

    loss_mesh, g_mesh = _mesh_grads(model, tshards, tctx, gbatch)
    scatter, D.reduce_scatter = D.reduce_scatter, _scatter_unsummed
    try:
        _, g_fault = _mesh_grads(model, tshards, tctx, gbatch)
    finally:
        D.reduce_scatter = scatter
    del tshards
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    ref_cache = ref = ref_pcache = None
    if root:  # the one process: decode, the train steps, the gradient
        ref_cache = {n: torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
                     for n, sp in cache_specs.items()}
        one_logits, ref_cache = _mesh_teacher_forced(model, full, ref_cache, fed, range(steps))
        out["logit_max_abs_err"] = max(float((m - o).abs().max())
                                       for m, o in zip(mesh_logits, one_logits))
        out["fault_logit_max_abs_err"] = max(float((m - o).abs().max())
                                             for m, o in zip(fault_logits, one_logits))
        out["logit_max_abs"] = max(float(o.abs().max()) for o in one_logits)
        agree = sum(int((o.argmax(-1).cpu().numpy() == tokens[:, pos + 1]).sum())
                    for pos, o in enumerate(one_logits) if pos >= MESH_PROMPT - 1)
        out["greedy_agree"] = f"{agree} of {MESH_BATCH * MESH_GEN}"  # the engine's tokens
        # the one process's own bf16 error: its logits (reported) and caches against f32
        # compute and caches (the forward kernels take f32)
        cache32 = {n: torch.zeros(sp.shape, device=dev) for n, sp in cache_specs.items()}
        L.COMPUTE_DTYPE = torch.float32
        try:
            f32_logits, cache32 = _mesh_teacher_forced(model, full, cache32, fed, range(steps))
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        out["logit_bf16_vs_f32_err"] = max(float((a - b).abs().max())
                                           for a, b in zip(one_logits, f32_logits))
        own = [(float((ref_cache[n].float() - c).square().sum()), float(c.square().sum()))
               for n, c in cache32.items()]
        out["cache_bf16_vs_f32_rel"] = (sum(a for a, _ in own) / sum(b for _, b in own)) ** 0.5
        del cache32, one_logits, f32_logits, mesh_logits, fault_logits
        step1 = make_train_step(cfg, num_microbatches=MESH_MICROBATCHES)
        state = opt.init_state(full)
        ref_losses = []
        for _ in range(MESH_TRAIN_STEPS):
            state, metrics = step1(state, batch)
            ref_losses.append(float(metrics["loss"]))
        out["losses_ref"] = ref_losses
        del state, metrics
        torch.cuda.empty_cache()
        # bf16 on the card, and f32 compute on the CPU plain path (the backward kernel takes
        # bf16 only): the one process's own bf16 error
        loss_ref, ref = _mesh_grads(model, full, None, gbatch)
        L.COMPUTE_DTYPE = torch.float32
        try:
            loss_f32, ref32 = _mesh_grads(model, {k: v.cpu() for k, v in full.items()}, None,
                                          {k: v.cpu() for k, v in gbatch.items()})
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        noise = sum(float((ref[k].float().cpu() - ref32[k]).square().sum()) for k in ref)
        norm = sum(float(ref32[k].square().sum()) for k in ref32)
        out.update(grad_loss=loss_mesh, grad_loss_ref=loss_ref, grad_loss_f32=loss_f32,
                   grad_rel_err_card_bf16_vs_cpu_f32=noise ** 0.5 / norm ** 0.5)
        del ref32
        # the prefill in one process, in bf16 and (its own error) in f32 compute
        one_prefill = make_prefill_step(cfg)
        one_plogits, ref_pcache = one_prefill(full, {"tokens": ptoks})
        L.COMPUTE_DTYPE = torch.float32
        try:
            _, pcache32 = one_prefill(full, {"tokens": ptoks})
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        vocab = cfg.vocab
        for key, lg in (("prefill_logit_max_abs_err", plogits),
                        ("fault_prefill_logit_max_abs_err", fault_plogits)):
            out[key] = float((lg.float() - one_plogits.float())[..., :vocab].abs().max())
        own = [(float((ref_pcache[n].float() - c).square().sum()), float(c.square().sum()))
               for n, c in pcache32.items()]
        out["prefill_cache_bf16_vs_f32_rel"] = (sum(a for a, _ in own)
                                                / sum(b for _, b in own)) ** 0.5
        del one_plogits, pcache32
    for key, mine in (("cache", cache), ("fault_cache", fault_cache)):
        dist, size, worst = _shard_err(ref_cache, mine, cache_specs, DECODE_RULES, mesh)
        out[f"{key}_rel_dist"], out[f"{key}_max_abs_err"] = (dist / size) ** 0.5, worst
    del cache, fault_cache, ref_cache
    pspecs = model.cache_specs(MESH_BATCH, MESH_PREFILL_SEQ)
    for key, mine in (("prefill_cache", pcache), ("fault_prefill_cache", fault_pcache)):
        dist, size, worst = _shard_err(ref_pcache, mine, pspecs, SERVE_RULES, mesh)
        out[f"{key}_rel_dist"], out[f"{key}_max_abs_err"] = (dist / size) ** 0.5, worst
    del pcache, fault_pcache, plogits, fault_plogits, ref_pcache
    for key, mine in (("grad", g_mesh), ("fault_grad", g_fault)):
        dist, _, _ = _shard_err(ref, mine, specs, TRAIN_RULES, mesh)
        if root:
            out[f"{key}_rel_dist_mesh_vs_one"] = dist ** 0.5 / norm ** 0.5
    del full, ref
    torch.cuda.empty_cache()
    sync_all()
    # 6. every other family on the same world, then a sharded train state's checkpoint
    for i, (key, cfg_f, train, long_mode) in enumerate(_mesh_families()):
        out[key] = _mesh_family(mesh, cfg_f, seed + 10 + i, segments, train=train,
                                long_mode=long_mode)
        torch.cuda.empty_cache()
        sync_all()
    out["checkpoint"] = _mesh_checkpoint(mesh, seed, segments)
    out["segments"] = segments
    out.update(_sum_counts(segments.values()))
    sync_all()
    return out


def _zero_counts() -> None:
    """Every kernel wrapper's launch counts (and attention's by variant, the
    backward's by design) set to 0, in this process."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.kernels import sample_hash as sh

    gk.gf_matmul.launches = sh.sample_hash.launches = 0
    fa.reset_launches()
    fab.reset_launches()


def _read_counts() -> dict:
    """This process's launch counts since :func:`_zero_counts`: by kernel,
    attention's by variant and its "tile" launches by design, the backward's
    by design."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.kernels import sample_hash as sh

    return {"launches": {"gf_matmul": gk.gf_matmul.launches,
                         "flash_attention": fa.flash_attention.launches,
                         "flash_attention_bwd": fab.flash_attention_bwd.launches,
                         "sample_hash": sh.sample_hash.launches},
            "variants": dict(fa.flash_attention.variant_launches),
            "tile_designs": dict(fa.flash_attention.design_launches),
            "designs": dict(fab.flash_attention_bwd.design_launches)}


def _sum_counts(counts) -> dict:
    """The sum of :func:`_read_counts` results, key by key."""
    counts = list(counts)
    return {part: {k: sum(c[part][k] for c in counts) for k in counts[0][part]}
            for part in ("launches", "variants", "tile_designs", "designs")}


@contextlib.contextmanager
def _counted(segments: dict, name: str):
    """A block of the mesh's main path: counts zeroed before, read after into
    ``segments[name]`` (the comparisons between blocks are not counted)."""
    _zero_counts()
    yield
    segments[name] = _read_counts()


def _mesh_families() -> list:
    """(key, config, (train rows, seq), long mode) of each family phase 19 runs
    besides granite-8b and the MoE layer: hymba-1.5b at its published widths
    cut to MESH_HYMBA_LAYERS (long mode too), whisper-tiny whole, and
    MESH_SMOKE_ARCHS at smoke widths (deepseek with capacity factor 64, so
    that the mesh and one process keep the same tokens)."""
    from repro_torch.configs import get, get_smoke

    out = [("hymba", dataclasses.replace(get("hymba-1.5b"), num_layers=MESH_HYMBA_LAYERS),
            MESH_HYMBA_TRAIN, True),
           ("whisper", get("whisper-tiny"), MESH_WHISPER_TRAIN, False)]
    for arch in MESH_SMOKE_ARCHS:
        cfg = get_smoke(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
        out.append((cfg.name, cfg, MESH_SMOKE_TRAIN, False))
    return out


def _mesh_grads(model, params, ctx, batch):
    """(loss, gradients) of ``model`` at ``params`` (a rank's shards with a
    ``MeshCtx``, the whole leaves without), as the train step takes them."""
    import torch

    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = model.loss(leaves, batch, ctx)
    g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                             materialize_grads=True)))
    return float(loss.detach()), (g if ctx is None else ctx.reduce_grads(g))


def _mesh_teacher_forced(model, params, cache, toks, positions, ctx=None, long_mode=False):
    """``toks`` (B, len(positions)) decoded teacher-forced at ``positions``:
    the logits of each (f32, the vocab's ids; None off rank 0 of a mesh) and
    the cache, updated in place."""
    import torch

    root = ctx is None or ctx.mesh.rank == 0
    vocab = model.cfg.vocab
    logits = []
    with torch.no_grad():
        for i, pos in enumerate(positions):
            lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], pos, ctx,
                                          long_mode=long_mode)
            logits.append(lg.float()[:, 0, :vocab] if root else None)
    return logits, cache


def _mesh_family(mesh, cfg, seed: int, segments: dict, *, train, long_mode: bool) -> dict:
    """One family of phase 19 on the mesh.  Counted (``segments[cfg.name]``):
    rank 0 makes fan-in scaled weights on the card and hands every rank its
    shards under DECODE_RULES and TRAIN_RULES (LONG_RULES shards weights as
    DECODE_RULES); ``ServeEngine`` generates MESH_BATCH x (MESH_PROMPT +
    MESH_GEN) tokens (an encoder-decoder over seeded frames, each rank
    encoding its rows); in ``long_mode`` the model is teacher-forced at
    MESH_LONG_POSITIONS under LONG_RULES (batch 1) from a seeded whole ring
    that rank 0 hands out, so that the ring wraps without 2,000 decode
    steps; one train step at ``train`` (rows, seq).  Then, uncounted, against
    one process on the card (rank 0): decode teacher-forced through
    MESH_TF_SLOTS slots from position 0, the long-mode logits and ring, and
    the gradient at MESH_GRAD_BATCH x MESH_GRAD_SEQ, each beside the one
    process's own bf16 error (f32 compute on the card; the gradient's on the
    CPU plain path); for a Mamba family the decode again with ``in_proj``
    split contiguously over model (a planted fault the gates must reject).
    Returns the ranks' agreement and, on rank 0, the gate values."""
    import torch

    from repro_torch import sharding as S
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import (DECODE_RULES, LONG_RULES, TRAIN_RULES, MeshCtx,
                                      cache_slots, init_params, shards_from_root)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    dev, root = mesh.device, mesh.rank == 0
    model = build(cfg)
    specs = model.param_specs()
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)
    frames = (torch.randn((MESH_BATCH, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
              if cfg.is_encdec else None)

    def batch_of(rows, seq):
        b = model_batch(cfg, torch.randint(0, cfg.vocab, (rows, seq + 1), generator=gen,
                                           device=dev), dev)
        if frames is not None:
            b["frames"] = frames[:rows]
        return b

    tbatch = batch_of(*train)
    out: dict = {"arch": cfg.name, "layers": cfg.num_layers, "routed": cfg.moe is not None}
    long_specs = model.cache_specs(1, cfg.long_window, long_mode=True) if long_mode else {}
    ring = None
    if long_mode and root:  # a ring of long_window slots written at every position below
        rgen = torch.Generator(device=dev).manual_seed(seed + 1)  # gen draws alike on every rank
        ring = {n: (torch.randn(sp.shape, generator=rgen, device=dev) * 0.5).to(sp.dtype)
                for n, sp in long_specs.items()}
    long_toks = torch.randint(0, cfg.vocab, (1, len(MESH_LONG_POSITIONS)), generator=gen,
                              device=dev)
    with _counted(segments, cfg.name):
        t = time.perf_counter()
        full = None
        if root:
            full = _fan_in(init_params(specs, torch.Generator(device=dev).manual_seed(seed),
                                       device=dev), specs)
        dshards, tshards = shards_from_root(full, specs, [DECODE_RULES, TRAIN_RULES], mesh)
        out["hand_out_s"] = time.perf_counter() - t
        dctx = MeshCtx(DECODE_RULES, mesh, cfg)
        engine = ServeEngine(cfg, dshards, ctx=dctx, max_len=MESH_SLOTS)
        t = time.perf_counter()
        out["tokens"] = engine.generate(prompts, MESH_GEN, frames=frames)
        out["generation_s"] = time.perf_counter() - t
        del engine
        if long_mode:
            lctx = MeshCtx(LONG_RULES, mesh, cfg).for_cache(cache_slots(long_specs))
            t = time.perf_counter()
            lcache = shards_from_root(ring, long_specs, [LONG_RULES], mesh)[0]
            long_logits, lcache = _mesh_teacher_forced(model, dshards, lcache, long_toks,
                                                       MESH_LONG_POSITIONS, lctx, True)
            torch.cuda.synchronize()
            out["long_s"] = time.perf_counter() - t
        tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        step = make_train_step(cfg, tctx)
        t = time.perf_counter()
        state, metrics = step(opt.init_state(tshards), tbatch)
        out["loss"] = float(metrics["loss"])  # waits for the step
        out["step_s"] = time.perf_counter() - t
        del state, metrics
    # uncounted: the mesh against one process on the card
    steps = MESH_PROMPT + MESH_GEN - 1
    toks = torch.randint(0, cfg.vocab, (MESH_BATCH, steps), generator=gen, device=dev)
    cache_specs = model.cache_specs(MESH_BATCH, MESH_TF_SLOTS)

    def mesh_decode(ctx):
        cache = {n: torch.zeros(ctx.local_shape(sp), dtype=sp.dtype, device=dev)
                 for n, sp in cache_specs.items()}
        if frames is not None:
            with torch.no_grad():
                cache["enc_out"] = model.encode(dshards, ctx.local_batch(frames), ctx).to(
                    cache["enc_out"].dtype)
        return _mesh_teacher_forced(model, dshards, cache, toks, range(steps), ctx)

    mesh_logits, cache = mesh_decode(dctx.for_cache(MESH_TF_SLOTS))
    fault_logits = fault_cache = None
    if cfg.ssm is not None:  # in_proj's [x | z] cut contiguously: rank 0 all of x, 1 all of z
        fused = dict(S.FUSED)
        S.FUSED.clear()
        try:
            fault_logits, fault_cache = mesh_decode(
                MeshCtx(DECODE_RULES, mesh, cfg).for_cache(MESH_TF_SLOTS))
        finally:
            S.FUSED.update(fused)
    gbatch = batch_of(MESH_GRAD_BATCH, MESH_GRAD_SEQ)
    loss_mesh, g_mesh = _mesh_grads(model, tshards, tctx, gbatch)
    del dshards, tshards
    torch.cuda.empty_cache()
    refs = {}
    if root:  # the one process: bf16, and its own error against f32 compute
        for dtype in (torch.bfloat16, torch.float32):
            L.COMPUTE_DTYPE = dtype
            try:
                one = {n: torch.zeros(sp.shape, device=dev, dtype=sp.dtype
                                      if dtype == torch.bfloat16 else torch.float32)
                       for n, sp in cache_specs.items()}
                if frames is not None:
                    with torch.no_grad():
                        one["enc_out"] = model.encode(full, frames).to(one["enc_out"].dtype)
                refs[dtype] = _mesh_teacher_forced(model, full, one, toks, range(steps))
                if long_mode:
                    lone = {n: t.clone() if dtype == torch.bfloat16 else t.float()
                            for n, t in ring.items()}
                    refs[dtype, "long"] = _mesh_teacher_forced(model, full, lone, long_toks,
                                                               MESH_LONG_POSITIONS, None, True)
            finally:
                L.COMPUTE_DTYPE = torch.bfloat16

        def err(a, b):
            return max(float((x - y).abs().max()) for x, y in zip(a, b))

        def rel(a, b):
            num = sum(float((a[n].float() - b[n].float()).square().sum()) for n in b)
            return (num / sum(float(b[n].float().square().sum()) for n in b)) ** 0.5

        (one_logits, one_cache), (f32_logits, f32_cache) = refs[torch.bfloat16], refs[
            torch.float32]
        out.update(logit_max_abs_err=err(mesh_logits, one_logits),
                   logit_bf16_vs_f32_err=err(one_logits, f32_logits),
                   logit_max_abs=max(float(x.abs().max()) for x in one_logits),
                   cache_bf16_vs_f32_rel=rel(one_cache, f32_cache))
        if fault_logits is not None:
            out["fault_logit_max_abs_err"] = err(fault_logits, one_logits)
        if long_mode:
            (lone_logits, lone_cache), (l32_logits, l32_cache) = refs[
                torch.bfloat16, "long"], refs[torch.float32, "long"]
            out.update(long_logit_max_abs_err=err(long_logits, lone_logits),
                       long_logit_bf16_vs_f32_err=err(lone_logits, l32_logits),
                       long_cache_bf16_vs_f32_rel=rel(lone_cache, l32_cache))
        loss_ref, g_ref = _mesh_grads(model, full, None, gbatch)
        L.COMPUTE_DTYPE = torch.float32
        try:
            loss_f32, g_f32 = _mesh_grads(model, {k: v.cpu() for k, v in full.items()}, None,
                                          {k: v.cpu() for k, v in gbatch.items()})
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        noise = sum(float((g_ref[k].float().cpu() - g_f32[k]).square().sum()) for k in g_ref)
        norm = sum(float(g_f32[k].square().sum()) for k in g_f32)
        out.update(grad_loss=[loss_mesh, loss_ref, loss_f32],
                   grad_rel_err_card_bf16_vs_cpu_f32=(noise / norm) ** 0.5)
        del g_f32
    else:
        one_cache = g_ref = None
        lone_cache = None
    for key, mine in (("cache", cache), ("fault_cache", fault_cache)):
        if mine is not None:
            dist, size, worst = _shard_err(one_cache, mine, cache_specs, DECODE_RULES, mesh)
            out[f"{key}_rel_dist"] = (dist / size) ** 0.5
    if long_mode:
        dist, size, _ = _shard_err(lone_cache, lcache, long_specs, LONG_RULES, mesh)
        out["long_cache_rel_dist"] = (dist / size) ** 0.5
    dist, _, _ = _shard_err(g_ref, g_mesh, specs, TRAIN_RULES, mesh)
    if root:
        out["grad_rel_dist_mesh_vs_one"] = (dist / norm) ** 0.5
    del full, refs, g_ref, g_mesh, cache, fault_cache
    return out


def _mesh_checkpoint(mesh, seed: int, segments: dict) -> dict:
    """A hymba-smoke train state sharded over the mesh, checkpointed through
    rank 0's Shelby cluster (``Trainer`` with a ``MeshCtx``; counted as
    ``segments["checkpoint"]``): a step and a save, an SP that loses every
    chunk, a step, a save and the repair, the restore into the mesh.  Then,
    uncounted: the restore equal to the state, bit for bit, on every rank and
    in one process on rank 0, and the checkpoint bytes equal to
    ``serialize_pytree`` of the whole state."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get_smoke
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.sharding import TRAIN_RULES, MeshCtx, flatten, root_from_shards
    from repro_torch.storage.checkpoint import CheckpointManager, serialize_pytree
    from repro_torch.storage.repair import RepairCoordinator
    from repro_torch.train.loop import Trainer

    dev, root = mesh.device, mesh.rank == 0
    cfg = get_smoke("hymba-1.5b")
    rng = np.random.default_rng(seed)

    def batches():
        while True:
            toks = rng.integers(0, cfg.vocab, (MESH_BATCH, MESH_GRAD_SEQ + 1))
            yield toks[:, :-1], toks[:, 1:]

    out = {}
    with _counted(segments, "checkpoint"):
        mgr = repair = sps = client = None
        if root:
            contract, sps, rpc, client = build_cluster(num_sps=8, device=dev)
            mgr = CheckpointManager(client, num_host_shards=2)
            repair = RepairCoordinator(contract, sps, rpc.layout)
        ctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        trainer = Trainer(cfg, ctx=ctx, ckpt=mgr, repair=repair, ckpt_every=1)
        feed = batches()
        t = time.perf_counter()
        state, rep1 = trainer.run(trainer.init_state(seed), feed, 1)
        if root:  # an SP loses every chunk it stored
            victim = next(iter(sps))
            sps[victim].crash()
            sps[victim].recover()
            sps[victim].wipe()
        state, rep2 = trainer.run(state, feed, 1, start_step=1)
        restored, step = trainer.restore_latest(None)
        torch.cuda.synchronize()
        out["s"] = time.perf_counter() - t
    out.update(restored_step=step, restarts=trainer.restarts,
               reports=[(r.ckpt_bytes, r.repairs, r.losses) for r in (rep1, rep2)])
    same = all(torch.equal(restored[k][n], state[k][n]) for k in ("params", "m", "v")
               for n in state[k]) and int(restored["step"]) == int(state["step"])
    flags = D.all_reduce(torch.tensor([int(same)], device=dev), mesh.world)
    out["mesh_equal"] = int(flags[0]) == mesh.size
    whole = {k: root_from_shards(state[k], trainer.specs, TRAIN_RULES, mesh)
             for k in ("params", "m", "v")}
    if root:
        whole["step"] = state["step"].cpu()
        one = Trainer(cfg, ckpt=mgr, device=dev)
        got, one_step = one.restore_latest(one.init_state())
        out["one_equal"] = one_step == step and all(
            torch.equal(a.cpu(), b) for a, b in zip(flatten(got).values(), flatten(whole).values()))
        data = b"".join(r.data for r in client.get_many(
            [(b, 0, None) for b in mgr.records[step].shard_blob_ids]))
        out["bytes_equal"] = data[:mgr.records[step].total_bytes] == serialize_pytree(whole)
        out["repair_clean"] = not repair.failures and not repair.scan_lost_chunks()
    return out


def _mesh_failures(r: dict, prefix: str = "") -> list[str]:
    """The gates of the mesh against one process that the rank-0 results ``r``
    fail (``prefix`` "fault_": those of the run with a planted fault): decode
    logits within SERVE_LOGIT_ATOL; the caches' relative L2 distance within
    MESH_CACHE_NOISE_FACTOR times the one process's own bf16 error, the
    gradient's within TRAIN_NOISE_FACTOR times its own plus TRAIN_GRAD_FLOOR;
    the prefill's logits within SERVE_LOGIT_ATOL and its cache within
    MESH_CACHE_NOISE_FACTOR times its own plus MESH_PREFILL_CACHE_FLOOR."""
    failed = []
    if not r[f"{prefix}prefill_logit_max_abs_err"] <= SERVE_LOGIT_ATOL:
        failed.append("prefill logits")
    if not r[f"{prefix}prefill_cache_rel_dist"] <= (
            MESH_CACHE_NOISE_FACTOR * r["prefill_cache_bf16_vs_f32_rel"]
            + MESH_PREFILL_CACHE_FLOOR):
        failed.append("prefill cache")
    if not r[f"{prefix}logit_max_abs_err"] <= SERVE_LOGIT_ATOL:
        failed.append("logits")
    if not r[f"{prefix}cache_rel_dist"] <= MESH_CACHE_NOISE_FACTOR * r["cache_bf16_vs_f32_rel"]:
        failed.append("caches")
    if not r[f"{prefix}grad_rel_dist_mesh_vs_one"] <= (
            TRAIN_NOISE_FACTOR * r["grad_rel_err_card_bf16_vs_cpu_f32"] + TRAIN_GRAD_FLOOR):
        failed.append("gradient")
    return failed


def _partial_products(gen) -> dict:
    """The mesh's products taken as f32 partial sums (``MeshCtx.linear`` for a
    product planned with "g": the activation and the weight's shard cast to
    f32 on every call) against the same product in bf16, device ms, at a
    rank's shapes: under DECODE_RULES wq (its embed input cut to 2,048) and up
    over the decode's 2 rows; under TRAIN_RULES wo (16 heads a rank) and down
    (7,168 of d_ff a rank) over a microbatch of 1 x 4096."""
    import torch

    cfg = _mesh_cfg(MESH_LAYERS)
    d, hd, f = cfg.d_model, cfg.d_model // cfg.num_heads, cfg.d_ff
    h, rows = cfg.num_heads // MESH_MODEL, MESH_BATCH // MESH_DATA
    dm, fm = d // MESH_MODEL, f // MESH_MODEL
    cases = {
        "decode_wq": ("bsd,dhk->bshk", (rows, 1, dm), (dm, cfg.num_heads, hd)),
        "decode_up": ("bsd,df->bsf", (rows, 1, dm), (dm, f)),
        "train_wo": ("bshk,hkd->bsd", (1, MESH_TRAIN_SEQ, h, hd), (h, hd, d)),
        "train_down": ("bsf,fd->bsd", (1, MESH_TRAIN_SEQ, fm), (fm, d)),
    }
    out = {}
    for name, (eq, xs, ws) in cases.items():
        x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
        w = torch.randn(ws, generator=gen, device="cuda").bfloat16()
        f32_ms, _ = _device_ms(lambda: torch.einsum(eq, x.float(), w.float()), 10)
        bf16_ms, _ = _device_ms(lambda: torch.einsum(eq, x, w), 10)
        out[name] = {"f32_partial_ms": f32_ms, "bf16_ms": bf16_ms}
    return out


def _traced_collectives(layers: int) -> dict:
    """The collectives of granite's prefill, decode step and train step at
    phase 19's shapes as the dry-run counts them: ``launch/dryrun.py::
    estimate`` on a MESH_DATA x MESH_MODEL trace mesh (meta tensors, rank 0)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.mesh import make_local_mesh

    cells = {"prefill": (ShapeCell("prefill_32k", MESH_PREFILL_SEQ, MESH_BATCH, "prefill"), None),
             "decode": (ShapeCell("decode_32k", MESH_SLOTS, MESH_BATCH, "decode"), None),
             "train": (ShapeCell("train_4k", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, "train"),
                       MESH_MICROBATCHES)}
    mesh = make_local_mesh(MESH_DATA, MESH_MODEL)
    return {kind: estimate(_mesh_cfg(layers), cell, mesh, microbatch_override=mb)["collectives"]
            for kind, (cell, mb) in cells.items()}


def _mesh_cfg(layers: int):
    from repro_torch.configs import get

    return dataclasses.replace(get(MESH_ARCH), num_layers=layers)


def _family_failures(r: dict, prefix: str = "") -> list[str]:
    """The gates of ``_mesh_failures`` that one family's rank-0 results ``r``
    fail (``prefix`` "fault_": the planted fault's decode), its long mode's
    too, and its gradient's.  A family with routed experts holds its logits
    within SERVE_LOGIT_ATOL plus LOGIT_NOISE_FACTOR times the one process's
    own bf16 error, as phase 17 holds deepseek's prefill: where two experts'
    router probabilities lie within bf16 rounding, any bf16 computation
    (the mesh's partial sums too) may swap them."""
    failed = []
    atol = SERVE_LOGIT_ATOL + (LOGIT_NOISE_FACTOR * r["logit_bf16_vs_f32_err"]
                               if r["routed"] else 0.0)
    if not r[f"{prefix}logit_max_abs_err"] <= atol:
        failed.append("logits")
    if not r[f"{prefix}cache_rel_dist"] <= MESH_CACHE_NOISE_FACTOR * r["cache_bf16_vs_f32_rel"]:
        failed.append("caches")
    if prefix:
        return failed
    if "long_logit_max_abs_err" in r and not (
            r["long_logit_max_abs_err"] <= SERVE_LOGIT_ATOL
            and r["long_cache_rel_dist"] <= MESH_CACHE_NOISE_FACTOR
            * r["long_cache_bf16_vs_f32_rel"]):
        failed.append("long mode")
    if not r["grad_rel_dist_mesh_vs_one"] <= (
            TRAIN_NOISE_FACTOR * r["grad_rel_err_card_bf16_vs_cpu_f32"] + TRAIN_GRAD_FLOOR):
        failed.append("gradient")
    return failed


def mesh_phase(seed: int, layers: int = MESH_LAYERS) -> dict:
    """The mesh (path ``mesh``): a MESH_DATA x MESH_MODEL ("data", "model")
    world of four processes on the one card over Gloo (``launch/mesh.py``).
    granite-8b at its published widths, depth ``layers``, with fan-in scaled
    weights (``_fan_in``) that rank 0 makes on the card and hands every rank
    as its shards (``sharding.shards_from_root``) under DECODE_RULES and
    TRAIN_RULES; each rank runs ``ServeEngine`` with a ``MeshCtx`` (batch
    MESH_BATCH over data, a cache of MESH_SLOTS slots over model: "split" with
    lse and the combine), MESH_GENERATIONS generations and one more decode
    step, a prefill of MESH_BATCH x MESH_PREFILL_SEQ tokens under SERVE_RULES
    (its cache written into each rank's shard: 2,048 slots, every kv head),
    then MESH_TRAIN_STEPS train steps of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ in
    MESH_MICROBATCHES microbatches with ``shard_grad_accum``; rank 0's
    collectives of that decode step, prefill and first train step must equal,
    kind by kind, bytes and calls, what ``launch/dryrun.py::estimate`` traces
    for them on a MESH_DATA x MESH_MODEL trace mesh; qwen3-moe's
    widths at one layer, the expert-parallel MoE (64 experts a rank) over a
    1 x MESH_MOE_SEQ batch.  Then every other family (``_mesh_family``):
    hymba-1.5b at its published widths (MESH_HYMBA_LAYERS layers: served,
    long mode across its ring's wrap, a 2 x 4096 step), whisper-tiny whole
    (served on seeded frames, a step) and MESH_SMOKE_ARCHS at smoke widths;
    and a hymba-smoke train state checkpointed from the mesh through rank
    0's Shelby cluster (``_mesh_checkpoint``: an SP loses its chunks, the
    repair, the restore into the mesh and into one process).  Each rank's
    launches are counted over those blocks and summed for the ``kernels``
    line; each rank's peak memory and the bytes it handed to each kind of
    collective in granite's block are printed.  Then, uncounted, against one
    process on the card (rank 0): the MoE's y and aux, the training losses
    within TRAIN_LOSS_ATOL, and the gates of ``_mesh_failures`` (and
    ``_family_failures``): decode logits teacher-forced through a
    MESH_TF_SLOTS-slot cache (both model ranks' shards hold keys), the caches
    against the one process's own bf16 error (its caches against f32
    compute), and the gradient at MESH_GRAD_BATCH x MESH_GRAD_SEQ against the
    one process's own bf16 error (its gradient against f32 compute on the CPU
    plain path: the backward kernel takes bf16 only), the prefill's logits
    and cache likewise.  The same gates must reject four planted faults run
    on the mesh: the partial attentions combined with their lse ignored, the
    FSDP gradients not summed over the data replicas, the model ranks'
    slots of the prefill's cache swapped, and hymba's fused ``in_proj``
    split contiguously over model.  The f32 partial products are timed against bf16 at a rank's
    shapes.  Four ranks share one card: no number here says anything of
    multi-GPU speed."""
    import torch

    from repro_torch.launch.mesh import launch

    t_phase = time.perf_counter()
    products = _partial_products(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.empty_cache()
    ranks = launch(_mesh_rank, seed, layers, data=MESH_DATA, model=MESH_MODEL, device="cuda",
                   backend="gloo", timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t_phase
    root = ranks[0]
    families = [key for key, *_ in _mesh_families()]
    for r in ranks:
        print(json.dumps({"mesh_rank": {k: v for k, v in r.items()
                                        if k != "tokens" and k not in families}},
                         default=float), flush=True)
    steps = MESH_PROMPT + MESH_GEN - 1
    splits = (MESH_GENERATIONS * steps + 1) * layers  # and the one counted decode step
    tiles = (2 * MESH_MICROBATCHES * MESH_TRAIN_STEPS + 1) * layers  # and the prefill
    wgmma = layers * MESH_MICROBATCHES * MESH_TRAIN_STEPS
    hymba_splits = MESH_HYMBA_LAYERS * (steps + len(MESH_LONG_POSITIONS))
    for r in ranks:
        if r["device"].split(":")[0] != "cuda":
            raise SystemExit(f"mesh rank {r['rank']} ran on {r['device']}")
        granite = r["segments"]["granite"]
        want = {"tile": tiles, "split": splits, "general": 0}
        # every "tile" launch (4,096-token training and prefill, hd 128) on "wgmma"
        if (granite["variants"] != want or granite["designs"].get("wgmma") != wgmma
                or granite["tile_designs"] != {"wgmma": tiles, "mma": 0}):
            raise SystemExit(f"mesh rank {r['rank']} launched {granite['variants']} (tile "
                             f"{granite['tile_designs']}), backward {granite['designs']}; want "
                             f"{want}, every tile on wgmma, and {wgmma} wgmma backward")
        hymba = r["segments"][r["hymba"]["arch"]]
        if (hymba["variants"]["split"] != hymba_splits or not hymba["variants"]["tile"]
                or not hymba["designs"]["wgmma"] or hymba["variants"]["general"]
                or hymba["tile_designs"] != {"wgmma": hymba["variants"]["tile"], "mma": 0}):
            raise SystemExit(f"mesh rank {r['rank']}: hymba launched {hymba}; want "
                             f"{hymba_splits} split, every tile on wgmma")
        for key in families:
            seg = r["segments"][r[key]["arch"]]
            if r[key]["arch"] != "falcon-mamba-smoke" and not (
                    seg["launches"]["flash_attention"] and seg["launches"]["flash_attention_bwd"]):
                raise SystemExit(f"mesh rank {r['rank']}: {key} made no attention launch: {seg}")
            if not np.array_equal(r[key]["tokens"], root[key]["tokens"]) or not np.isfinite(
                    r[key]["loss"]) or r[key]["loss"] != root[key]["loss"]:
                raise SystemExit(f"mesh rank {r['rank']}: {key}'s tokens or loss differ from "
                                 "rank 0's")
        if not np.array_equal(r["tokens"], root["tokens"]):
            raise SystemExit(f"mesh rank {r['rank']} generated other tokens than rank 0")
        if not all(np.isfinite(r["losses"])) or r["losses"] != root["losses"]:
            raise SystemExit(f"mesh rank {r['rank']}'s losses {r['losses']} differ from rank 0's")
        if r["checkpoint"]["reports"] != root["checkpoint"]["reports"] or not (
                r["checkpoint"]["restarts"] == 1 and r["checkpoint"]["mesh_equal"]):
            raise SystemExit(f"mesh rank {r['rank']}: the checkpoint's restore or reports "
                             f"differ: {r['checkpoint']}")
    ck = root["checkpoint"]
    if (root["segments"]["checkpoint"]["launches"]["gf_matmul"] == 0
            or not (ck["one_equal"] and ck["bytes_equal"] and ck["repair_clean"])
            or ck["reports"][1][1] == 0):
        raise SystemExit(f"mesh: the sharded train state's checkpoint is off: {ck}")
    # the path's counts: each rank's, summed (the parent launches nothing in this phase)
    read = _sum_counts([{part: r[part] for part in ("launches", "variants", "tile_designs",
                                                    "designs")} for r in ranks])
    gen_s = root["generation_s"][-1]
    tokens = MESH_BATCH * steps
    train_tokens = MESH_TRAIN_BATCH * MESH_TRAIN_SEQ
    failed, planted = _mesh_failures(root), _mesh_failures(root, "fault_")
    trace = _traced_collectives(layers)
    fam_failed = {key: _family_failures(root[key]) for key in families}
    fam_planted = _family_failures(root["hymba"], "fault_")
    row = {
        "world": f"{MESH_DATA} x {MESH_MODEL} gloo, one card", "layers": layers, "wall_s": wall,
        "weight_bytes": root["weight_bytes"], "hand_out_s": root["hand_out_s"],
        "generation_s": root["generation_s"], "decode_tok/s": tokens / gen_s,
        "step_s": root["step_s"], "tokens/s": train_tokens / root["step_s"][-1],
        "losses": root["losses"], "losses_one_process": root["losses_ref"],
        "moe_s": root["moe_s"], "path_s": root["path_s"],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks],
        "moved_bytes_by_rank": [r["moved_bytes"] for r in ranks],
        "collective_calls_by_rank": [r["collective_calls"] for r in ranks],
        "partial_products": products,
        "prefill": {"shape": [MESH_BATCH, MESH_PREFILL_SEQ],
                    "wall_s": [r["prefill_s"] for r in ranks],
                    "max_memory_allocated_by_rank": [r["prefill_max_memory_allocated"]
                                                     for r in ranks],
                    "collectives_by_rank": [r["live_collectives"]["prefill"] for r in ranks],
                    "cache_shapes": root["prefill_cache_shapes"]},
        "trace_collectives": trace, "live_collectives_rank0": root["live_collectives"],
        "gates": {"logit_atol": SERVE_LOGIT_ATOL,
                  "cache_rel": MESH_CACHE_NOISE_FACTOR * root["cache_bf16_vs_f32_rel"],
                  "grad_rel": TRAIN_NOISE_FACTOR * root["grad_rel_err_card_bf16_vs_cpu_f32"]
                  + TRAIN_GRAD_FLOOR},
        "failed": failed, "planted_faults_rejected_by": planted,
        **{k: root[k] for k in (
            "logit_max_abs_err", "logit_max_abs", "greedy_agree", "logit_bf16_vs_f32_err",
            "cache_rel_dist", "cache_max_abs_err", "cache_bf16_vs_f32_rel",
            "grad_rel_dist_mesh_vs_one",
            "grad_rel_err_card_bf16_vs_cpu_f32", "fault_logit_max_abs_err",
            "fault_cache_rel_dist", "fault_cache_max_abs_err",
            "fault_grad_rel_dist_mesh_vs_one", "moe_max_abs_err", "moe_aux_err",
            "prefill_logit_max_abs_err", "prefill_cache_rel_dist", "prefill_cache_max_abs_err",
            "prefill_cache_bf16_vs_f32_rel", "fault_prefill_cache_rel_dist")},
        "grad_loss": [root["grad_loss"], root["grad_loss_ref"], root["grad_loss_f32"]],
        "families": {key: {k: v for k, v in root[key].items() if k != "tokens"}
                     for key in families},
        "families_failed": fam_failed, "in_proj_contiguous_rejected_by": fam_planted,
        "checkpoint": ck, "launches_by_block": root["segments"],
        "launches": read}
    print(json.dumps({"mesh": row}, default=float), flush=True)
    loss_err = max(abs(a - b) for a, b in zip(root["losses"], root["losses_ref"]))
    if (failed or any(fam_failed.values()) or root["moe_max_abs_err"] > MESH_MOE_ATOL
            or root["moe_aux_err"] > MESH_AUX_ATOL or loss_err > TRAIN_LOSS_ATOL
            or abs(root["grad_loss"] - root["grad_loss_ref"]) > TRAIN_LOSS_ATOL
            or any(abs(root[key]["grad_loss"][0] - root[key]["grad_loss"][1]) > TRAIN_LOSS_ATOL
                   for key in families)):
        raise SystemExit(f"the mesh disagrees with one process on the card ({failed}, "
                         f"{fam_failed}): {row}")
    if (not {"logits", "caches"} & set(planted) or "gradient" not in planted
            or "prefill cache" not in planted or not fam_planted):
        raise SystemExit(f"the mesh's gates passed a planted fault ({planted}, "
                         f"in_proj {fam_planted}): {row}")
    if trace != root["live_collectives"]:
        raise SystemExit(f"the dry-run's trace counts other collectives than rank 0 made: "
                         f"traced {trace}, live {root['live_collectives']}")
    return {"row": row, **read}


@contextlib.contextmanager
def _data_major(mesh):
    """A planted fault: this rank's index on the ``("pod", "data")`` axis taken
    data-major (the group's ranks are pod-major), so that each gather over
    it writes the rank's shard at another rank's place and the rank takes
    another rank's rows of a batch."""
    key = ("pod", "data")
    ax = mesh._axes[key]
    mesh._axes[key] = dataclasses.replace(
        ax, index=mesh.coords["data"] * mesh.shape["pod"] + mesh.coords["pod"])
    try:
        yield
    finally:
        mesh._axes[key] = ax


def _pod_rank(mesh, seed: int, layers: int) -> dict:
    """One rank of the pod world (``pod_phase``): granite-8b at ``layers``
    layers served, prefilled and trained, and qwen3-moe's MoE layer, each
    block counted; then, uncounted, the mesh's decode and gradient for the
    comparisons (the gradient again with the planted fault) and rank 0's
    one-process references."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import collectives
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import (DECODE_RULES, SERVE_RULES, TRAIN_RULES, MeshCtx,
                                      init_params, shards_from_root)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

    dev = mesh.device
    if dev.type != "cuda":
        raise SystemExit(f"rank {mesh.rank} is on {dev}, not the card")
    root = mesh.rank == 0
    cfg = _mesh_cfg(layers)
    model = build(cfg)
    specs = model.param_specs()
    ax = mesh.axis(("pod", "data"))
    out: dict = {"rank": mesh.rank, "coords": dict(mesh.coords), "device": str(dev),
                 "pod_data_axis": [ax.size, ax.index]}
    segments: dict[str, dict] = {}
    live = {}

    def moved():
        return dict(D.moved), dict(D.calls)

    def sync_all():
        torch.cuda.synchronize()
        torch.distributed.barrier()

    D.reset_moved()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    full = None
    if root:
        full = _fan_in(init_params(specs, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev), specs)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)
    ptoks = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_PREFILL_SEQ), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed + 4))
    # 1. rank 0's weights handed out as every rank's shards under the three tables; serving:
    # a generation, one decode step over MESH_SLOTS slots, the prefill
    with _counted(segments, "serve"):
        t = time.perf_counter()
        dshards, sshards, tshards = shards_from_root(full, specs,
                                                     [DECODE_RULES, SERVE_RULES, TRAIN_RULES], mesh)
        out["hand_out_s"] = time.perf_counter() - t
        dctx = MeshCtx(DECODE_RULES, mesh, cfg)
        engine = ServeEngine(cfg, dshards, ctx=dctx, max_len=MESH_SLOTS)
        t = time.perf_counter()
        tokens = engine.generate(prompts, num_tokens=MESH_GEN)
        out["generation_s"] = time.perf_counter() - t
        del engine
        cache = {n: torch.zeros(dctx.local_shape(sp), dtype=sp.dtype, device=dev)
                 for n, sp in model.cache_specs(MESH_BATCH, MESH_SLOTS).items()}
        before = moved()
        make_decode_step(cfg, dctx.for_cache(MESH_SLOTS))(
            dshards, cache, torch.as_tensor(prompts[:, :1], device=dev).long(), MESH_SLOTS - 1)
        live["decode"] = collectives(before)
        del cache
        sctx = MeshCtx(SERVE_RULES, mesh, cfg)
        prefill = make_prefill_step(cfg, sctx)
        before = moved()
        t = time.perf_counter()
        plogits, pcache = prefill(sshards, {"tokens": ptoks})
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t
        live["prefill"] = collectives(before)
    out["tokens"] = tokens
    # the mesh's decode teacher-forced through MESH_TF_SLOTS slots, for the comparison; then
    # it and the prefill again with the planted fault
    steps = MESH_PROMPT + MESH_GEN - 1
    tf_specs = model.cache_specs(MESH_BATCH, MESH_TF_SLOTS)
    fed = torch.as_tensor(tokens[:, :steps], device=dev).long()

    def mesh_decode():
        cache = {n: torch.zeros(dctx.local_shape(sp), dtype=sp.dtype, device=dev)
                 for n, sp in tf_specs.items()}
        return _mesh_teacher_forced(model, dshards, cache, fed, range(steps),
                                    dctx.for_cache(MESH_TF_SLOTS))

    mesh_logits, cache = mesh_decode()
    with _data_major(mesh):
        fault_logits, fault_cache = mesh_decode()
        fault_plogits, fault_pcache = prefill(sshards, {"tokens": ptoks})
    del dshards, sshards
    torch.cuda.empty_cache()
    # 2. a train step of POD_TRAIN_BATCH x MESH_TRAIN_SEQ in MESH_MICROBATCHES microbatches
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (POD_TRAIN_BATCH, MESH_TRAIN_SEQ + 1), generator=gen,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with _counted(segments, "train"):
        tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        step = make_train_step(cfg, tctx, num_microbatches=MESH_MICROBATCHES,
                               shard_grad_accum=True)
        before = moved()
        t = time.perf_counter()
        state, metrics = step(opt.init_state(tshards), batch)
        out["loss"] = float(metrics["loss"])  # waits for the step
        out["step_s"] = time.perf_counter() - t
        live["train"] = collectives(before)
        del state, metrics
    # the gradient at POD_GRAD_BATCH x MESH_GRAD_SEQ, and again with the planted fault
    gtoks = torch.randint(0, cfg.vocab, (POD_GRAD_BATCH, MESH_GRAD_SEQ + 1), generator=gen,
                          device=dev)
    gbatch = {"tokens": gtoks[:, :-1], "labels": gtoks[:, 1:]}
    loss_mesh, g_mesh = _mesh_grads(model, tshards, tctx, gbatch)
    with _data_major(mesh):
        _, g_fault = _mesh_grads(model, tshards, tctx, gbatch)
    del tshards
    torch.cuda.empty_cache()
    # 3. the expert-parallel MoE: qwen3-moe's widths, one layer, POD_MOE_BATCH x POD_MOE_SEQ,
    # a row a (pod, data) rank, 64 experts a model rank
    mcfg = dataclasses.replace(get(MESH_MOE_ARCH), num_layers=1)
    mspecs = {f"blocks.moe.{k}": sp for k, sp in moe_mod.moe_specs(mcfg, 1).items()}
    x = torch.randn((POD_MOE_BATCH, POD_MOE_SEQ, mcfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 3)).bfloat16()
    with _counted(segments, "moe"):
        mctx = MeshCtx(TRAIN_RULES, mesh, mcfg)
        mfull = init_params(mspecs, torch.Generator(device=dev).manual_seed(seed + 2), device=dev)
        mshards = mctx.shard(mfull, mspecs)  # every rank draws the same weights
        if not root:
            del mfull
        t = time.perf_counter()
        with torch.no_grad():
            lp = {k.rsplit(".", 1)[-1]: mctx.gather(k, v[0]) for k, v in mshards.items()}
            y, aux = moe_mod.apply_moe(lp, mctx.local_batch(x), mcfg, mctx)
            y = mctx.whole_batch(y)
        torch.cuda.synchronize()
        out["moe_s"] = time.perf_counter() - t
        del lp, mshards
    sync_all()
    out["path_s"] = time.perf_counter() - t_path
    out["moved_bytes"], out["collective_calls"] = dict(D.moved), dict(D.calls)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["live_collectives"] = live
    out["segments"] = segments
    out.update(_sum_counts(segments.values()))
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    # 4. rank 0 against one process on the card, the others idle
    ref_cache = ref_pcache = g_ref = None
    if root:
        with torch.no_grad():  # the MoE: each (pod, data) row's tokens through every expert
            full_lp = {k.rsplit(".", 1)[-1]: v[0] for k, v in mfull.items()}
            parts = [moe_mod.apply_moe(full_lp, x[i:i + 1], mcfg) for i in range(POD_MOE_BATCH)]
            want = torch.cat([p[0] for p in parts])
            out["moe_max_abs_err"] = float((y.float() - want.float()).abs().max())
            out["moe_aux_err"] = abs(float(aux) - float(sum(p[1] for p in parts) / len(parts)))
            del full_lp, parts, want, mfull
        ref_cache = {n: torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
                     for n, sp in tf_specs.items()}
        one_logits, ref_cache = _mesh_teacher_forced(model, full, ref_cache, fed, range(steps))
        for key, lg in (("logit_max_abs_err", mesh_logits), ("fault_logit_max_abs_err",
                                                             fault_logits)):
            out[key] = max(float((m - o).abs().max()) for m, o in zip(lg, one_logits))
        cache32 = {n: torch.zeros(sp.shape, device=dev) for n, sp in tf_specs.items()}
        L.COMPUTE_DTYPE = torch.float32
        try:
            _, cache32 = _mesh_teacher_forced(model, full, cache32, fed, range(steps))
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        own = [(float((ref_cache[n].float() - c).square().sum()), float(c.square().sum()))
               for n, c in cache32.items()]
        out["cache_bf16_vs_f32_rel"] = (sum(a for a, _ in own) / sum(b for _, b in own)) ** 0.5
        del cache32, one_logits, mesh_logits, fault_logits
        state, metrics = make_train_step(cfg, num_microbatches=MESH_MICROBATCHES)(
            opt.init_state(full), batch)
        out["loss_ref"] = float(metrics["loss"])
        del state, metrics
        torch.cuda.empty_cache()
        loss_ref, g_ref = _mesh_grads(model, full, None, gbatch)
        L.COMPUTE_DTYPE = torch.float32
        try:
            loss_f32, g32 = _mesh_grads(model, {k: v.cpu() for k, v in full.items()}, None,
                                        {k: v.cpu() for k, v in gbatch.items()})
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        noise = sum(float((g_ref[k].float().cpu() - g32[k]).square().sum()) for k in g_ref)
        norm = sum(float(g32[k].square().sum()) for k in g32)
        out.update(grad_loss=[loss_mesh, loss_ref, loss_f32],
                   grad_rel_err_card_bf16_vs_cpu_f32=(noise / norm) ** 0.5)
        del g32
        one_prefill = make_prefill_step(cfg)
        one_plogits, ref_pcache = one_prefill(full, {"tokens": ptoks})
        L.COMPUTE_DTYPE = torch.float32
        try:
            _, pcache32 = one_prefill(full, {"tokens": ptoks})
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        for key, lg in (("prefill_logit_max_abs_err", plogits),
                        ("fault_prefill_logit_max_abs_err", fault_plogits)):
            out[key] = float((lg.float() - one_plogits.float())[..., :cfg.vocab].abs().max())
        own = [(float((ref_pcache[n].float() - c).square().sum()), float(c.square().sum()))
               for n, c in pcache32.items()]
        out["prefill_cache_bf16_vs_f32_rel"] = (sum(a for a, _ in own)
                                                / sum(b for _, b in own)) ** 0.5
        del one_plogits, pcache32
    del x, y
    for key, mine in (("cache", cache), ("fault_cache", fault_cache)):
        dist, size, _ = _shard_err(ref_cache, mine, tf_specs, DECODE_RULES, mesh)
        out[f"{key}_rel_dist"] = (dist / size) ** 0.5
    pspecs = model.cache_specs(MESH_BATCH, MESH_PREFILL_SEQ)
    for key, mine in (("prefill_cache", pcache), ("fault_prefill_cache", fault_pcache)):
        dist, size, _ = _shard_err(ref_pcache, mine, pspecs, SERVE_RULES, mesh)
        out[f"{key}_rel_dist"] = (dist / size) ** 0.5
    for key, mine in (("grad", g_mesh), ("fault_grad", g_fault)):
        dist, _, _ = _shard_err(g_ref, mine, specs, TRAIN_RULES, mesh)
        if root:
            out[f"{key}_rel_dist_mesh_vs_one"] = (dist / norm) ** 0.5
    del full, g_ref, g_mesh, g_fault, cache, pcache, plogits, ref_cache, ref_pcache
    del fault_cache, fault_pcache, fault_plogits
    torch.cuda.empty_cache()
    sync_all()
    return out


def _pod_traced_collectives(layers: int) -> dict:
    """The collectives of the pod world's prefill, decode step and train step
    as ``launch/dryrun.py::estimate`` traces them on a 2 x 2 x 2 trace mesh."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.mesh import make_local_mesh

    pod, data, model = POD_WORLD
    cells = {"prefill": (ShapeCell("prefill_32k", MESH_PREFILL_SEQ, MESH_BATCH, "prefill"), None),
             "decode": (ShapeCell("decode_32k", MESH_SLOTS, MESH_BATCH, "decode"), None),
             "train": (ShapeCell("train_4k", MESH_TRAIN_SEQ, POD_TRAIN_BATCH, "train"),
                       MESH_MICROBATCHES)}
    mesh = make_local_mesh(data, model, pod=pod)
    return {kind: estimate(_mesh_cfg(layers), cell, mesh, microbatch_override=mb)["collectives"]
            for kind, (cell, mb) in cells.items()}


def pod_phase(seed: int, card: str, layers: int = MESH_LAYERS) -> dict:
    """The pod world (path ``mesh_pod``): a 2 x 2 x 2 ("pod", "data", "model")
    world of eight processes on the one card over Gloo, granite-8b at its
    published widths, depth ``layers``, fan-in scaled weights (``_fan_in``)
    that rank 0 makes and hands out.  Counted: ``ServeEngine`` with a
    ``MeshCtx`` under DECODE_RULES (batch MESH_BATCH over ``("pod", "data")``,
    a row a rank; MESH_SLOTS slots over model) and one more decode step; a
    prefill of MESH_BATCH x MESH_PREFILL_SEQ under SERVE_RULES; a train step
    of POD_TRAIN_BATCH x MESH_TRAIN_SEQ in MESH_MICROBATCHES microbatches with
    ``shard_grad_accum`` under TRAIN_RULES (FSDP over ``("pod", "data")``);
    qwen3-moe's widths at one layer, the expert-parallel MoE over
    POD_MOE_BATCH x POD_MOE_SEQ tokens, 64 experts a model rank and data over
    both axes.  Then, against one process on the card (rank 0): the MoE's
    y and aux, the loss, and ``_mesh_failures``'s gates on the decode's
    logits and caches (teacher-forced through MESH_TF_SLOTS slots), the
    prefill's logits and cache and the gradient at POD_GRAD_BATCH x
    MESH_GRAD_SEQ; the same run with a planted fault (each rank's index on
    ``("pod", "data")`` taken data-major, ``_data_major``) must fail one of
    them.  (It moves each FSDP shard to another rank's place in the gathered
    weights, and each rank's rows of the batch, both consistently: the model
    is symmetric under that permutation of its hidden units at init, and
    the gradient moves by 0.013 relative where its gate is ~0.046; the
    caches, laid out by the ranks' coordinates, show it.)  Rank 0's collectives of the decode step, prefill and train step
    must equal ``estimate``'s trace on a 2 x 2 x 2 ``TraceMesh``.  Each
    rank's peak memory and bytes per kind of collective printed, beside
    ``card``; eight ranks share one card: no number here says anything of
    multi-GPU speed."""
    import torch

    from repro_torch.launch.mesh import launch

    pod, data, model = POD_WORLD
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = launch(_pod_rank, seed, layers, pod=pod, data=data, model=model, device="cuda",
                   backend="gloo", timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t
    root = ranks[0]
    for r in ranks:
        print(json.dumps({"mesh_pod_rank": {k: v for k, v in r.items() if k != "tokens"}},
                         default=float), flush=True)
    steps = MESH_PROMPT + MESH_GEN - 1
    want = {"serve": {"tile": layers, "split": (steps + 1) * layers, "general": 0},
            "train": {"tile": 2 * MESH_MICROBATCHES * layers, "split": 0, "general": 0}}
    for r in ranks:
        if r["device"].split(":")[0] != "cuda":
            raise SystemExit(f"pod rank {r['rank']} ran on {r['device']}")
        c = r["coords"]
        if r["pod_data_axis"] != [pod * data, c["pod"] * data + c["data"]]:
            raise SystemExit(f"pod rank {r['rank']}: its (pod, data) axis is {r['pod_data_axis']}")
        seg = r["segments"]
        if (any(seg[k]["variants"] != v for k, v in want.items())
                or any(seg[k]["tile_designs"] != {"wgmma": v["tile"], "mma": 0}
                       for k, v in want.items())
                or seg["train"]["designs"].get("wgmma") != MESH_MICROBATCHES * layers):
            raise SystemExit(f"pod rank {r['rank']} launched {seg}; want {want}, every tile on "
                             "wgmma")
        if not np.array_equal(r["tokens"], root["tokens"]) or r["loss"] != root["loss"]:
            raise SystemExit(f"pod rank {r['rank']}'s tokens or loss differ from rank 0's")
    read = _sum_counts([{part: r[part] for part in ("launches", "variants", "tile_designs",
                                                    "designs")} for r in ranks])
    failed, planted = _mesh_failures(root), _mesh_failures(root, "fault_")
    trace = _pod_traced_collectives(layers)
    row = {
        "world": f"{pod} x {data} x {model} gloo, one card", "card": card, "layers": layers,
        "wall_s": wall, "path_s": root["path_s"], "generation_s": root["generation_s"],
        "decode_tok/s": MESH_BATCH * steps / root["generation_s"],
        "prefill_s": [r["prefill_s"] for r in ranks], "step_s": root["step_s"],
        "tokens/s": POD_TRAIN_BATCH * MESH_TRAIN_SEQ / root["step_s"], "moe_s": root["moe_s"],
        "loss": root["loss"], "loss_one_process": root["loss_ref"],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in ranks],
        "moved_bytes_by_rank": [r["moved_bytes"] for r in ranks],
        "collective_calls_by_rank": [r["collective_calls"] for r in ranks],
        "trace_collectives": trace, "live_collectives_rank0": root["live_collectives"],
        "gates": {"logit_atol": SERVE_LOGIT_ATOL,
                  "cache_rel": MESH_CACHE_NOISE_FACTOR * root["cache_bf16_vs_f32_rel"],
                  "grad_rel": TRAIN_NOISE_FACTOR * root["grad_rel_err_card_bf16_vs_cpu_f32"]
                  + TRAIN_GRAD_FLOOR},
        "failed": failed, "data_major_rejected_by": planted,
        **{k: root[k] for k in (
            "logit_max_abs_err", "cache_rel_dist", "cache_bf16_vs_f32_rel",
            "prefill_logit_max_abs_err", "prefill_cache_rel_dist",
            "prefill_cache_bf16_vs_f32_rel", "grad_rel_dist_mesh_vs_one",
            "grad_rel_err_card_bf16_vs_cpu_f32", "grad_loss", "moe_max_abs_err", "moe_aux_err",
            "hand_out_s", "fault_logit_max_abs_err", "fault_cache_rel_dist",
            "fault_prefill_logit_max_abs_err", "fault_prefill_cache_rel_dist",
            "fault_grad_rel_dist_mesh_vs_one")},
        "launches_by_block": root["segments"], "launches": read}
    print(json.dumps({"mesh_pod": row}, default=float), flush=True)
    if (failed or root["moe_max_abs_err"] > MESH_MOE_ATOL
            or root["moe_aux_err"] > MESH_AUX_ATOL
            or abs(root["loss"] - root["loss_ref"]) > TRAIN_LOSS_ATOL
            or abs(root["grad_loss"][0] - root["grad_loss"][1]) > TRAIN_LOSS_ATOL):
        raise SystemExit(f"the pod world disagrees with one process on the card ({failed}): "
                         f"{row}")
    if not planted:
        raise SystemExit(f"the pod world's gates passed the data-major fault: {row}")
    if trace != root["live_collectives"]:
        raise SystemExit(f"the dry-run's trace counts other collectives than pod rank 0 made: "
                         f"traced {trace}, live {root['live_collectives']}")
    return {"row": row, **read}


def _run_example(path: pathlib.Path, device: str) -> tuple[list[str], float]:
    """``path`` run in this process as ``python path --device device``: its
    printed lines and wall seconds (the card synchronized)."""
    import io
    import runpy

    import torch

    argv, sys.argv = sys.argv, [str(path), "--device", device]
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines(), time.perf_counter() - t


def examples_phase(card: str, zero_counts, read_counts) -> dict:
    """The port's six examples (path ``examples``): each run in this process
    (``runpy``, its own argv) on the card at its own size
    (``video_streaming`` at full size: 24 MiB in 1 MiB chunksets), its
    ``assert``s the gates; the launches counted over the six, and
    ``serve_llm``'s attention by variant (one launch a layer and decode
    step).  Then each again with ``--device cpu``: every printed line equal
    to the card's but the wall-clock figure."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf_matmul as gk

    root = pathlib.Path(__file__).resolve().parent / "examples" / "torch"
    os.environ["VIDEO_SMOKE"] = "0"
    torch.cuda.empty_cache()
    zero_counts()
    runs = {}
    serve_variants = {}
    for name in EXAMPLES:
        gf0, fa0 = gk.gf_matmul.launches, dict(fa.flash_attention.variant_launches)
        lines, wall = _run_example(root / f"{name}.py", "cuda")
        runs[name] = {"card_s": wall, "lines": lines,
                      "gf_matmul_launches": gk.gf_matmul.launches - gf0}
        if name == "serve_llm":
            serve_variants = {v: n - fa0[v] for v, n in fa.flash_attention.variant_launches.items()}
    counts = read_counts("examples")
    cfg = get_smoke("granite-8b")
    want_attention = (8 + 16 - 1) * cfg.num_layers  # serve_llm: 23 decode steps a generation
    if (any(r["gf_matmul_launches"] == 0 for r in runs.values())
            or sum(serve_variants.values()) != want_attention
            or counts["flash_attention"] != want_attention):
        raise SystemExit(f"the examples' launches are off: {counts}, serve_llm attention "
                         f"{serve_variants} (want {want_attention})")
    for name in EXAMPLES:
        lines, wall = _run_example(root / f"{name}.py", "cpu")
        r = runs[name]
        r["cpu_s"] = wall
        r["equal"] = [EXAMPLE_WALL.sub("", x) for x in r["lines"]] == [
            EXAMPLE_WALL.sub("", x) for x in lines]
        print(json.dumps({"example": name, "card": card, **{k: v for k, v in r.items()
                                                            if k != "lines"},
                          "printed": r["lines"]}), flush=True)
        if not r["equal"]:
            raise SystemExit(f"example {name} printed other lines on the card than on the CPU: "
                             f"{r['lines']} against {lines}")
    return {"runs": runs, "serve_llm_attention": serve_variants, "counts": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blob-mib", type=int, default=1024, help="blob size in MiB (default 1024)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--das-blobs", type=int, default=DAS_BLOBS,
                    help=f"blobs in the DAS phase (default {DAS_BLOBS})")
    ap.add_argument("--mesh-layers", type=int, default=MESH_LAYERS,
                    help=f"granite-8b's depth in the mesh phase (default {MESH_LAYERS})")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run the mesh phase alone (no result line)")
    ap.add_argument("--pod-only", action="store_true",
                    help="build the kernels and run the pod world alone (no result line)")
    ap.add_argument("--examples-only", action="store_true",
                    help="build the kernels and run the examples alone (no result line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.core import commitments as cm
    from repro_torch.core.clay import ClayCode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.kernels import sample_hash as sh
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.models.attention import ring_positions

    wrappers = {"gf_matmul": gk.gf_matmul, "flash_attention": fa.flash_attention,
                "sample_hash": sh.sample_hash, "flash_attention_bwd": fab.flash_attention_bwd}
    path_launches: dict[str, dict[str, int]] = {}  # path -> kernel -> launches

    variant_launches: dict[str, dict[str, int]] = {}  # path -> attention kernel -> launches
    tile_designs: dict[str, dict[str, int]] = {}  # path -> "tile" design -> launches
    design_launches: dict[str, dict[str, int]] = {}  # path -> backward design -> launches

    zero_counts = _zero_counts

    def read_counts(path: str) -> dict[str, int]:
        path_launches[path] = {name: fn.launches for name, fn in wrappers.items()}
        variant_launches[path] = dict(fa.flash_attention.variant_launches)
        tile_designs[path] = dict(fa.flash_attention.design_launches)
        design_launches[path] = dict(fab.flash_attention_bwd.design_launches)
        print(json.dumps({"path": path, "launches": path_launches[path],
                          "flash_attention_variants": variant_launches[path],
                          "flash_attention_tile_designs": tile_designs[path],
                          "flash_attention_bwd_designs": fab.flash_attention_bwd.design_launches}),
              flush=True)
        return path_launches[path]

    # -- 1. card, build ------------------------------------------------------------
    _phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    t0 = time.perf_counter()
    # one nvcc per csrc/<name>.cu, all started together (each waits in its own thread)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda lib: lib(), (gk._lib, sh._lib, fa._lib, fab._lib)))
    print(f"kernel build+load ({', '.join(KERNELS)}): {time.perf_counter() - t0:.3f} s",
          flush=True)
    if args.mesh_only:
        _phase(f"mesh alone: {MESH_ARCH} at {args.mesh_layers} layers")
        mesh_phase(args.seed, layers=args.mesh_layers)
        return 0
    if args.pod_only:
        _phase(f"pod world alone: {MESH_ARCH} at {args.mesh_layers} layers")
        pod_phase(args.seed, card, layers=args.mesh_layers)
        return 0
    if args.examples_only:
        _phase("examples alone")
        examples_phase(card, zero_counts, read_counts)
        return 0
    from repro_torch.kernels import _build

    ptxas = {name: _build.ptxas_report(name)
             for name in ("gf_matmul", "flash_attention", "flash_attention_bwd")}
    for name, lines in ptxas.items():  # registers, spills, shared memory
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
    print(json.dumps({"gf_matmul_ptxas": {
        "kernels": sum("Compiling entry" in ln for ln in ptxas["gf_matmul"]),
        "spill_bytes": sum(int(x) for ln in ptxas["gf_matmul"]
                           for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))}}),
          flush=True)
    print(json.dumps({"flash_attention_bwd_ptxas": {
        "kernels": sum("Compiling entry" in ln for ln in ptxas["flash_attention_bwd"]),
        "spill_bytes": sum(int(x) for ln in ptxas["flash_attention_bwd"]
                           for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))}}),
          flush=True)
    # every backward instance's registers and spills ("wgmma" (192, 128) is MLA's, phase 17)
    regs, spills = (f(ptxas["flash_attention_bwd"]) for f in (ptxas_registers, ptxas_spills))
    print(json.dumps({"flash_attention_bwd_kernels_ptxas": {
        name: {"registers": regs.get(name), "spill_bytes": spills.get(name)} for name in regs}}),
          flush=True)
    if not spills or any(n for name, n in spills.items() if "wgmma" in name):
        raise SystemExit(f"flash_attention_bwd: a wgmma kernel spills (or no ptxas report): "
                         f"{spills}")

    # -- 2. kernels against their plain versions --------------------------------------
    _phase("gf_matmul vs plain")
    lay = CONFIG.layout
    alpha, w, k, m = ClayCode(lay.k, lay.m, device="cuda").alpha, lay.w, lay.k, lay.m
    n_cs = -(-args.blob_mib * 2**20 // lay.chunkset_bytes)
    timed_shapes = gf_shapes(args.blob_mib, args.das_blobs)
    enc_blob = timed_shapes["encode_blob"]
    shapes = [*timed_shapes.values(), (4, 4, 65536), (1, 4, 65536), (1, 1, 1_000_003),
              (1, 17, alpha * w), (32, 32, 100_003)]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks = check_gf_matmul(shapes, gen, timed=set(timed_shapes.values()))
    max_err = max(r["max_abs_err"] for r in checks)
    mismatches = sum(r["mismatches"] for r in checks)

    _phase("sample_hash vs plain")
    chunk_samples = -(-lay.chunk_bytes // cm.SAMPLE_BYTES)
    audit_shape = (n_cs * lay.n * chunk_samples, cm.SAMPLE_BYTES // 4, 0)  # the audit path's
    sh_checks = check_sample_hash(
        [audit_shape, audit_shape[:2] + (1,), (1_000_003, 256, 0), (4097, 3, 1), (1, 4, 0)],
        gen, timed={audit_shape})

    _phase("flash_attention vs plain (bf16, yi-9b widths: H 32, Hkv 4, hd 128)")
    serve_batch, serve_prompt, serve_gen = 4, 8, 16
    serve_slots = serve_prompt + serve_gen + 1
    def ar(n, start=0):  # int32, as the serving path passes positions: no cast in the call
        return torch.arange(start, start + n, dtype=torch.int32, device="cuda")

    attn_cases = [
        ("pallas_contract_causal", 1, 2048, 2048, 32, 4, 128, True, 0, ar(2048), ar(2048)),
        ("decode_4096_slots", 16, 1, 4096, 32, 4, 128, True, 0, ar(1, 2047), ar(4096)),
        ("serve_decode", serve_batch, 1, serve_slots, 32, 4, 128, True, 0,
         ar(1, serve_prompt + serve_gen - 2), ar(serve_slots)),
        ("ragged_noncausal_mha", 2, 1000, 1537, 8, 8, 128, False, 0, ar(1000), ar(1537)),
        ("ring_buffer_window", 8, 1, 1024, 32, 4, 128, True, 1024, ar(1, 5000),
         ring_positions(5000, 1024, "cuda")),
        # split decode whose last splits are wholly hidden (slots past pos 1000)
        ("decode_4096_pos1000", 16, 1, 4096, 32, 4, 128, True, 0, ar(1, 1000), ar(4096)),
        # queries -128..127: the first 128 see no key while tiles past 127 are skipped
        ("row_sees_no_key", 1, 256, 512, 32, 4, 128, True, 0, ar(256, -128), ar(512)),
        # a window over ragged tiles: a "wgmma" warpgroup skips a tile after one it computed
        # (its ring holds two stages at hd 128)
        ("window_skips_after_computing", 3, 200, 260, 8, 2, 128, True, 33, ar(200, 60),
         ar(260)),
        # a prefill of the serving batch's 8-token prompts at yi-9b's GQA group of 8: 64
        # (query, head) rows of a kv head but fewer than 64 queries, the "mma" design's
        ("serve_prompt_prefill", serve_batch, serve_prompt, serve_prompt, 32, 4, 128, True, 0,
         ar(serve_prompt), ar(serve_prompt)),
        # phase 15's forward: a microbatch of starcoder2-3b (H 24, Hkv 2) at train_4k
        ("train_microbatch", TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, TRAIN_SEQ, 24, 2, 128,
         True, 0, ar(TRAIN_SEQ), ar(TRAIN_SEQ)),
        # phase 16: hymba (H 25, Hkv 5: a GQA group of 5, hd 64) at its training step, its
        # serving step, and its long-mode decode over the 2,048-slot ring (window 2048)
        # after the ring wrapped and before it filled (unwritten slots at UNWRITTEN)
        ("hymba_train", 1, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_SEQ, 25, 5, 64, True, 0,
         ar(FAMILY_TRAIN_SEQ), ar(FAMILY_TRAIN_SEQ)),
        ("hymba_serve_decode", serve_batch, 1, serve_slots, 25, 5, 64, True, 0,
         ar(1, serve_prompt + serve_gen - 2), ar(serve_slots)),
        ("hymba_ring_wrapped", 1, 1, 2048, 25, 5, 64, True, 2048, ar(1, FAMILY_LONG_POSITIONS - 1),
         ring_positions(FAMILY_LONG_POSITIONS - 1, 2048, "cuda")),
        ("hymba_ring_unwritten", 1, 1, 2048, 25, 5, 64, True, 2048, ar(1, 1500),
         ring_positions(1500, 2048, "cuda")),
        # phase 16's qwen3-moe prefill (H 32, Hkv 4, hd 128)
        ("qwen3_prefill", 1, FAMILY_MOE_SEQ, FAMILY_MOE_SEQ, 32, 4, 128, True, 0,
         ar(FAMILY_MOE_SEQ), ar(FAMILY_MOE_SEQ)),
        # phase 17's whisper-tiny (H 6, hd 64), non-causal over 1,500 frames: its encoder at
        # the training batch, its cross-attention in training (448 tokens) and in decode
        ("whisper_encoder", ENCDEC_TRAIN_BATCH, 1500, 1500, 6, 6, 64, False, 0, ar(1500),
         ar(1500)),
        ("whisper_cross_train", ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1500, 6, 6, 64, False, 0,
         ar(ENCDEC_TRAIN_SEQ), ar(1500)),
        ("whisper_cross_decode", serve_batch, 1, 1500, 6, 6, 64, False, 0, ar(1), ar(1500)),
        # phase 19's prefill on the mesh: a rank's rows (2 of 4) over 4,096 tokens at
        # granite-8b's widths over model = 2 (H 16 / Hkv 4 a rank, hd 128)
        ("mesh_prefill", MESH_BATCH // MESH_DATA, MESH_PREFILL_SEQ, MESH_PREFILL_SEQ,
         32 // MESH_MODEL, 8 // MESH_MODEL, 128, True, 0, ar(MESH_PREFILL_SEQ),
         ar(MESH_PREFILL_SEQ)),
    ]
    print(json.dumps({"flash_attention_kernels_ptxas": check_flash_attention_ptxas()}),
          flush=True)
    attn_checks = check_flash_attention(attn_cases, gen)
    if next(r for r in attn_checks if r["case"] == "serve_prompt_prefill")["design"] != "mma":
        raise SystemExit("the 8-token prompts' prefill did not take the mma design")
    # phase 17's deepseek: MLA at hd 192 / hd_v 128 (V at its own width), H 16 = Hkv, 1 x 4096
    attn_checks.append(check_mla_attention("mla_train", 1, MLA_SEQ, 16, 192, 128, gen))
    # phase 19's decode: a rank's rows (2 of 4) over its 2,048 of 4,096 slots at granite-8b's
    # widths, "split" writing lse; the second model rank's shard sees no key at position 23
    shard = MESH_SLOTS // MESH_MODEL
    for name, k_start in (("mesh_decode_lse", 0), ("mesh_decode_lse_blind", shard)):
        attn_checks.append(check_split_lse(name, MESH_BATCH // MESH_DATA, shard, 32, 8, 128,
                                           MESH_PROMPT + MESH_GEN - 1, k_start, gen))
    # phase 19's hymba in long mode: a rank's 1,024 slots of the 2,048-slot ring (window
    # 2,048), after the ring wrapped; the second rank's half before any of it was written
    ring = 2048
    for name, pos, k_start in (("mesh_ring_shard_lse", MESH_LONG_POSITIONS[-1], 0),
                               ("mesh_ring_shard_lse_blind", 1000, ring // MESH_MODEL)):
        attn_checks.append(check_split_lse(name, 1, ring // MESH_MODEL, 25, 5, 64, pos,
                                           k_start, gen, ring=ring))

    _phase("flash_attention_bwd vs plain (bf16; phase 15's shape: B 4, S 4096, H 24, Hkv 2, "
           "hd 128; phase 16's: B 1, S 4096, H 25, Hkv 5, hd 64; phase 17's: B 1, S 4096, "
           "H 16, hd 192)")
    bwd_checks = check_flash_attention_bwd(backward_cases(), gen,
                                           timed=("train_microbatch", "hymba_train", "mla_train"))

    # -- 3. the main path at production size -------------------------------------------
    _phase(f"slice: put/read a {args.blob_mib} MiB blob at (10,6), 10 MiB chunksets")
    contract, sps, rpc, client = build_cluster(
        num_sps=CONFIG.num_sps, layout=CONFIG.layout, device="cuda",
        num_dcs=CONFIG.num_dcs, racks_per_dc=CONFIG.racks_per_dc,
    )
    data = np.random.default_rng(args.seed).bytes(args.blob_mib * 2**20)
    cs_bytes = client.layout.chunkset_bytes
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    phases: dict[str, dict] = {}
    zero_counts()  # count the storage path only
    seen = 0

    def run_phase(name, fn, nbytes):
        nonlocal seen
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = gk.gf_matmul.launches - seen
        seen = gk.gf_matmul.launches
        phases[name] = {"s": dt, "GB/s": nbytes / dt / 1e9, "gf_matmul_launches": launches}
        print(json.dumps({"phase": name, **phases[name]}), flush=True)
        if launches == 0:
            raise SystemExit(f"phase {name!r} made no gf_matmul launch")
        return out

    def clear_caches():
        for node in client.fleet.rpcs:
            node._cache.clear()

    meta = run_phase("put", lambda: client.put(data), len(data))
    # the put also extends the blob's DAS square: two launches beside the encode's one
    das_rec = contract.das.get(meta.blob_id)
    if das_rec is None or len(das_rec.placement) != das_rec.side ** 2 or sum(
            sp.stored_shares() for sp in sps.values()) != das_rec.side ** 2:
        raise SystemExit("the put registered no DAS square or did not place its shares")
    if phases["put"]["gf_matmul_launches"] != 3:
        raise SystemExit(f"the put made {phases['put']['gf_matmul_launches']} launches, not 3")
    got = run_phase("read_whole", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "whole read differs from the blob"
    last = meta.num_chunksets - 1
    ranges = [(cs_bytes - 1000, 5000),
              (cs_bytes * (meta.num_chunksets // 2) - 777, cs_bytes + 1554),
              (cs_bytes * last - 12345, None)]
    for i, (off, ln) in enumerate(ranges):
        clear_caches()
        got = run_phase(f"read_range{i}", lambda: client.get(meta.blob_id, off, ln),
                        ln or len(data) - off)
        assert got == data[off: None if ln is None else off + ln], f"range {i} differs"
    # the RPC node's synchronous reads: a range across a chunkset boundary, the whole blob
    clear_caches()
    off, ln = cs_bytes - 4321, 10_000
    got = run_phase("rpc_read_range", lambda: rpc.read_range(meta.blob_id, off, ln), ln)
    assert got == data[off:off + ln], "the RPC node's read_range differs from the blob"
    clear_caches()
    got = run_phase("rpc_read_blob", lambda: rpc.read_blob(meta.blob_id), len(data))
    assert got == data, "the RPC node's read_blob differs from the blob"
    crashed = [meta.placement[(0, 0)], meta.placement[(0, 1)]]
    for sp_id in crashed:
        sps[sp_id].crash()
    clear_caches()
    got = run_phase("read_degraded", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "degraded read differs from the blob"
    corrupt = next(meta.placement[(0, c)] for c in range(2, lay.n)
                   if meta.placement[(0, c)] not in crashed)
    sps[corrupt].behavior.corrupt = True
    bad0 = rpc.stats.chunks_bad
    clear_caches()
    got = run_phase("read_corrupt", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "read with a corrupt SP differs from the blob"
    assert rpc.stats.chunks_bad > bad0, "corrupt chunks were not detected"
    read_counts("storage")
    settlement = client.settle()
    dep = settlement.total_deposited
    out = settlement.total_refunded + settlement.total_node_income
    assert abs(dep - out) <= 1e-6 * max(dep, 1.0), (dep, out)
    print(json.dumps({
        "blob_bytes": len(data), "chunksets": meta.num_chunksets,
        "crashed_sps": crashed, "corrupt_sp": corrupt,
        "chunks_requested": rpc.stats.chunks_requested, "chunks_bad": rpc.stats.chunks_bad,
        "deposited": dep, "refunded_plus_income": out,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }), flush=True)

    # -- 4. the audit path: bulk digests of every stored sample ----------------------
    _phase("audit: bulk digests of every 1 KiB sample the put stored")
    for sp_id in crashed:
        sps[sp_id].recover()
    sps[corrupt].behavior.corrupt = False
    samples = audit_samples(sps, meta, lay.chunk_bytes)
    zero_counts()  # count the audit path only
    t = time.perf_counter()
    digests = cm.bulk_sample_digests(samples, seed=args.seed, device="cuda")
    audit_s = time.perf_counter() - t
    read_counts("audit")
    head = 50_000  # the CPU plain version on the first samples
    assert np.array_equal(digests[:head], cm.bulk_sample_digests(samples[:head], seed=args.seed,
                                                                 device="cpu")), \
        "audit digests on the card differ from the CPU plain path"
    assert digests.shape == (samples.shape[0],) and digests.dtype == np.uint32
    print(json.dumps({"audit": {"samples": samples.shape[0], "bytes": samples.nbytes,
                                "s": audit_s, "GB/s": samples.nbytes / audit_s / 1e9,
                                "distinct_digests": int(np.unique(digests).size)}}), flush=True)
    del samples, digests

    # -- 5. Clay MSR repair on the card, on the same cluster ----------------------------
    _phase("repair: wipe one SP, crash one SP, lose two chunks of one chunkset; repair_all")
    zero_counts()  # count the repair path only
    repair_phase(contract, sps, client, meta, gk)
    counts = read_counts("repair")
    if counts["gf_matmul"] == 0:
        raise SystemExit("the repair path made no gf_matmul launch")
    clear_caches()
    t = time.perf_counter()
    got = client.get(meta.blob_id)
    print(json.dumps({"repair_read_back": {"s": time.perf_counter() - t, "equal": got == data}}),
          flush=True)
    if got != data:
        raise SystemExit("the blob read back after repair differs from what was written")
    client.settle()

    # -- 6. membership churn with re-dispersal, paid reads alongside ---------------------
    _phase(f"churn: {CHURN_EPOCHS} epochs of crashes, departures and joins, "
           f"{CHURN_READS} paid reads replayed alongside")
    clear_caches()
    zero_counts()  # count the churn path only
    churn = churn_phase(contract, sps, client, meta, data, gk, args.seed, CHURN_READS)
    counts = read_counts("churn")
    if counts["gf_matmul"] < churn["repairs_msr"] or counts["gf_matmul"] == 0:
        raise SystemExit(f"the churn path's gf_matmul launches are off: {counts}")

    # -- 7. data-availability sampling on the JAX package's build_cluster deployment ----
    _phase(f"das: {args.das_blobs} blobs of one square each, extended on the card, "
           f"sampled, withheld, stormed, rebuilt")
    zero_counts()  # count the DAS path only
    das_phase(gk, args.seed, args.das_blobs)
    counts = read_counts("das")
    if counts["gf_matmul"] < 2 * args.das_blobs + 4:
        raise SystemExit(f"the DAS path's gf_matmul launches are off: {counts}")

    # -- 8. device against the CPU plain path on one chunkset -------------------------
    _phase("encode/decode: card vs CPU plain path, one production chunkset")
    plain = np.frombuffer(data[:cs_bytes], np.uint8).reshape(k, alpha, w).copy()
    dev_code, cpu_code = ClayCode(k, m, device="cuda"), ClayCode(k, m, device="cpu")
    coded = dev_code.encode(plain).cpu()
    assert torch.equal(coded, cpu_code.encode(plain)), "device encode differs from CPU"
    shards = {i: coded[i].numpy() for i in range(k + m) if i not in (0, 3, 7, 11, 12, 15)}
    assert torch.equal(dev_code.decode(shards).cpu(), coded), "device decode differs"
    torch.cuda.synchronize()
    print("card == CPU plain path: ok", flush=True)

    # -- 9. where the put's and a read's time goes: each step timed alone ------------
    _phase(f"breakdown: steps of the put and of a read of {BREAKDOWN_MIB} MiB, timed alone")

    def timed_step(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    blob_lay = client.layout
    prefix = data[:BREAKDOWN_MIB * 2**20]
    parts, t_part = timed_step(lambda: blob_lay.partition(prefix))
    coded_dev, t_enc = timed_step(lambda: blob_lay.code.encode_batch(parts))
    coded_host, t_d2h = timed_step(lambda: coded_dev.cpu().numpy())
    del parts, coded_dev
    _, t_hash = timed_step(lambda: [cm.commit_chunk(c) for cw in coded_host for c in cw])
    first_k = [{i: cw[i] for i in range(k)} for cw in coded_host]
    _, t_dec = timed_step(lambda: blob_lay.code.reconstruct_data_batch(first_k))
    print(json.dumps({"breakdown_s": {
        "bytes": len(prefix), "partition_h2d": t_part, "encode_device": t_enc, "coded_d2h": t_d2h,
        "sha256_merkle_all_chunks": t_hash, "chunks": int(coded_host.shape[0] * (k + m)),
        "h2d_decode_first_k": t_dec,
    }}), flush=True)
    del coded_host, first_k

    # -- 10. how much of a put and a read the card is busy ----------------------------
    _phase(f"device busy share: put and whole read of {BREAKDOWN_MIB} MiB on a fresh cluster, "
           "profiled")
    _, _, _, client2 = build_cluster(
        num_sps=CONFIG.num_sps, layout=CONFIG.layout, device="cuda",
        num_dcs=CONFIG.num_dcs, racks_per_dc=CONFIG.racks_per_dc,
    )
    held = {}
    busy = {"put": device_busy(lambda: held.update(meta=client2.put(prefix)))}
    busy["read_whole"] = device_busy(lambda: held.update(got=client2.get(held["meta"].blob_id)))
    assert held["got"] == prefix, "profiled read differs from the blob"
    busy["bytes"] = len(prefix)
    client2.settle()
    print(json.dumps({"device_busy": busy}), flush=True)
    del client2, held, prefix

    # -- 11. the serving path at yi-9b width ---------------------------------------------
    _phase(f"serve: {SERVE_ARCH} at published widths, {SERVE_LAYERS} layers, through Shelby")
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get(SERVE_ARCH), num_layers=SERVE_LAYERS)
    print(json.dumps({"serve_config": {
        "arch": cfg.name, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "norm": cfg.norm, "mlp": cfg.mlp,
        "layers": f"{cfg.num_layers} (cut from {get(SERVE_ARCH).num_layers}: host-bound publish)",
        "params": build(cfg).param_count()}}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # count the serving path only
    run = serve(cfg, batch=serve_batch, prompt_len=serve_prompt, gen=serve_gen, kill_sp=True,
                device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    counts = read_counts("serve")
    steps = serve_prompt + serve_gen - 1
    if (counts["gf_matmul"] == 0 or counts["flash_attention"] != steps * SERVE_LAYERS
            or variant_launches["serve"]["split"] != steps * SERVE_LAYERS):
        raise SystemExit(f"the serving path's launches are off: {counts}, "
                         f"attention {variant_launches['serve']}")
    if not all(torch.equal(run.served[k_], run.published[k_]) for k_ in run.published):
        raise SystemExit("restored weights differ from the published ones")
    if not ((run.outputs >= 0) & (run.outputs < cfg.vocab)).all():
        raise SystemExit("generated token ids out of the vocabulary")
    mem = torch.cuda.max_memory_allocated()
    serve_card_vs_cpu(cfg, run)
    # decode again on the same weights, warm: the counted run's decode pays one-time costs
    engine = ServeEngine(cfg, run.served, max_len=serve_prompt + serve_gen + 1)
    warm_s = []
    for _ in range(WARM_GENERATIONS):
        t = time.perf_counter()
        engine.generate(run.prompts, num_tokens=serve_gen)  # ends with a copy to the host
        warm_s.append(time.perf_counter() - t)
    warm_median = sorted(warm_s)[WARM_GENERATIONS // 2]
    nbytes = run.record.total_bytes
    print(json.dumps({"serve": {
        "weight_bytes": nbytes, "publish_s": run.publish_s, "publish_GB/s": nbytes / run.publish_s / 1e9,
        "restore_s": run.restore_s, "restore_GB/s": nbytes / run.restore_s / 1e9,
        "restored_equal": True, "outputs_shape": list(run.outputs.shape),
        "decoded_tokens": run.decoded_tokens, "first_decode_s": run.decode_s,
        "warm_decode_s": warm_s, "decode_tok/s": run.decoded_tokens / warm_median,
        "gf_matmul_launches": counts["gf_matmul"], "attention_launches": counts["flash_attention"],
        "max_memory_allocated": mem,
    }}), flush=True)
    del run, engine

    # -- 12. the cohort fast path at the engine scenario's scale --------------------------
    from repro_torch.scenarios import engine as eng

    _phase(f"engine: Zipf storms of {', '.join(f'{n:,}' for n in eng.RAMP)} requests "
           f"through the cohort fast path, {eng.NUM_SPS} SPs, {eng.NUM_RPCS} RPC nodes")
    zero_counts()  # count the engine path only
    engine_phase(gk)
    if read_counts("engine")["gf_matmul"] == 0:
        raise SystemExit("the engine path made no gf_matmul launch")

    # -- 13. overload control: the concurrent scenario's ramp ----------------------------
    _phase(f"overload: {OVERLOAD_REQUESTS} Poisson Zipf reads at "
           f"{'/'.join(map(str, OVERLOAD_RATES))} rps, free-running and admitted")
    zero_counts()  # count the overload path only
    overload_phase(gk)
    if read_counts("overload")["gf_matmul"] == 0:
        raise SystemExit("the overload path made no gf_matmul launch")

    # -- 14. the registered scenarios on the card ------------------------------------------
    _phase(f"scenarios: {', '.join(SCENARIOS)} and engine at full size, simsan, a sweep")
    zero_counts()  # count the scenario path only
    scenario_phase(gk)
    if read_counts("scenarios")["gf_matmul"] == 0:
        raise SystemExit("the scenario path made no gf_matmul launch")

    # -- 15. training over Shelby at starcoder2-3b's widths --------------------------------
    _phase(f"train: {TRAIN_ARCH} at published widths, {TRAIN_LAYERS} layers, through Shelby")
    train_phase(args.seed, zero_counts, read_counts, variant_launches)

    # -- 16. the MoE, SSM, hybrid and embedding-input families --------------------------------
    _phase(f"families: {FAMILY_ARCH} at published widths, {FAMILY_LAYERS} layers, served from "
           f"Shelby, long mode, a training step; {FAMILY_MOE_ARCH} prefill; smoke families")
    families_phase(args.seed, zero_counts, read_counts, variant_launches)

    # -- 17. MLA and the encoder-decoder -------------------------------------------------------
    _phase(f"mla_encdec: {ENCDEC_ARCH} at its published size served from Shelby and trained; "
           f"{MLA_ARCH} at published widths, {MLA_LAYERS} layers: prefill, absorbed decode, "
           "training; card vs CPU")
    mla_encdec_phase(args.seed, zero_counts, read_counts, variant_launches)

    # -- 18. the dry-run against the card ------------------------------------------------------
    _phase(f"dryrun: {', '.join(f'{a} {c.name}' for a, c in _dryrun_cells())} at published "
           f"widths, {DRYRUN_LAYERS} layers: the meta device's peak and FLOPs against the card's")
    dryrun_phase(args.seed, zero_counts, read_counts, variant_launches)

    # -- 19. the mesh: a 2 x 2 world of four processes on the card --------------------------
    _phase(f"mesh: {MESH_DATA} x {MESH_MODEL} ranks on the card over Gloo; {MESH_ARCH} at "
           f"published widths, {args.mesh_layers} layers: serve, prefill and train; "
           f"{MESH_MOE_ARCH}'s expert-parallel MoE; hymba-1.5b, whisper-tiny, "
           f"{', '.join(MESH_SMOKE_ARCHS)}; a sharded train state through Shelby")
    zero_counts()  # the ranks count their own launches; the parent makes none here
    mesh = mesh_phase(args.seed, layers=args.mesh_layers)
    path_launches["mesh"] = mesh["launches"]
    variant_launches["mesh"], design_launches["mesh"] = mesh["variants"], mesh["designs"]
    tile_designs["mesh"] = mesh["tile_designs"]
    print(json.dumps({"path": "mesh", "launches": mesh["launches"],
                      "flash_attention_variants": mesh["variants"],
                      "flash_attention_tile_designs": mesh["tile_designs"],
                      "flash_attention_bwd_designs": mesh["designs"]}), flush=True)
    _phase(f"mesh_pod: {' x '.join(map(str, POD_WORLD))} (pod, data, model) ranks on the card "
           f"over Gloo; {MESH_ARCH} at published widths, {args.mesh_layers} layers: serve, "
           f"prefill and train; {MESH_MOE_ARCH}'s MoE over both data axes")
    zero_counts()  # the ranks count their own launches; the parent makes none here
    pod = pod_phase(args.seed, card, layers=args.mesh_layers)
    path_launches["mesh_pod"] = pod["launches"]
    variant_launches["mesh_pod"], design_launches["mesh_pod"] = pod["variants"], pod["designs"]
    tile_designs["mesh_pod"] = pod["tile_designs"]
    print(json.dumps({"path": "mesh_pod", "launches": pod["launches"],
                      "flash_attention_variants": pod["variants"],
                      "flash_attention_tile_designs": pod["tile_designs"],
                      "flash_attention_bwd_designs": pod["designs"]}), flush=True)

    # -- 20. the port's six examples, on the card and on the CPU ------------------------------
    _phase(f"examples: {', '.join(EXAMPLES)} (examples/torch/) on the card, then on the CPU")
    examples_phase(card, zero_counts, read_counts)

    # -- 21. the kernels line and the result ----------------------------------------------
    timed = {
        "gf_matmul": next(r for r in checks if (r["m"], r["k"], r["n"]) == enc_blob),
        "sample_hash": next(r for r in sh_checks if "ms" in r),
        "flash_attention": next(r for r in attn_checks if r["case"] == "serve_decode"),
        "flash_attention_bwd": next(r for r in bwd_checks if "ms" in r),
    }
    errs = {"gf_matmul": max_err, "sample_hash": max(r["max_abs_err"] for r in sh_checks),
            "flash_attention": max(r["max_abs_err"] for r in attn_checks),
            "flash_attention_bwd": max(r["max_abs_err"] for r in bwd_checks)}
    line = []
    for name, (source, replaces) in KERNELS.items():
        row = timed[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in path_launches.values()),
            "launches_by_path": {path: c[name] for path, c in path_launches.items()},
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        if name == "flash_attention":  # device ms above; its kernels and the other cases
            line[-1].update(
                host_ms=row["host_ms"], previous_ms=row["previous_ms"],
                previous_host_ms=row["previous_host_ms"],
                library_host_ms=row["library_host_ms"], variant=row["variant"],
                variant_launches_by_path=variant_launches,
                tile_design_launches_by_path=tile_designs,
                tile_design_launches={d: sum(c.get(d, 0) for c in tile_designs.values())
                                      for d in fa.DESIGNS},
                cases={r["case"]: {key: r.get(key) for key in (
                    "variant", "design", "ms", "host_ms", "previous", "previous_ms",
                    "previous_host_ms", "library_ms", "bound_ms", "bound_by")}
                    for r in attn_checks})
        if name == "flash_attention_bwd":  # device ms above; host ms and the other cases
            line[-1].update(
                host_ms=row["host_ms"], library_host_ms=row["library_host_ms"],
                design_launches_by_path=design_launches,
                max_rel_err=max(r["max_rel_err"] for r in bwd_checks),
                cases={r["case"]: r["max_rel_err"] for r in bwd_checks},
                timed_cases={r["case"]: {key: r[key] for key in (
                    "ms", "host_ms", "library_ms", "plain_ms", "bound_ms", "bound_by")}
                    for r in bwd_checks if "ms" in r})
        if name == "gf_matmul":  # the repair and DAS shapes beside the put's encode
            by_shape = {(r["m"], r["k"], r["n"]): r for r in checks}
            line[-1]["shapes"] = {
                key: {f: by_shape[shape][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for key, shape in timed_shapes.items()
                if key.startswith(("repair", "serve_repair", "das", "engine", "scenario"))}
        if line[-1]["launches"] == 0:
            raise SystemExit(f"{name} was launched on no path")
    print(json.dumps({"total_s": time.perf_counter() - _STARTED}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
