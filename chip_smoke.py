"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each against its plain PyTorch version on the card,
then serves and trains llama3.2-3b at full width with random weights from a
seed (also through a 4-stage pipeline), shards and reshards it, runs the
paper's gradient sync over 16 ranks and the train CLI under torchrun, serves
and trains the MoE moonshot-v1-16b-a3b (also expert-parallel in the model),
the SSM mamba2-130m and the hybrid recurrentgemma-9b (the last two reach no
kernel, in JAX or here), the VLM qwen2-vl-7b and the audio whisper-tiny, then
dry-runs a production cell on fake tensors and holds a dry-run's prediction
against the step it predicts, runs the flow simulator's device backend, and
serves and trains llama3.2-3b tensor-parallel over 16 rank threads, then the
MoE, VLM and audio families in their sharded layouts:

1. device and toolchain: card name and power limit, torch and nvcc versions;
2. build, timed (one nvcc per source, all started together), with ptxas's
   register and spill line for every kernel; then the SASS of the two
   wgmma flash kernels (sm90, tf32), counted by ``cuobjdump`` for HGMMA
   (wgmma) and UTMALDG (TMA loads) instructions;
3. flash attention against its plain version at every shape of the JAX
   package's kernel tests and more (GQA groups 3, 6 and 7, a ragged 1000, a
   window at head_dim 128), fp32 and bf16, through every kernel that takes
   the case (``flash_attention.variant`` picks tf32 for fp32, sm90 for bf16
   at head_dim >= 16 and simt for bf16 at 8; simt takes every case too, for
   the record; and a rank's share of llama3.2-3b's tensor-parallel prefill,
   1 row x 2 kv heads and their 6 q heads, and of its tensor-parallel
   training step, 1 row x 1 kv head and its 3 q heads; the shares of 26:
   moonshot-v1-16b-a3b's 1 row x 4 and 1 x 2 heads, qwen2-vl-7b's 1 row x 1 kv
   head and its 7 q heads, whisper-tiny's 8 rows of 512), each line naming the
   kernel that ran; the tf32 kernel's
   split of K and V against its plain version, bit for bit; at the
   llama3.2-3b prefill shape the bf16 kernels are timed in turns (sm90,
   simt, SDPA) beside the plain version and the bound, with achieved
   TFLOP/s, and again at head_dim 64 (the minicpm-2b widths) and at the
   moonshot-v1-16b-a3b, qwen2-vl-7b and whisper-tiny prefill shapes and at
   the tensor-parallel ranks' shares (1, 2048, 6 / 2, 128), (1, 2048, 3 /
   1, 128), (1, 2048, 4 / 4, 128) and (1, 2048, 7 / 1, 128); in fp32 the same
   at the training shape (batch 2; tf32, simt, SDPA, three rounds), at the
   prefill shape (one round) of llama3.2-3b, moonshot-v1-16b-a3b,
   qwen2-vl-7b and whisper-tiny, and at the ranks' shares (three rounds),
   each with the 3xTF32 bound and the CUDA-core bound; and at moonshot's
   training shape with q scaled to attention scores ~40 and ~450, each fp32
   kernel against the op in fp64, within the plain version's own error + TOL;
4. rmsnorm against its plain version at the shapes of the JAX package's
   kernel tests, at the llama3.2-3b activation shape of the training batch
   (4096, 3072) and at ragged and misaligned shapes, fp32 and bf16, with its
   time, the plain version's, ``F.rms_norm``'s (a yardstick only) and its
   bound, over one buffer and again with the inputs rotated over >= 200 MB
   and every output fresh, so that L2 holds none of them.  No path of the
   model runs it (nor its JAX twin): 0 launches;
5. a full-width bf16 prefill (batch 4, prompt 2048) through
   ``make_prefill_step(use_kernel=True)``, one warm-up call and three timed
   (their median): each launches the flash kernel once a layer, all through
   sm90; in turns with it, for the record, the same prefill with the flash
   op routed to the simt kernel; then one prefill under torch.profiler;
6. the same prefill in fp32 at batch 1 with and without the kernel (tf32);
7. the serving loop of ``repro_torch.launch.serve`` (batch 4, prompt 128,
   32 decoded) in bf16, timed; then the decode loop's last prompt-step
   logits against the prefill step's on the same prompt, held in fp32 and
   measured in bf16;
8. full-width fp32 training (batch 2 x 2048, remat): one loss and gradient
   through the kernel against one through the plain path, beside the fp32
   floor of two plain paths (see FLOOR_CHUNK), then 3 timed
   ``make_train_step`` steps with AdamW through the kernel, which launches
   twice a layer a step (forward and remat recompute), all through tf32;
9. the train driver of ``repro_torch.launch.train`` at smoke width with
   ``--use-kernel`` (fp32, head_dim 16, through tf32): 30 steps,
   checkpoints, a board failure at step 15, remap and restore from step 10;
10. the paper's gradient sync over 16 ranks on this card (a 4x4
   ``LocalMesh``, every rank a thread on cuda:0): each allreduce algorithm,
   the rings over one axis, reduce-scatter + all-gather over 16 ranks and
   ``allreduce_tree`` at one llama3.2-3b layer's gradient a rank (100.7 M
   fp32) against an fp64 sum on the card; every transfer a torus
   neighbour's, the rings by ppermute alone, the Hamiltonian links balanced;
   the bytes a rank and a link carry beside the alpha-beta model; the times
   of the in-process transport (HBM copies, not a network); then the sync
   train step at smoke width through the tf32 kernel against ``sync="auto"``,
   top-k compression's mass conservation, and the train CLI with ``--sync``;
11. moonshot-v1-16b-a3b (the MoE family: 48 layers, 64 experts top-6) at
   full width and depth in bf16, 28.06G parameters: the prefill (batch 4 x
   2048, capacity factor 1.25) through ``make_prefill_step(use_kernel=True)``,
   one warm-up call and three timed, 48 sm90 launches a call; its device time
   by part (routing, slots, scatter, the expert einsums, gather, attention)
   from CUDA events and under the profiler; the serving loop (batch 4, prompt
   128, 32 decoded);
12. the same widths in fp32 at 4 of the 48 layers: the prefill through the
   tf32 kernel against the plain path beside the floor of two plain paths,
   and the decode loop against the prefill at a no-drop capacity factor of
   11, each with the share of (token, choice) pairs whose expert and
   capacity slot agree; then training (batch 2 x 2048, remat): the loss and
   gradient gate against the plain path beside the floor and against a run
   with the flash op in fp64 beside the plain path's distance from it, and 3
   timed AdamW steps with the aux loss, 8 tf32 launches a step;
13. expert parallelism: one moonshot MoE layer in fp32 over a 4-rank
   ``LocalMesh`` on cuda:0 (16 experts a rank, ``Comm.all_to_all``) against
   ``moe_apply``, its all-to-all bytes against the slab sizes; forward only;
14. mamba2-130m (the SSM family: 24 layers, d_model 768, 24 heads of 64,
   state 128, chunk 256; 167.5M parameters) at full width and depth:
   ``ssd_chunked`` on layer 0's own inputs (B 1, S 2048 and a ragged 1000)
   against the recurrence a step at a time in fp64, itself in fp64 (the
   algorithm) and in fp32 (within 2^-23 x the largest cumulative decay, the
   rounding of its decay matrix); the bf16 prefill (batch 4 x 2048, one
   warm-up and three timed calls, profiled) and serving loop; in fp32 the
   decode loop against the prefill beside the floor of ssm_chunk 64 against
   256; fp32 training (batch 2 x 2048, remat, 3 AdamW steps);
15. recurrentgemma-9b (the hybrid family: 12 x (2 RG-LRU + 1 local MQA
   attention, window 2048, head_dim 256) + 2 RG-LRU, d_model 4096; 10.44G
   parameters): the RG-LRU's log-depth scan against its step loop at full
   width (B 1 x 2048 x 4096), forward and gradient in fp64, and in fp32
   against the fp64 loop; bf16 at full width and depth (20.9 GB of weights):
   the prefill and serving loop as for the SSM; fp32 at 5 layers (one block
   and the 2-layer tail, the stacks scaled to the 38-layer init): the decode
   loop against the prefill at a 128-token prompt (floor: chunked against
   dense attention) and past the window (2112 tokens, batch 1), then
   training (batch 2 x 2048, remat, 3 AdamW steps).  Both families take
   ``use_kernel=True`` and ignore it, as JAX's ``**_`` does: every flash and
   RMSNorm count on their paths must be 0;
16. qwen2-vl-7b (the VLM family: 28 layers, d_model 3584, GQA 28 / 4 heads of
   128, a group of 7, d_ff 18944, vocab 152064, M-RoPE sections (16, 24,
   24)) in bf16 at full width and depth: the prefill (batch 4 x 2048) through
   the sm90 kernel, 28 launches a call, at ``make_batch``'s text positions
   (one warm-up and three timed calls, profiled) and once at an image grid
   whose t, h and w differ; the serving loop.  Then fp32 at 8 of its 28
   layers with the 28-layer init's scale: the prefill through the tf32
   kernel against the plain path at both positions, the decode loop against
   the prefill, the training gate (loss and every gradient leaf against the
   plain path beside the floor of two plain paths and against the flash op
   in fp64) and 3 AdamW steps at 2 x 2048, 16 tf32 launches a step;
17. whisper-tiny (the audio family: 4 encoder layers over 1500 frames from
   ``make_batch``, 4 decoder layers with cross-attention, d_model 384, 6
   heads of 64, vocab 51865, learned positions) at full width and depth: the
   bf16 prefill (4 sm90 launches a call; the encoder and the cross-attention
   plain, as in JAX) and the serving loop; in fp32 the prefill gate, the
   decode loop against itself on fp64 weights (its cross-attention reads the
   cache's zero xk/xv, as in JAX, so decode ignores the encoder and is not
   held against the prefill), the training gate and 3 AdamW steps, 8 tf32
   launches a step.  Decode reaches no kernel in either family (it runs
   ``attention_decode``, as JAX does);
18. pipeline parallelism (after 9): first a probe, ``loss.backward()``
   through ``Comm.ppermute``'s backward on 4 rank threads of the card at
   ``check_pipeline_parallel``'s size, which the ranks' shared autograd
   thread deadlocks until the barrier's timeout (recorded, not gated); then
   llama3.2-3b at full width in fp32, PIPE_LAYERS of its 28 layers as 4
   stages on 4 rank threads, 4 microbatches of 1 x 2048 (the embedded tokens),
   through ``make_pipelined_value_and_grad`` with the tf32 kernel in every
   stage: the loss and each stage's gradient leaves against the sequential
   run of the same layers, weights and microbatches within max(FP32_TOL,
   floor), the ppermute bytes forward and backward and the tf32 launches
   asserted exactly, then one timed training step (AdamW on each stage) with
   its peak memory and the bubble's share of the ticks;
19. sharding (after 18): llama3.2-3b in bf16 at 2 of its 28 layers under
   ``default_policy`` and ``sanitize_specs`` on a (4, 4) ``LocalMesh`` of
   cuda:0, every rank's block of every leaf against its slice of the global
   tensor, each rank's bytes; saved, restored on (2, 8), every block again
   bit for bit;
20. the train CLI under ``torchrun --standalone --nproc_per_node 1`` (after
   10): NCCL at world size 1, a ``DistMesh``, 3 steps of ``--sync ring``
   through the tf32 kernel, its checkpoint against the same CLI's in this
   process;
21. expert parallelism in the model: moonshot-v1-16b-a3b with
   ``moe_mode="ep"`` over 4 rank threads of the card, the rank's ``Comm`` as
   ``act_specs["mesh"]``: the bf16 prefill step at full width and depth on
   the weights of 11 (batch 2 x 2048, the config's capacity factor, 192
   sm90 launches a call, its all-to-all bytes against the slab sizes, one
   warm-up and three timed calls); and the fp32 gate on the weights of 12
   (4 layers, batch 1 x 2048, no-drop capacity factor) against
   ``moe_mode="tp"``, tp's routing replayed.  Forward only (the probe of 18);
22. the dry-run (after 17): ``repro_torch.launch.dryrun``'s cell of
   llama3.2-3b train_4k on the single pod at full width (fake tensors on the
   host, rank 0 of 16 x 16 running the tensor-parallel train step), with the
   roofline twin's row; then the dry-run's prediction of the step that runs
   on this card (llama3.2-3b fp32, batch 2 x 2048, remat, the plain
   attention, one rank) against the step itself: its FLOPs equal to
   ``FlopCounterMode``'s count on the card, exactly, and its peak within 10 %
   of ``torch.cuda.max_memory_allocated``; the same for one rank of
   moonshot-v1-16b-a3b's sharded MoE train step (1 layer, B 1 x 256, TP on
   (1, 4): rank 0 a thread on the card, ranks 1-3 threads on the host, so
   that the card holds rank 0 alone); the card's own bf16 GEMM rate and
   HBM copy bandwidth beside the roofline's data-sheet constants;
23. the flow simulator's torch backend (``repro_torch.core.flowsim``), each
   card case timed and its device chunks counted (``flowsim.device_chunks``,
   above 0 or the phase fails), within 1e-5 of its reference on the host: the
   max ECMP link load of uniform all-to-all on the paper's small Hx2Mesh
   (1,024 accelerators, 64 switches; the NumPy engine) and on a
   6,400-accelerator one (the symmetry reduction, exact); on Table II's large
   Hx2Mesh 64 x 64 and Hx4Mesh 32 x 32 (16,384 accelerators each), the card's
   chunked pass over every source against the symmetry reduction; the
   all-to-all fraction of the small Hx2Mesh under ``fail=boards:1%:seed7``, of
   a job's sub-fabric on its 8 x 8 boards (``subnetwork``) and the max load
   of a dragonfly (``build_network(Dragonfly(16, 8, 8, 9))``), against the
   NumPy engine; and sparse demands (``core/traffic.py``:
   ``skewed-alltoall:h8:seed3`` and ``bisection``) at 4,096 accelerators
   through the chunked pass against the NumPy chunked pass;
24. tensor parallelism over ``model`` in serving (``phase_tp_serve``, after
   23): llama3.2-3b at full width and depth, its weights cut into each rank's
   blocks under ``sanitize_specs(param_specs)`` (``shard_tree``; the whole
   copy freed), 16 rank threads of cuda:0, each computing from its blocks:
   the bf16 prefill step on (data, model) = (1, 16), batch 4 x 2048, through
   sm90 (448 launches a call, 28 a rank; one warm-up, three timed), each
   rank's bytes against its blocks' under the specs, ``CommStats`` (psum,
   all_gather and all_to_all calls and input bytes, the all-to-all's sends
   by rank pair) against closed forms from the shapes, GSPMD's collectives
   for the same layer (``benchmarks/gspmd_tp_collectives.py``) printed for
   the record; the bf16 decode loop (TP_PROMPT_BF16 teacher-forced, TP_DECODE
   greedy: 16 rank threads share one GIL) beside the unsharded one, token agreement
   reported; then fp32 through tf32: the TP prefill's last logits on (1, 16)
   and on (2, 8) (FSDP gathers over data) and the decode's prompt steps'
   logits on (1, 16) against the fp64 run of the same weights and tokens,
   within max(FP32_TOL, floor) or no further from it than the unsharded fp32
   step, ``CommStats`` against the closed forms on both.  Forward only (the
   probe of 18);
25. FSDP and tensor parallelism in training (``phase_tp_train``, after 24):
   llama3.2-3b in fp32 at 4 of its 28 layers (the 28-layer init's scale),
   batch 2 x 2048, one AdamW step on 16 rank threads of cuda:0, each on its
   blocks of the weights and moments, through ``make_train_step`` and its
   cut route (``make_tp_value_and_grad``: every collective's autograd
   function is made to raise) and the tf32 kernel, 128 launches a step: on
   (data, model) = (1, 16), (2, 8) and (2, 8) with ``sync="ring"``, the
   loss, ``grad_norm``, every leaf's clipped gradient and the updated
   parameters against the unsharded model in fp64, the ring run against
   the auto run too, ``CommStats`` against closed forms; then llama3.2-3b
   whole on (2, 8), one step (896 launches), its seconds and peak memory,
   its loss against the unsharded step's of 8;
26. the sharded layout of the MoE, VLM and audio families
   (``phase_tp_families``, after 25), on 16 rank threads of cuda:0:
   moonshot-v1-16b-a3b TP over ``model`` (experts split on d_ff) in fp32 at
   the 48-layer init's scale: the prefill gate at 4 layers (4 x 2048; (1, 16),
   (2, 8)) and the training gate at 1 (2 x 2048; (1, 16), (2, 8), ring (2, 8))
   against fp64 with its routing replayed, then bf16 at 12 of 48 layers: the TP
   prefill (192 sm90 launches a call) and a few decode steps; qwen2-vl-7b at an image grid's M-RoPE
   positions, bf16 at 14 of 28 layers on the pair (B 4) and gather (B 2) routes, fp32 at 4
   layers: the prefill and training gates; whisper-tiny whole under its
   ``default_policy`` (``tp=False``) and ``layout="fsdp"`` on (2, 8), 16 x
   512: the prefill and training gates.  Gates as 25's, launches and
   ``CommStats`` against closed forms (``_fam_closed_forms``).  The fifteenth
   slice adds moonshot with its experts split on E over ``model``
   (``moe_mode`` "gshard" and "ep"): fp32 prefill and decode gates at 4 layers
   on (1, 16) and (2, 8) (64 tf32 launches a prefill), training gates at 1
   layer on both (EP's fp64 runs route the whole batch as one group, as its
   ranks do together), bf16 at 12 of 48 layers on (2, 8), reported;
   and llama3.2-3b at 4 layers trained with
   ``ce_chunk`` 512 against the same step without it (loss and leaves within
   the gate, a lower peak up to the gradient); whisper-tiny under
   ``Policy()`` (fp32 prefill gates on the pair route, 16 x 512 on (1, 16), and
   the gather route, 4 x 512 on (2, 8), 64 tf32 launches each; the decode
   gate on (1, 16) against the fp64 decode loop; the training gate at 2 x
   2048 on both meshes, 128 tf32 launches a step; the bf16 prefill, 64 sm90
   launches, reported); then ``phase_tp_recurrent`` (the hybrid, and mamba2-130m
   under its ``tp=False`` layouts and under ``Policy()``: prefill gates at 16 x
   512 on (1, 16) and (2, 8), the decode gate on (1, 16), the training gate at
   2 x 2048 on both; no launch);
27. one JSON line on every kernel (launches by path, the MoE, SSM, hybrid,
   VLM, audio, pipeline, EP, TP and sharded-family paths included), one each
   on the sync, MoE, SSM, hybrid, VLM, audio, pipeline, EP-model, sharding,
   torchrun, dry-run, flow-simulator, TP-serving, TP-training and
   sharded-family phases, the card's name and power limit, and last the JSON
   result line.

Any failure raises and exits nonzero; without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense), for the bound.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_FLOPS_TF32 = 495e12  # the tf32 kernel does three TF32 products for each fp32 one
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # those of tests/test_kernels.py
# (b, sq, sk, h, kv, d, causal, window): the shapes of tests/test_kernels.py CASES,
# then a few more
CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 4, 1, 64, False, 0),
    (1, 256, 256, 8, 2, 32, True, 64),
    (1, 200, 200, 2, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 128, True, 0),
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 2, 1, 64, False, 32),
    # head_dim 16 and 8 of the smoke archs, ragged lengths, Sq > Sk (every
    # row keeps a key: rows with none have no defined answer, the JAX kernel's
    # and its reference's differ there)
    (2, 70, 70, 4, 2, 16, True, 0),
    (1, 33, 33, 2, 1, 8, True, 0),
    (1, 100, 60, 4, 2, 32, True, 0),
    (1, 96, 200, 4, 2, 64, True, 48),
    # GQA groups 3 and 6, a ragged long sequence, a window at head_dim 128
    (1, 256, 256, 6, 2, 128, True, 0),
    (1, 192, 192, 12, 2, 64, True, 0),
    (1, 1000, 1000, 8, 2, 128, True, 0),
    (2, 512, 512, 8, 8, 128, True, 200),
    # the smoke model's attention in the sync train steps: B 4 a rank on the
    # "data" mesh (ring, bidir), B 1 on the 4x4 one (torus, hamiltonian)
    (4, 64, 64, 4, 2, 16, True, 0),
    (1, 64, 64, 4, 2, 16, True, 0),
    # qwen2-vl-7b's GQA group of 7 (H 28, KV 4) at D 128 and 64, ragged; whisper-tiny's
    # decoder heads (H 6, KV 6, D 64), ragged and at its training batch (B 2 x 2048)
    (1, 256, 256, 7, 1, 128, True, 0),
    (2, 200, 200, 14, 2, 64, True, 0),
    (1, 300, 300, 6, 6, 64, True, 0),
    (2, 2048, 2048, 6, 6, 64, True, 0),
    # a rank's share of llama3.2-3b's prefill under tensor parallelism over 16 ranks
    # (phase_tp_serve): 1 row x 2 kv heads and their 6 q heads
    (1, 2048, 2048, 6, 2, 128, True, 0),
    # a rank's share of llama3.2-3b's training step under tensor parallelism
    # (phase_tp_train): 1 row x 1 kv head and its 3 q heads, on (1, 16) and (2, 8)
    (1, 2048, 2048, 3, 1, 128, True, 0),
    # the ranks' shares of phase_tp_families: moonshot-v1-16b-a3b's prefill (1 row x 4
    # heads, MHA) and training step (1 row x 2), qwen2-vl-7b's prefill (1 row x 1 kv
    # head and its 7 q heads), whisper-tiny's 8 rows of 512 under default_policy
    (1, 2048, 2048, 4, 4, 128, True, 0),
    (1, 2048, 2048, 2, 2, 128, True, 0),
    (1, 2048, 2048, 7, 1, 128, True, 0),
    (8, 512, 512, 6, 6, 64, True, 0),
]
# the prefill shape of llama3.2-3b at head_dim 128, of minicpm-2b at 64, of
# moonshot-v1-16b-a3b (MHA, 16 heads of 128), of qwen2-vl-7b (GQA group 7) and of
# whisper-tiny's decoder (6 heads of 64), then TP ranks' shares (whisper-tiny's on
# the pair route at 16 x 512 over 16 ranks): (b, s, h, kv, d), causal
PREFILL_SHAPES = {"d128": (4, 2048, 24, 8, 128), "d64": (4, 2048, 36, 36, 64),
                  "moonshot": (4, 2048, 16, 16, 128), "vlm": (4, 2048, 28, 4, 128),
                  "audio": (4, 2048, 6, 6, 64), "tp": (1, 2048, 6, 2, 128),
                  "tp_train": (1, 2048, 3, 1, 128), "tp_moe": (1, 2048, 4, 4, 128),
                  "tp_vlm": (1, 2048, 7, 1, 128), "tp_audio": (1, 512, 6, 6, 64)}
PREFILL_BATCH, PREFILL_LEN = 4, 2048
# the fp32 shapes, (tag, (b, s, h, kv, d), timing rounds), causal: the training
# and prefill shapes of llama3.2-3b, then of moonshot-v1-16b-a3b, qwen2-vl-7b and
# whisper-tiny
FP32_SHAPES = [("train_fp32", (2, 2048, 24, 8, 128), 3),
               ("prefill_d128_fp32", (4, 2048, 24, 8, 128), 1),
               ("train_moe_fp32", (2, 2048, 16, 16, 128), 3),
               ("prefill_moe_fp32", (4, 2048, 16, 16, 128), 1),
               ("train_vlm_fp32", (2, 2048, 28, 4, 128), 3),
               ("prefill_vlm_fp32", (4, 2048, 28, 4, 128), 1),
               ("train_audio_fp32", (2, 2048, 6, 6, 64), 3),
               ("prefill_audio_fp32", (4, 2048, 6, 6, 64), 1),
               ("prefill_tp_fp32", (1, 2048, 6, 2, 128), 3),
               ("train_tp_fp32", (1, 2048, 3, 1, 128), 3),
               ("prefill_tp_moe_fp32", (1, 2048, 4, 4, 128), 3),
               ("train_tp_moe_fp32", (1, 2048, 2, 2, 128), 3),
               ("prefill_tp_vlm_fp32", (1, 2048, 7, 1, 128), 3),
               # whisper-tiny's TP prefill shares (phase_tp_families): 1 row x 6 heads
               # on the pair route, 2 rows x 6 on the gather route; its TP training
               # share is train_audio_fp32's (2 rows x 6, the gather route)
               ("prefill_tp_audio_fp32", (1, 512, 6, 6, 64), 3),
               ("prefill_tp_audio_gather_fp32", (2, 512, 6, 6, 64), 3)]
# q's scale in the large-score checks (mean row max scores ~40 and ~450), at the
# training shapes of moonshot-v1-16b-a3b and whisper-tiny
LARGE_SCORE_Q_SCALES = (12.0, 143.0)
LARGE_SCORE_SHAPES = ("train_moe_fp32", "train_audio_fp32")
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 128, 32
# Relative L2 error of fp32 logits between two paths of the full model (the
# prefill with and without the kernel; the decode loop and the prefill): both
# sum in fp32, in different orders, through 28 layers.
FP32_TOL = 1e-3
# rmsnorm: tests/test_kernels.py's tolerances (rtol = atol) and shapes, then
# the activation shape of the training batch, ragged rows and widths, and an
# input 4 bytes off a 16-byte boundary (the kernel's element-wise path)
RMS_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
RMS_CASES = [
    ((4, 128), torch.float32),
    ((2, 200, 64), torch.float32),
    ((1, 64, 256), torch.bfloat16),
]
RMS_MORE = [(4096, 3072), (333, 200), (7, 77), (3, 1000)]
RMS_ROTATE_BYTES = 200e6  # the rotated timing's inputs and outputs, at least, in all
# Training: batch 2 x 2048 of llama3.2-3b in fp32; the kernel-vs-plain gate.
# The loss is held to LOSS_RTOL and the global gradient norm to GRAD_RTOL,
# relative.  Each leaf's gradient is held to a relative L2 of GRAD_RTOL, or
# to the fp32 floor of the model where that is larger: the difference, in the
# same run, between two plain paths that differ only in summation order (the
# dense attention and the JAX package's chunked online-softmax attention with
# chunks of FLOOR_CHUNK keys).  The init's attention scores of order 100 make
# the softmax nearly one-hot, so the backward pass through 28 layers
# amplifies fp32 rounding: on the H100 the two plain paths differ by ~2.5e-2
# per layer-stacked leaf, the kernel and the dense path by ~5e-3.
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 2, 2048, 3
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
FLOOR_CHUNK = 256


_START = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout; its seconds since the script began, and its start, on
    stderr (where the time goes, line by line)."""
    print(msg, flush=True)
    print(f"{time.perf_counter() - _START:8.1f} {msg[:100]}", file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` in ms, replaying a CUDA graph of ``reps`` calls.

    For kernels of a few microseconds, whose eager launches from Python leave
    the card idle between them: the graph replays the launches back to back.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def rotating_ms(op, inputs, reps: int = 20) -> float:
    """``graph_ms`` of ``op`` on ``inputs`` taken in turn, every output kept (a fresh
    buffer each call): with the inputs and outputs between two uses of one buffer
    over the 50 MB L2, no call finds its data there."""
    turn, outputs = itertools.cycle(inputs), []
    return graph_ms(lambda: outputs.append(op(next(turn))), reps)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _demangle(names: list[str]) -> dict[str, str]:
    """Short readable names of kernels (``flash_fwd_sm90<128>``), by c++filt if present."""
    out = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        for mangled, full in zip(names, plain):
            out[mangled] = full.split("::")[-1].split("(")[0]
    return out


def _ptxas_report(text: str) -> dict[str, list[str]]:
    """ptxas -v lines on registers and spills, by entry function."""
    rows, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            rows.setdefault(name, [])
        elif name and ("registers" in line or "spill" in line):
            rows[name].append(line.replace("ptxas info    :", "").strip())
    return rows


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(_build.sources())} source(s), {len(logs)} compiled in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR.relative_to(ROOT)}")
    for source, text in logs.items():
        report = _ptxas_report(text)
        names = _demangle(list(report))
        for fn, lines in report.items():
            log(f"[build] {source}: {names[fn]}: {'; '.join(lines)}")
        for line in text.splitlines():
            if "warning" in line.lower():
                log(f"[build] {source}: {line.strip()}")


def phase_sass() -> dict:
    """HGMMA and UTMALDG instructions in the SASS of the built wgmma flash kernels."""
    from repro_torch.kernels import flash_attention as fa

    return {name: _sass_counts(fa.SOURCES[name]) for name in ("sm90", "tf32")}


def _sass_counts(source: str) -> dict:
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    lib = _build.library_path(source)
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, per_fn, fn = {"HGMMA": 0, "UTMALDG": 0}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            per_fn[fn] = dict.fromkeys(counts, 0)
        for op in counts:
            if re.search(rf"\b{op}\b", line):
                counts[op] += 1
                if fn:
                    per_fn[fn][op] += 1
    names = _demangle(list(per_fn))
    log(f"[sass] {lib.name}: HGMMA {counts['HGMMA']}, UTMALDG {counts['UTMALDG']}; "
        + "; ".join(f"{names[f]}: {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG"
                    for f, c in per_fn.items()))
    if not all(counts.values()):
        raise AssertionError(f"{lib.name}'s SASS lacks wgmma or TMA loads: {counts}")
    return counts


def _qkv(b, sq, sk, h, kv, d, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)


def _attention_bound(q, k, v, causal, window, tf32=False) -> tuple[float, str, float]:
    """Least time for the work these inputs need (unmasked (q, k) pairs and bytes), its
    limit, and the operations themselves.  ``tf32``: fp32 work as three TF32 products
    at the TF32 peak (the tf32 kernel's route), else one at the peak of q's type."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qpos = torch.arange(sq, device="cuda")[:, None]
    kpos = torch.arange(sk, device="cuda")[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    flops = 4.0 * b * h * d * int(keep.sum())  # q·k and p·v, 2 flops a multiply-add
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()  # q, k, v in; o out
    t_ops = (3 * flops / PEAK_FLOPS_TF32 if tf32 else flops / PEAK_FLOPS[q.dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _kernels_for(dtype, d) -> list[str]:
    """Every flash kernel that takes (dtype, d): the one ``variant`` picks, then simt
    (which takes every case)."""
    from repro_torch.kernels import flash_attention as fa

    chosen = fa.variant(dtype, d)
    return [chosen] if chosen == "simt" else [chosen, "simt"]


def _flash_check(q, k, v, causal, window, kernel, label) -> float:
    """max_abs_err of one kernel against the plain version; raises over TOL."""
    from repro_torch.kernels import flash_attention as fa

    got = fa.launch(q, k, v, causal, window, kernel=kernel)
    want = fa.plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[q.dtype]
    if (err > tol * (1 + want.float().abs())).any():
        raise AssertionError(f"flash attention {label} {q.dtype} via {kernel}: max_abs_err "
                             f"{float(err.max()):.3e} over tolerance {tol}")
    return float(err.max())


def _split_check(k, v) -> None:
    """The tf32 kernel's split of K and V (its first launch) against its plain
    version, bit for bit: both round with cvt.rna's rule."""
    from repro_torch.kernels import flash_attention as fa

    b, sk, kv, d = k.shape
    want = fa.split_kv(k, v)
    got = [torch.full_like(w, float("nan")) for w in want]
    err = fa._entry("tf32_split")(k.data_ptr(), v.data_ptr(), *(g.data_ptr() for g in got),
                                  b, sk, kv, d, want[2].shape[-1],
                                  torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"tf32 split_kv at k {tuple(k.shape)}: error {err} or parts "
                             "differ from the plain split")


def _time_flash(q, k, v, kernels, rounds=3) -> dict:
    """Times of the named kernels and SDPA at one causal shape, taken in turns
    (kernel by kernel, then again), with the plain version's and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    want = fa.plain(q, k, v, True, 0)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    if (sdpa.transpose(1, 2).float() - want.float()).abs().max() > 10 * TOL[q.dtype]:
        raise AssertionError("SDPA yardstick does not compute the same function")
    del want, sdpa
    fns = {name: functools.partial(fa.launch, q, k, v, True, 0, kernel=name) for name in kernels}
    fns["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True)
    turns = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            turns[name].append(cuda_ms(fn))
    bound_ms, bound_by, flops = _attention_bound(q, k, v, True, 0)
    r = {name: sorted(ts)[len(ts) // 2] for name, ts in turns.items()}
    r.update(plain_ms=cuda_ms(lambda: fa.plain(q, k, v, True, 0), reps=5), bound_ms=bound_ms,
             bound_by=bound_by, flops=flops, turns=turns)
    if "tf32" in kernels:
        r["bound_ms_tf32"], r["bound_by_tf32"], _ = _attention_bound(q, k, v, True, 0, tf32=True)
    return r


def _large_score_checks(gen) -> dict:
    """Each fp32 kernel at the moonshot training shape (D 128) and at whisper-tiny's
    (D 64, whose reference init gives scores of ~100) with q scaled so that the
    scores reach those of the MoE fp32 phases' init (~40) and of a 4-layer stack
    drawn with fan-in 4 (~450).  There fp32 rounding of the scores alone moves
    the output by more than TOL, in the plain version too, so each kernel is held
    against the flash op in fp64: its max_abs_err within TOL of the plain fp32
    version's own.  The plain chunked attention (the model gates' floor) is
    reported beside them."""
    out = {"tf32": {}, "simt": {}}
    for tag in LARGE_SCORE_SHAPES:
        shape = next(shape for t, shape, _ in FP32_SHAPES if t == tag)
        for name, res in _large_score_check(gen, shape).items():
            out[name][tag] = res
    return out


def _large_score_check(gen, shape) -> dict:
    """The large-score checks of ``_large_score_checks`` at one (b, s, h, kv, d)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    b, s, h, kv, d = shape
    q0, k, v = _qkv(b, s, s, h, kv, d, torch.float32, gen)
    out = {"tf32": {}, "simt": {}}
    for scale in LARGE_SCORE_Q_SCALES:
        q = q0 * scale
        causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        scores = torch.einsum("qhd,khd->hqk", q[0, :, :4], k[0, :, :4]) / math.sqrt(d)
        row_max = float(scores.masked_fill(~causal, -math.inf).amax(-1).mean())
        del scores, causal
        exact = _attention_fp64(q, k, v)
        paths = {"plain": fa.plain(q, k, v, True, 0),
                 "chunked": layers.attention_chunked(q, k, v, True, 0, chunk=FLOOR_CHUNK)}
        paths.update({name: fa.launch(q, k, v, True, 0, kernel=name) for name in out})
        torch.cuda.synchronize()
        err = {n: float((y - exact).abs().max()) for n, y in paths.items()}
        l2 = {n: rel_l2(y, exact) for n, y in paths.items()}
        vs_plain = {n: float((paths[n] - paths["plain"]).abs().max())
                    for n in ("chunked", *out)}
        log(f"[kernel] flash large scores, q x {scale} (mean row max score {row_max:.1f}), "
            f"B={b} S={s} H={h} KV={kv} D={d} causal fp32, against fp64: "
            + ", ".join(f"{n} max_abs_err {err[n]:.3e} rel_l2 {l2[n]:.3e}" for n in paths)
            + "; against plain: " + ", ".join(f"{n} {e:.3e}" for n, e in vs_plain.items())
            + f"; tol plain's {err['plain']:.3e} + {TOL[torch.float32]}")
        for name in out:
            out[name][f"q_x{scale:g}"] = {
                "row_max_score": row_max, "max_abs_err_vs_fp64": err[name],
                "plain_max_abs_err_vs_fp64": err["plain"],
                "chunked_max_abs_err_vs_fp64": err["chunked"], "rel_l2_vs_fp64": l2[name],
                "plain_rel_l2_vs_fp64": l2["plain"], "max_abs_err_vs_plain": vs_plain[name]}
            if not err[name] <= err["plain"] + TOL[torch.float32]:
                raise AssertionError(
                    f"flash via {name} at scores ~{row_max:.0f}: max_abs_err {err[name]:.3e} "
                    f"against fp64, over the plain version's {err['plain']:.3e} + "
                    f"{TOL[torch.float32]}")
        del q, exact, paths
        torch.cuda.empty_cache()
    return out


def phase_kernel_checks() -> dict:
    """Every flash kernel against the plain version, then the timings; returns, per
    kernel, its numbers at the shape of its main path."""
    gen = torch.Generator("cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in CASES:
            *shape, causal, window = case
            q, k, v = _qkv(*shape, dtype, gen)
            if dtype == torch.float32:
                _split_check(k, v)
            errs = {name: _flash_check(q, k, v, causal, window, name, str(case))
                    for name in _kernels_for(dtype, shape[-1])}
            for name, err in errs.items():
                worst[name, dtype] = max(worst.get((name, dtype), 0.0), err)
            log(f"[kernel] flash {case} {dtype}: "
                + ", ".join(f"{name} max_abs_err {err:.3e}" for name, err in errs.items()))
    for (name, dtype), err in sorted(worst.items(), key=str):
        log(f"[kernel] flash via {name} {dtype}: every case within {TOL[dtype]} (max_abs_err "
            f"{err:.3e})")

    out = {"tf32": {}, "sm90": {}, "simt": {}}
    for tag, (b, s, h, kv, d) in PREFILL_SHAPES.items():
        q, k, v = _qkv(b, s, s, h, kv, d, torch.bfloat16, gen)
        errs = {name: _flash_check(q, k, v, True, 0, name, f"prefill shape {tag}")
                for name in ("sm90", "simt")}
        r = _time_flash(q, k, v, ("sm90", "simt"))
        log(f"[kernel] flash prefill shape B={b} S={s} H={h} KV={kv} D={d} causal bf16: "
            f"sm90 {r['sm90']:.4f} ms ({r['flops'] / r['sm90'] / 1e9:.0f} TFLOP/s), simt "
            f"{r['simt']:.4f} ms ({r['flops'] / r['simt'] / 1e9:.1f} TFLOP/s), SDPA "
            f"{r['sdpa']:.4f} ms ({r['flops'] / r['sdpa'] / 1e9:.0f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"sm90/SDPA {r['sm90'] / r['sdpa']:.2f}; max_abs_err sm90 {errs['sm90']:.3e}, "
            f"simt {errs['simt']:.3e}; turns {json.dumps(r['turns'])}")
        for name in ("sm90", "simt"):
            out[name][f"prefill_{tag}_bf16"] = {
                "max_abs_err": errs[name], "ms": r[name], "plain_ms": r["plain_ms"],
                "library_ms": r["sdpa"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "tflops": r["flops"] / r[name] / 1e9}
        del q, k, v
        torch.cuda.empty_cache()

    # fp32: each training shape (batch 2), as the training step calls it, then each
    # prefill shape; tf32 (the main path) and simt in turns with SDPA
    for tag, (b, s, h, kv, d), rounds in FP32_SHAPES:
        q, k, v = _qkv(b, s, s, h, kv, d, torch.float32, gen)
        _split_check(k, v)
        errs = {name: _flash_check(q, k, v, True, 0, name, tag) for name in ("tf32", "simt")}
        r = _time_flash(q, k, v, ("tf32", "simt"), rounds=rounds)
        for name in ("tf32", "simt"):
            tf32 = name == "tf32"
            out[name][tag] = {
                "max_abs_err": errs[name], "ms": r[name], "plain_ms": r["plain_ms"],
                "library_ms": r["sdpa"],
                "bound_ms": r["bound_ms_tf32"] if tf32 else r["bound_ms"],
                "bound_by": r["bound_by_tf32"] if tf32 else r["bound_by"],
                "bound_ms_3xtf32": r["bound_ms_tf32"], "bound_ms_cuda_cores": r["bound_ms"],
                "tflops": r["flops"] / r[name] / 1e9}
        log(f"[kernel] flash {tag} B={b} S={s} H={h} KV={kv} D={d} causal fp32: tf32 "
            f"{r['tf32']:.4f} ms ({r['flops'] / r['tf32'] / 1e9:.1f} TFLOP/s fp32-accurate), "
            f"simt {r['simt']:.4f} ms ({r['flops'] / r['simt'] / 1e9:.1f} TFLOP/s), SDPA "
            f"{r['sdpa']:.4f} ms, plain {r['plain_ms']:.4f} ms; bound 3xTF32 "
            f"{r['bound_ms_tf32']:.4f} ms ({r['bound_by_tf32']}), CUDA cores "
            f"{r['bound_ms']:.4f} ms; tf32 at {r['bound_ms_tf32'] / r['tf32']:.1%} of its "
            f"bound, {r['simt'] / r['tf32']:.2f}x faster than simt, {r['sdpa'] / r['tf32']:.2f}x "
            f"SDPA; max_abs_err tf32 {errs['tf32']:.3e}, simt {errs['simt']:.3e}; turns "
            f"{json.dumps(r['turns'])}")
        del q, k, v
        torch.cuda.empty_cache()
    for name, res in _large_score_checks(gen).items():
        out[name]["large_scores"] = res
    out["tf32"]["cases_max_abs_err"] = worst["tf32", torch.float32]
    out["sm90"]["cases_max_abs_err"] = worst["sm90", torch.bfloat16]
    out["simt"]["cases_max_abs_err"] = {str(dt).removeprefix("torch."): worst["simt", dt]
                                        for dt in (torch.float32, torch.bfloat16)}
    return out


def _rms_input(shape, dtype, gen, misaligned=False):
    n = math.prod(shape)
    flat = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
    x = (flat[1:] if misaligned else flat[:n]).view(shape)
    g = torch.randn(shape[-1], generator=gen, device="cuda") * 0.1
    return x, g


def _rms_check(x, g, label):
    from repro_torch.kernels import rmsnorm as rms

    got = rms.rmsnorm(x, g)
    want = rms.plain(x, g)
    torch.cuda.synchronize()
    if got.dtype != x.dtype or got.shape != x.shape:
        raise AssertionError(f"rmsnorm {label}: got {got.dtype} {tuple(got.shape)}")
    tol = RMS_TOL[x.dtype]
    err = (got.float() - want.float()).abs()
    if (err > tol * (1 + want.float().abs())).any():
        raise AssertionError(f"rmsnorm {label}: max_abs_err {float(err.max()):.3e} over "
                             f"tolerance {tol}")
    return float(err.max())


def phase_rmsnorm_checks() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator("cuda").manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for shape, dtype in RMS_CASES:
        worst[dtype] = max(worst[dtype], _rms_check(*_rms_input(shape, dtype, gen),
                                                    f"{shape} {dtype}"))
        n += 1
    for shape in RMS_MORE:
        for dtype in (torch.float32, torch.bfloat16):
            for misaligned in (False, True):
                x, g = _rms_input(shape, dtype, gen, misaligned)
                worst[dtype] = max(worst[dtype], _rms_check(
                    x, g, f"{shape} {dtype} misaligned={misaligned}"))
                n += 1
    log(f"[kernel] rmsnorm: {n} shapes within {RMS_TOL[torch.float32]} (fp32, max_abs_err "
        f"{worst[torch.float32]:.3e}) and {RMS_TOL[torch.bfloat16]} (bf16, max_abs_err "
        f"{worst[torch.bfloat16]:.3e})")

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, g = _rms_input(RMS_MORE[0], dtype, gen)
        err = _rms_check(x, g, f"{RMS_MORE[0]} {dtype}")
        w = (1.0 + g).to(dtype)
        d = x.shape[-1]
        lib = F.rms_norm(x, (d,), weight=w, eps=1e-6)
        if (lib.float() - rms.plain(x, g).float()).abs().max() > 5 * RMS_TOL[dtype] * (
                1 + float(x.float().abs().max())):
            raise AssertionError("F.rms_norm yardstick does not compute the same function")
        nbytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 4.0 * x.numel() / PEAK_FLOPS[torch.float32] * 1e3  # fp32 math on CUDA cores
        r = {
            "max_abs_err": err,
            "ms": graph_ms(lambda: rms.rmsnorm(x, g)),
            "plain_ms": graph_ms(lambda: rms.plain(x, g)),
            "library_ms": graph_ms(lambda: F.rms_norm(x, (d,), weight=w, eps=1e-6)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ms_eager": cuda_ms(lambda: rms.rmsnorm(x, g), reps=50),
        }
        # again over enough inputs and outputs that none stays in L2
        pairs = math.ceil(RMS_ROTATE_BYTES / (2 * x.numel() * x.element_size())) + 1
        xs = [x] + [_rms_input(RMS_MORE[0], dtype, gen)[0] for _ in range(pairs - 1)]
        r["rotating_pairs"] = pairs
        r["ms_rotating"] = rotating_ms(lambda xi: rms.rmsnorm(xi, g), xs)
        r["library_ms_rotating"] = rotating_ms(
            lambda xi: F.rms_norm(xi, (d,), weight=w, eps=1e-6), xs)
        del xs
        log(f"[kernel] rmsnorm {tuple(x.shape)} {dtype}: max_abs_err {err:.3e} kernel_ms "
            f"{r['ms']:.4f} (eager launches {r['ms_eager']:.4f}) plain_ms {r['plain_ms']:.4f} "
            f"library_ms(F.rms_norm) {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}: {nbytes / 1e6:.1f} MB); rotated over {pairs} inputs and fresh "
            f"outputs: kernel_ms {r['ms_rotating']:.4f} library_ms {r['library_ms_rotating']:.4f}; "
            f"kernel/F.rms_norm {r['ms'] / r['library_ms']:.3f} (one buffer), "
            f"{r['ms_rotating'] / r['library_ms_rotating']:.3f} (rotated); "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound (one buffer), "
            f"{r['bound_ms'] / r['ms_rotating']:.1%} (rotated)")
        results[dtype] = r
        del x, g, w, lib
    torch.cuda.empty_cache()
    return {**results[torch.bfloat16], "fp32": results[torch.float32]}


def _prefill(cfg, params, tokens, use_kernel: bool, extras=None):
    """The prefill step's last-position logits and its seconds; ``extras`` holds the
    batch's other inputs (the VLM's positions, the audio family's frames)."""
    from repro_torch.train.steps import TrainOptions, make_prefill_step

    step = make_prefill_step(cfg, TrainOptions(use_kernel=use_kernel))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens, **(extras or {})})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def _reset_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    fa.launches = 0
    fa.launches_by_variant = dict.fromkeys(fa.SOURCES, 0)
    rms.launches = 0


def _counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    return {"flash_attention_fwd": fa.launches, **{f"flash_attention_fwd_{name}": n for name, n
                                                   in fa.launches_by_variant.items()},
            "rmsnorm": rms.launches}


def phase_prefill(cfg, params, smi) -> dict:
    """bf16 prefills, in turns through the sm90 kernel (the main path) and, for the
    record, through the SIMT kernel: one warm-up call each, then three timed rounds;
    every call launches its kernel once a layer.  Then one prefill under the profiler."""
    from unittest import mock

    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as fa

    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)["tokens"]).cuda()
    routes = {"sm90": contextlib.nullcontext,
              "simt": lambda: mock.patch.object(fa, "variant", lambda dtype, d: "simt")}
    torch.cuda.reset_peak_memory_stats()
    secs, launches = {name: [] for name in routes}, {}
    for _ in range(4):
        for name, route in routes.items():
            _reset_counts()
            with route():
                logits, t = _prefill(cfg, params, tokens, use_kernel=True)
            launches[name] = _counts()
            want = {"flash_attention_fwd": cfg.n_layers, "rmsnorm": 0,
                    **{f"flash_attention_fwd_{v}": cfg.n_layers * (v == name)
                       for v in fa.SOURCES}}
            if launches[name] != want:
                raise AssertionError(f"prefill through {name} launched {launches[name]}, want "
                                     f"{want}")
            if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
                raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or "
                                     "misshapen")
            secs[name].append(t)
    ntok = PREFILL_BATCH * PREFILL_LEN
    median = {name: sorted(ts[1:])[1] for name, ts in secs.items()}
    log(f"[prefill] {cfg.name} bf16 batch {PREFILL_BATCH} x {PREFILL_LEN} through the sm90 "
        f"kernel: {median['sm90']:.3f}s median of 3 after a warm-up "
        f"({ntok / median['sm90']:.0f} tok/s; calls {[round(x, 3) for x in secs['sm90']]} s), "
        f"launches a call {launches['sm90']}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{smi}]")
    log(f"[prefill] the same through the simt kernel, in turns, for the record: "
        f"{median['simt']:.3f}s ({ntok / median['simt']:.0f} tok/s; calls "
        f"{[round(x, 3) for x in secs['simt']]} s), launches a call {launches['simt']}")
    _profile("one bf16 prefill", lambda: _prefill(cfg, params, tokens, use_kernel=True))
    return launches["sm90"]


def phase_e2e_fp32(cfg):
    """fp32 prefill with the kernel against the plain path; returns the fp32 weights."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import get_model

    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, 1)["tokens"]).cuda()
    _reset_counts()
    with_k, t_k = _prefill(cfg, params, tokens, use_kernel=True)
    launches = _counts()
    plain, t_p = _prefill(cfg, params, tokens, use_kernel=False)
    err = rel_l2(with_k, plain)
    same_top = bool((with_k.argmax(-1) == plain.argmax(-1)).all())
    log(f"[e2e] {cfg.name} fp32 batch 1 x {PREFILL_LEN}: kernel vs plain logits rel_l2 "
        f"{err:.3e} (tol {FP32_TOL}), max_abs_err "
        f"{float((with_k - plain).abs().max()):.3e}, max|logit| "
        f"{float(plain.abs().max()):.3e}, same argmax {same_top}; "
        f"{t_k:.3f}s with kernel, {t_p:.3f}s plain; launches with kernel {launches}")
    if not (err <= FP32_TOL and torch.isfinite(with_k).all()):
        raise AssertionError(f"fp32 prefill with kernel disagrees with plain: rel_l2 {err:.3e}")
    if launches["flash_attention_fwd_tf32"] != cfg.n_layers:
        raise AssertionError(f"fp32 prefill launched {launches}, want {cfg.n_layers} tf32")
    return params


def _decode_prompt(cfg, params, prompts):
    """Logits of the last prompt step, teacher-forcing ``prompts`` through decode_step."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    cache = model.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                             dtype=params["embed"].dtype, device="cuda")
    with torch.no_grad():
        for t in range(prompts.shape[1]):
            logits, cache = model.decode_step(cfg, params, cache, prompts[:, t:t + 1])
    return logits


def phase_serve(cfg, params, params32, smi) -> None:
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import serve

    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    res = serve(cfg, params, prompts, SERVE_DECODE)
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_DECODE) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"serve returned bad tokens {tuple(toks.shape)}")
    log(f"[serve] {cfg.name} bf16 batch {SERVE_BATCH}: prompt {SERVE_PROMPT} teacher-forced in "
        f"{res['prefill_s']:.3f}s ({SERVE_BATCH * SERVE_PROMPT / res['prefill_s']:.1f} tok/s); "
        f"decoded {SERVE_DECODE} toks/seq in {res['decode_s']:.3f}s "
        f"({SERVE_BATCH * SERVE_DECODE / res['decode_s']:.1f} tok/s) [{smi}]")
    log(f"[serve] sample continuation: {toks[0, :16].tolist()}")

    # The relation of test_decode_matches_forward: the decode loop's logits at
    # the last prompt step against the prefill step's on the same prompt.
    # Held in fp32, where it tests the algorithm.  In bf16 it is measured
    # beside the bf16 noise of the model, the prefill with the kernel against
    # the plain prefill: dense_init's fan-in of L gives attention scores of
    # order 100, which the plain and decode paths round to bf16 (an ulp of
    # 0.5 there), so bf16 paths that round at different places disagree far
    # more than fp32 ones (ROADMAP Queue C).
    dec32 = _decode_prompt(cfg, params32, prompts)
    pre32, _ = _prefill(cfg, params32, prompts, use_kernel=True)
    err32 = rel_l2(dec32, pre32)
    dec = _decode_prompt(cfg, params, prompts).float()
    pre = _prefill(cfg, params, prompts, use_kernel=True)[0].float()
    pre_plain = _prefill(cfg, params, prompts, use_kernel=False)[0].float()
    log(f"[serve] decode vs prefill logits at the last prompt step: fp32 rel_l2 {err32:.3e} "
        f"(tol {FP32_TOL}), argmax agreement "
        f"{float((dec32.argmax(-1) == pre32.argmax(-1)).float().mean()):.2f}; bf16 rel_l2 "
        f"{rel_l2(dec, pre):.3e}, argmax agreement "
        f"{float((dec.argmax(-1) == pre.argmax(-1)).float().mean()):.2f}, beside bf16 "
        f"prefill plain vs kernel rel_l2 {rel_l2(pre_plain, pre):.3e}")
    if not (err32 <= FP32_TOL and torch.isfinite(dec).all()):
        raise AssertionError(f"decode loop disagrees with prefill: fp32 rel_l2 {err32:.3e}")


def _named_leaves(tree, prefix=""):
    """(path, tensor) pairs of a param tree, in the flatten order (sorted keys)."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _named_leaves(tree[key], f"{prefix}{key}.")
        else:
            yield prefix + key, tree[key]


def _attention_fp64(q, k, v, causal=True, window=0, kernel=None):
    """The flash op's function computed in fp64 and returned in q's type, a batch
    row at a time: the gate's reference for what an exact attention would give."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    out = torch.empty_like(q)
    for i in range(b):
        kk = k[i].double().repeat_interleave(g, 1)
        vv = v[i].double().repeat_interleave(g, 1)
        s = torch.einsum("qhd,khd->hqk", q[i].double(), kk) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
        out[i] = torch.einsum("hqk,khd->qhd", p, vv).to(q.dtype)
        del s, p
    return out


def _loss_and_grads(cfg, params, batch, use_kernel: bool):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import steps as st

    grad_fn = st.value_and_grad(st.make_loss_fn(
        cfg, st.TrainOptions(use_kernel=use_kernel, remat=True)))
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (_, (loss, _)), grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": grads, "launches": fa.launches,
            "tf32": fa.launches_by_variant["tf32"], "s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_train(cfg, smi) -> tuple[dict, dict]:
    """Full-width fp32 training: the kernel-vs-plain gate, then timed AdamW steps.
    Returns the steps' launch counts and the gate's losses (kernel, plain) of the
    init's weights on the first batch."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    n_params = sum(p.numel() for _, p in _named_leaves(params))

    def batch_of(step):
        return {k: torch.from_numpy(v).cuda()
                for k, v in make_batch(cfg, TRAIN_LEN, TRAIN_BATCH, step=step).items()}

    # -- gate: one loss and gradient through the kernel against the plain path,
    #    beside the fp32 floor (plain chunked against plain dense) and, for the
    #    record, the flash op computed in fp64
    from unittest import mock

    batch = batch_of(0)
    runs, host = {}, {}
    for name, c, use_kernel in (("kernel", cfg, True),
                                ("chunked", dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK),
                                 False),
                                ("fp64", cfg, True),
                                ("plain", cfg, False)):
        with (mock.patch.object(fa, "launch", _attention_fp64) if name == "fp64"
              else contextlib.nullcontext()):
            runs[name] = _loss_and_grads(c, params, batch, use_kernel=use_kernel)
        runs[name]["norm"] = float(opt.global_norm(runs[name]["grads"]))
        if name != "plain":  # keep on the host, free the card
            host[name] = {n: g.cpu() for n, g in _named_leaves(runs[name].pop("grads"))}
            torch.cuda.empty_cache()
    k, c, p = runs["kernel"], runs["chunked"], runs["plain"]
    leaf_err, leaf_floor, leaf_fp64 = {}, {}, {}
    for n, g in _named_leaves(p.pop("grads")):
        leaf_err[n] = rel_l2(host["kernel"][n].cuda(), g)
        leaf_floor[n] = rel_l2(host["chunked"][n].cuda(), g)
        leaf_fp64[n] = rel_l2(host["fp64"][n].cuda(), g)
    del host
    torch.cuda.empty_cache()
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    norm_err = abs(k["norm"] - p["norm"]) / p["norm"]
    norm_floor = abs(c["norm"] - p["norm"]) / p["norm"]
    bad = [n for n in leaf_err if leaf_err[n] > max(GRAD_RTOL, leaf_floor[n])]
    log(f"[train] gate {cfg.name} fp32 batch {TRAIN_BATCH} x {TRAIN_LEN}, remat: loss kernel "
        f"{k['loss']:.7f} plain {p['loss']:.7f} chunked {c['loss']:.7f} (kernel rel "
        f"{loss_err:.2e}, tol {LOSS_RTOL}); grad norm kernel {k['norm']:.6e} plain "
        f"{p['norm']:.6e} (rel {norm_err:.2e}, tol {GRAD_RTOL}; chunked rel {norm_floor:.2e}); "
        f"flash launches {k['launches']}, {c['launches']}, {p['launches']}; "
        f"{k['s']:.2f}s, {c['s']:.2f}s, {p['s']:.2f}s; peak {k['peak_gib']:.1f}, "
        f"{c['peak_gib']:.1f}, {p['peak_gib']:.1f} GiB")
    for n in leaf_err:
        log(f"[train] gate leaf {n:24s} rel_l2 kernel {leaf_err[n]:.2e} vs floor (chunked) "
            f"{leaf_floor[n]:.2e}, tol max({GRAD_RTOL}, floor); fp64 attention "
            f"{leaf_fp64[n]:.2e}")
    if k["launches"] != k["tf32"] or k["launches"] != 2 * cfg.n_layers or c["launches"] or \
            p["launches"] or runs["fp64"]["launches"]:
        raise AssertionError(f"loss and gradient launched the flash kernel {k['launches']} "
                             f"times ({k['tf32']} tf32) with it and {c['launches']}, "
                             f"{p['launches']} without; want {2 * cfg.n_layers} tf32 and 0")
    if bad or not (loss_err <= LOSS_RTOL and norm_err <= GRAD_RTOL
                   and math.isfinite(k["loss"]) and math.isfinite(k["norm"])):
        raise AssertionError(f"training gate: the kernel's loss, gradient norm or gradients "
                             f"{bad} disagree with the plain path's")

    # -- timed AdamW steps through the kernel (the slice's main path)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                           schedule=cfg.schedule)
    step_fn = st.make_train_step(cfg, ocfg, st.TrainOptions(use_kernel=True, remat=True))
    ostate = opt.init(params)
    batches = [batch_of(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, per_step = [], []
    for s in range(TRAIN_STEPS):
        before = fa.launches
        t0 = time.perf_counter()
        params, ostate, m = step_fn(params, ostate, batches[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(fa.launches - before)
        loss, gnorm, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        log(f"[train] step {s + 1}: loss {loss:.6f} grad_norm {gnorm:.6e} lr {lr:.3e} "
            f"{secs[-1]:.3f}s ({TRAIN_BATCH * TRAIN_LEN / secs[-1]:.0f} tok/s), flash "
            f"launches {per_step[-1]}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"training step {s + 1}: loss {loss}, grad norm {gnorm}")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if (per_step != [2 * cfg.n_layers] * TRAIN_STEPS or launches["rmsnorm"] != 0
            or launches["flash_attention_fwd_tf32"] != launches["flash_attention_fwd"]):
        raise AssertionError(f"training steps launched {per_step} flash kernels a step, want "
                             f"{2 * cfg.n_layers}, all tf32: {launches}")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    log(f"[train] {cfg.name} fp32, {n_params / 1e9:.3f}G params, batch {TRAIN_BATCH} x "
        f"{TRAIN_LEN}, remat, AdamW: {TRAIN_STEPS} steps in {[round(x, 3) for x in secs]} s; "
        f"steady {steady:.3f} s/step ({TRAIN_BATCH * TRAIN_LEN / steady:.0f} tok/s); peak "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches {launches} [{smi}]")
    _profile("one train step", lambda: step_fn(params, ostate, batches[0]))
    del params, ostate, batches, batch, m
    torch.cuda.empty_cache()
    return launches, {"kernel": k["loss"], "plain": p["loss"]}


def _profile(label: str, fn, top: int = 10) -> None:
    """One more call of ``fn`` under torch.profiler: device time by kernel, and idle share.

    Not part of any timed call or launch count.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log(f"[profile] {label}: the profiler saw no device time; the timed calls are the "
            "measure")
        return
    groups = dict.fromkeys(("matmul (gemm)", "flash_attention_fwd kernel", "copy/cat/index",
                            "reduction", "elementwise", "other"), 0.0)
    for e in kernels:
        name = e.key.lower()
        key = ("flash_attention_fwd kernel" if "flash_fwd" in name or "split_kv" in name
               else "matmul (gemm)" if any(w in name for w in ("gemm", "cutlass", "nvjet"))
               else "copy/cat/index" if any(w in name for w in ("copy", "cat", "index",
                                                                 "gather", "scatter"))
               else "reduction" if any(w in name for w in ("reduce", "softmax", "scan"))
               else "elementwise" if "elementwise" in name
               else "other")
        groups[key] += e.self_device_time_total
    log(f"[profile] {label} under torch.profiler: wall {wall_us / 1e6:.3f}s, device busy "
        f"{busy_us / 1e6:.3f}s, idle share {max(0.0, 1 - busy_us / wall_us):.3f}; "
        + "; ".join(f"{k} {v / 1e6:.3f}s ({v / busy_us:.1%})" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.1f} ms {e.count:6d}x  {e.key[:110]}")


def phase_train_driver() -> dict:
    """The train driver at smoke width through the kernel: checkpoints, board failure,
    remap, restore."""
    from repro_torch.launch import train as train_cli

    _reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir, contextlib.redirect_stdout(out):
        res = train_cli.main(["--arch", "llama3.2-3b-smoke", "--steps", "30",
                              "--checkpoint-every", "10", "--simulate-failure", "15",
                              "--checkpoint-dir", ckpt_dir, "--use-kernel"])
    secs = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[driver] {line}")
    for want in ("[failure] board (", "[failure] remapped to rows=",
                 "[failure] restarted from checkpoint step 10", "[train] step   30 loss"):
        if want not in text:
            raise AssertionError(f"train driver: no line with {want!r}")
    if res["step"] != 30 or not math.isfinite(res["loss"]):
        raise AssertionError(f"train driver ended at step {res['step']} with loss {res['loss']}")
    launches = _counts()
    log(f"[driver] llama3.2-3b-smoke: 30 steps with a failure at 15 and a restart from 10 in "
        f"{secs:.1f}s, final loss {res['loss']:.4f}; launches {launches}")
    if launches["flash_attention_fwd_tf32"] == 0 or launches["flash_attention_fwd_simt"]:
        raise AssertionError(f"train driver with --use-kernel launched {launches}, want tf32 only")
    return launches


# ---------------------------------------------------------------------------
# the sync phase: the paper's allreduce algorithms over 16 ranks on one card
# ---------------------------------------------------------------------------

SYNC_AXES = ("data", "model")
SYNC_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/multidevice_checks.py
SYNC_STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # its check_collective_train_step
SYNC_REPS = 3
SYNC_OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)  # check_collective_train_step's
SYNC_SEQ, SYNC_ROWS = 64, 16  # the sync train step's batch: the CLI's length, 16 rows
# The card's fp32 floor of the sync step against whole-batch auto: the mean of the
# shards' gradients against the whole batch's, relative L2 a leaf. Three runs on an
# H100 80GB HBM3 at 700 W gave 5.7e-5 over 4 shards; the bound leaves room for the
# order of sums to move, and for 16 shards of one row each.
SYNC_FLOOR = 2e-4
LINKS = ("data+", "data-", "model+", "model-")


def _layer_meta(cfg) -> dict:
    """One decoder layer's parameter tree (``models/transformer.py`` ``init_params``
    without the layer axis) as meta tensors: the shapes of one layer's gradient."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.kq_head_dim, cfg.n_kv_heads * cfg.kq_head_dim
    meta = functools.partial(torch.empty, device="meta")
    return {"attn_norm": {"scale": meta(d)}, "mlp_norm": {"scale": meta(d)},
            "wq": meta(d, q), "wk": meta(d, kv), "wv": meta(d, kv), "wo": meta(q, d),
            "w_gate": meta(d, f), "w_up": meta(d, f), "w_down": meta(f, d)}


def _as_tree(flat: torch.Tensor, meta: dict):
    """``flat`` as views with the shapes of ``meta``'s leaves, in flatten order."""
    from repro_torch import tree as tree_lib

    leaves, spec = tree_lib.flatten(meta)
    parts = flat.split([m.numel() for m in leaves])
    return tree_lib.unflatten(spec, [p.view(m.shape) for p, m in zip(parts, leaves)])


def _norm(leaves) -> float:
    return math.sqrt(sum(float((g.double() ** 2).sum()) for g in leaves))


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """The paths of a tree of dicts' leaves, in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _link(src: int, dst: int, r: int = 4, c: int = 4) -> str:
    """The 4x4 torus link a transfer takes; raises unless src and dst are neighbours."""
    (i0, j0), (i1, j1) = divmod(src, c), divmod(dst, c)
    if j0 == j1 and (i1 - i0) % r in (1, r - 1):
        return "data+" if (i1 - i0) % r == 1 else "data-"
    if i0 == i1 and (j1 - j0) % c in (1, c - 1):
        return "model+" if (j1 - j0) % c == 1 else "model-"
    raise AssertionError(f"transfer {src} -> {dst} is not between 4x4 torus neighbours")


def _run_timed(mesh, fn, args) -> tuple[list, dict, list[float]]:
    """One warm-up run of ``fn`` on every rank, its transport counts, then SYNC_REPS
    timed runs (host clock around a device sync); the last run's outputs."""
    mesh.stats.reset()
    outs = mesh.run(fn, *args)
    torch.cuda.synchronize()
    st = mesh.stats
    counts = {"bytes": dict(st.bytes), "messages": dict(st.messages),
              "psum_calls": st.psum_calls, "all_gather_calls": st.all_gather_calls}
    times = []
    for _ in range(SYNC_REPS):
        outs = None  # one set of outputs alive at a time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mesh.run(fn, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return outs, counts, times


def _check_sum(label, outs, ref_of) -> float:
    """Every rank's output within SYNC_TOL of its fp64 reference; the largest error."""
    worst = 0.0
    for r, out in enumerate(outs):
        ref = ref_of(r)
        diff = (out.reshape(-1).double() - ref).abs_()
        excess = float((diff - SYNC_TOL["rtol"] * ref.abs()).max())
        if excess > SYNC_TOL["atol"]:
            raise AssertionError(f"[sync] {label}: rank {r} misses rtol {SYNC_TOL['rtol']} "
                                 f"atol {SYNC_TOL['atol']} by {excess:.3e}")
        worst = max(worst, float(diff.max()))
        del diff
    return worst


def _link_loads(counts, size_bytes) -> dict:
    """Bytes by sender and by directed link, in units of the bucket S."""
    sent = collections.Counter()
    for (src, _), b in counts["bytes"].items():
        sent[src] += b
    per_link = {link: 0 for link in LINKS}
    for (src, dst), b in counts["bytes"].items():
        if src == 0:
            per_link[_link(src, dst)] += b
    return {"rank_sends_S": max(sent.values(), default=0) / size_bytes,
            "largest_link_S": max(counts["bytes"].values(), default=0) / size_bytes,
            "rank0_links_S": {k: v / size_bytes for k, v in per_link.items()}}


def phase_sync_collectives(smi) -> dict:
    """Each algorithm over 16 LocalMesh ranks on cuda:0, at one llama3.2-3b layer's
    gradient a rank, against an fp64 sum on the card; transfers against the paper's
    accounting; times of the in-process transport (HBM copies, not a network)."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.core import commodel
    from repro_torch.launch.mesh import make_test_mesh

    from repro_torch import tree as tree_lib

    meta = _layer_meta(get_config("llama3.2-3b"))
    n = sum(leaf.numel() for leaf in tree_lib.leaves(meta))
    size = 4 * n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    xs = [torch.randn(n, generator=torch.Generator("cuda").manual_seed(r), device="cuda")
          for r in range(16)]
    total = torch.zeros(n, dtype=torch.float64, device="cuda")
    for x in xs:
        total += x
    rows = {}

    def row_sum(r):  # the 4 ranks of rank r's row, for calls over "model" alone
        i = r // 4
        if i not in rows:
            rows.clear()
            rows[i] = torch.zeros(n, dtype=torch.float64, device="cuda")
            for j in range(4):
                rows[i] += xs[4 * i + j]
        return rows[i]

    mesh = make_test_mesh((4, 4), SYNC_AXES, "cuda")
    line = make_test_mesh((16,), ("r",), "cuda")
    calls = [(a, mesh, lambda c, x, a=a: coll.allreduce(c, x, a, SYNC_AXES, (4, 4)),
              lambda r: total) for a in coll.ALGORITHMS]
    calls += [(f"{a}_model", mesh, lambda c, x, a=a: coll.allreduce(c, x, a, ("model",)),
               row_sum) for a in ("ring", "bidir")]
    calls.append(("rs_ag_16", line, lambda c, x: coll.ring_all_gather(
        c, coll.ring_reduce_scatter(c, x, "r"), "r"), lambda r: total))
    mean = total / 16

    def tree_call(c, x):
        out = coll.allreduce_tree(c, _as_tree(x, meta), "torus", SYNC_AXES, (4, 4), mean=True)
        return torch.cat([leaf.reshape(-1) for leaf in tree_lib.leaves(out)])

    calls.append(("tree_torus_mean", mesh, tree_call, lambda r: mean))

    results = {}
    for name, m, fn, ref_of in calls:
        outs, counts, times = _run_timed(m, fn, [xs])
        err = _check_sum(name, outs, ref_of)
        outs = None
        res = {"max_abs_err": err, "ms": statistics.median(times), "ms_runs": times,
               "psum_calls": counts["psum_calls"],
               "all_gather_calls": counts["all_gather_calls"],
               "messages": sum(counts["messages"].values())}
        if m is mesh:
            res.update(_link_loads(counts, size))  # raises on a non-neighbour transfer
        else:
            sent = collections.Counter()
            for (src, _), b in counts["bytes"].items():
                sent[src] += b
            res["rank_sends_S"] = max(sent.values()) / size
        if name == "psum":
            if counts["bytes"] or counts["psum_calls"] != 16:
                raise AssertionError(f"[sync] psum moved {counts['bytes']} by ppermute")
        elif counts["psum_calls"] or counts["all_gather_calls"] or not counts["bytes"]:
            raise AssertionError(f"[sync] {name} must move data by ppermute alone: {counts}")
        if name == "hamiltonian":
            loads = set(counts["bytes"].values())
            if len(counts["bytes"]) != 64 or len(loads) != 1:
                raise AssertionError(f"[sync] hamiltonian links not balanced: {counts['bytes']}")
        if name in commodel.ALGORITHMS:
            t_model = commodel.ALGORITHMS[name](16, size)
            alpha_term = t_model - commodel.ALGORITHMS[name](16, size, alpha=0.0)
            res["model_bw_ms"] = (t_model - alpha_term) * 1e3
            res["model_bw_S_beta"] = (t_model - alpha_term) * commodel.INJECTION_BPS / size
            res["link_bound_ms"] = res["largest_link_S"] * size / commodel.LINK_BPS * 1e3
        results[name] = res
        links = " ".join(f"{k} {v:.4f}" for k, v in res.get("rank0_links_S", {}).items())
        log(f"[sync] {name:16s} max |err| {err:.3e}; {res['ms']:9.2f} ms median of "
            f"{SYNC_REPS} ({', '.join(f'{t:.2f}' for t in times)}); a rank sends "
            f"{res['rank_sends_S']:.4f} S" + (f", largest link {res['largest_link_S']:.4f} S; "
                                             f"rank 0: {links}" if m is mesh else "")
            + f"; {res['messages']} messages, {res['psum_calls']} psum, "
              f"{res['all_gather_calls']} all_gather calls")
        if "model_bw_ms" in res:
            log(f"[sync] {name:16s} alpha-beta model at p=16: bandwidth term "
                f"{res['model_bw_S_beta']:.4f} S*beta = {res['model_bw_ms']:.3f} ms at 4 x "
                f"{commodel.LINK_BPS / 1e9:.0f} GB/s; the largest link's load at "
                f"{commodel.LINK_BPS / 1e9:.0f} GB/s: {res['link_bound_ms']:.3f} ms")
    rows.clear()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del xs, total, mean
    torch.cuda.empty_cache()
    log(f"[sync] bucket {n:,} fp32 a rank (S = {size / 1e6:.1f} MB, one llama3.2-3b layer), "
        f"16 ranks on one card; peak {peak:.2f} GiB above the phase's start. Times are the "
        f"in-process transport: device-to-device copies in one card's HBM and the ranks' "
        f"barriers, not a network ({smi})")
    return {"mesh": [4, 4], "bucket_elems": n, "bucket_bytes": size, "peak_gib": peak,
            "algorithms": results}


def phase_sync_train(smi) -> dict:
    """The sync train step at smoke width over 16 LocalMesh ranks on one card, through
    the tf32 flash kernel, against ``sync="auto"`` on the whole batch; top-k
    compression's mass conservation; the CLI with ``--sync`` on this card."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import Policy
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    cfg = get_config("llama3.2-3b-smoke")
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(cfg, SYNC_SEQ, SYNC_ROWS).items()}
    ocfg = opt.AdamWConfig(**SYNC_OCFG)
    clone = functools.partial(tree_lib.tree_map, torch.clone)

    def clipped(leaves):  # fp64, scaled to a global norm of at most clip_norm, as apply
        return [g * min(1.0, ocfg.clip_norm / _norm(leaves)) for g in leaves]

    def first_update(g):  # u(g) of AdamW's first step: m^ = g, sqrt(v^) = |g|
        return g / (g.abs() + ocfg.eps)

    def shards(b, n):
        rows = len(b["tokens"]) // n
        return [{k: v[i * rows:(i + 1) * rows] for k, v in b.items()} for i in range(n)]

    # the reference: sync="auto" on the whole batch, one rank; after one step
    # the first moment is (1 - b1) times the clipped gradient
    ref = clone(params)
    ref, ref_state, ref_m = st.make_train_step(cfg, ocfg, st.TrainOptions(use_kernel=True))(
        ref, opt.init(ref), batch)
    g_auto = [m.double() / (1 - ocfg.b1) for m in tree_lib.leaves(ref_state.m)]
    lr = float(ref_m["lr"])
    # what the ranks' collectives must produce: the mean of the data shards'
    # gradients, each computed here in turn, summed in fp64
    grad_fn = st.value_and_grad(st.make_loss_fn(cfg, st.TrainOptions(use_kernel=True)))
    shard_mean, shard_norm, shard_grads, floor = {}, {}, {}, {}
    for axes in (("data",), SYNC_AXES):
        n = math.prod(4 for _ in axes)
        shard_grads[axes] = [tree_lib.leaves(grad_fn(params, b)[1]) for b in shards(batch, n)]
        mean = [sum(g.double() for g in gs) / n for gs in zip(*shard_grads[axes])]
        shard_norm[axes], shard_mean[axes] = _norm(mean), clipped(mean)
        floor[axes] = max(rel_l2(a, b) for a, b in zip(shard_mean[axes], g_auto))
    # where the floor comes from: the same comparison through the plain attention,
    # the whole batch's fp32 gradient against an fp64 model's, and whether one
    # matmul of the model gives the same rows for a shard as for the whole batch
    plain_fn = st.value_and_grad(st.make_loss_fn(cfg, st.TrainOptions()))
    g_plain = tree_lib.leaves(plain_fn(params, batch)[1])
    floor_plain = max(rel_l2(sum(g.double() for g in gs) / 4, w) for w, gs in zip(
        g_plain, zip(*[tree_lib.leaves(plain_fn(params, b)[1]) for b in shards(batch, 4)])))
    g64 = tree_lib.leaves(plain_fn(tree_lib.tree_map(lambda t: t.double(), params), batch)[1])
    own = {n: rel_l2(a, b) for n, a, b in zip(_leaf_names(params), g_plain, g64)}
    x = torch.randn(SYNC_ROWS * SYNC_SEQ, cfg.d_model, device="cuda")
    w = torch.randn(cfg.d_model, cfg.d_ff, device="cuda")
    rows_equal = {n: torch.equal(torch.cat([x[i * len(x) // n:(i + 1) * len(x) // n] @ w
                                            for i in range(n)]), x @ w) for n in (4, 16)}
    log(f"[sync-train] the card's fp32 floor of this comparison: the mean of the shards' "
        f"gradients against the whole batch's, relative L2 up to {floor[('data',)]:.2e} a "
        f"leaf over 4 shards, {floor[SYNC_AXES]:.2e} over 16 (bound {SYNC_FLOOR}); "
        f"{floor_plain:.2e} over 4 through the plain attention; the whole batch's fp32 "
        f"gradient against an fp64 model's up to {max(own.values()):.2e} "
        f"({max(own, key=own.get)}); the rows of x @ w ({tuple(x.shape)} @ "
        f"{tuple(w.shape)}, fp32) for a shard bitwise those of the whole batch: 4 shards "
        f"{rows_equal[4]}, 16 shards {rows_equal[16]}")
    for axes, f in floor.items():
        if f > SYNC_FLOOR:
            raise AssertionError(f"[sync-train] the mean of the shards' gradients over {axes} "
                                 f"is {f:.3e} (relative L2) off the whole batch's, past "
                                 f"{SYNC_FLOOR}")
    # the model in 16 rank threads at once: each rank's own gradient against its
    # shard's, computed above in this thread
    mesh = make_test_mesh((4, 4), SYNC_AXES, "cuda")
    rows = SYNC_ROWS // 4
    per_rank = mesh.run(lambda c, b: tree_lib.leaves(grad_fn(params, b)[1]), [
        {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        for i in (mesh.axis_index(r, "data") for r in range(16))])
    thread_err, bitwise = 0.0, True
    for r, leaves in enumerate(per_rank):
        for a, b in zip(leaves, shard_grads[("data",)][mesh.axis_index(r, "data")]):
            thread_err = max(thread_err, rel_l2(a, b))
            bitwise = bitwise and torch.equal(a, b)
    if thread_err > 1e-6:
        raise AssertionError(f"[sync-train] a rank thread's gradient is {thread_err:.3e} "
                             f"(relative L2) off its shard's computed alone")
    log(f"[sync-train] 16 rank threads' own gradients against their shards' computed one "
        f"at a time: relative L2 up to {thread_err:.2e}, bitwise equal: {bitwise}")
    del per_rank, shard_grads

    steps = {}
    _reset_counts()
    for sync, axes in (("ring", ("data",)), ("bidir", ("data",)),
                       ("torus", SYNC_AXES), ("hamiltonian", SYNC_AXES)):
        mesh = make_test_mesh((4, 4), SYNC_AXES, "cuda")
        p = clone(params)
        step = st.make_train_step(cfg, ocfg, st.TrainOptions(use_kernel=True, sync=sync),
                                  Policy(data_axes=axes), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, m = step(p, opt.init(p), batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        g_sync = [mm.double() / (1 - ocfg.b1) for mm in tree_lib.leaves(state.m)]
        grad_err = max(rel_l2(a, b) for a, b in zip(g_sync, shard_mean[axes]))
        if grad_err > SYNC_TOL["rtol"]:
            raise AssertionError(f"[sync-train] {sync}: synced gradients {grad_err:.3e} "
                                 f"(relative L2) off the shards' fp64 mean")
        auto_err = max(rel_l2(a, b) for a, b in zip(g_sync, g_auto))
        if auto_err > SYNC_FLOOR + SYNC_TOL["rtol"]:
            raise AssertionError(f"[sync-train] {sync}: synced gradients {auto_err:.3e} "
                                 f"(relative L2) off whole-batch auto's")
        # the gradient's scale: the norm before clipping, to which m and AdamW's
        # first update are blind
        norm_err = abs(float(m["grad_norm"]) / shard_norm[axes] - 1)
        if norm_err > SYNC_TOL["rtol"]:
            raise AssertionError(f"[sync-train] {sync}: grad_norm {float(m['grad_norm'])} "
                                 f"against the shards' fp64 mean's {shard_norm[axes]}")
        worst, excess, amplified, g_there = 0.0, -1.0, 0, []
        for a, b, gs, ga in zip(tree_lib.leaves(p), tree_lib.leaves(ref), g_sync, g_auto):
            d = (a - b).abs().double()
            tol = SYNC_STEP_TOL["rtol"] * b.abs().double() + SYNC_STEP_TOL["atol"]
            worst = max(worst, float(d.max()))
            amplified += int((d > tol).sum())
            g_there += ga[d > tol].abs().tolist()
            du = (first_update(gs) - first_update(ga)).abs()
            excess = max(excess, float((d - tol - lr * du).max()))
        if excess > 0:
            raise AssertionError(f"[sync-train] {sync}: params miss rtol "
                                 f"{SYNC_STEP_TOL['rtol']} atol {SYNC_STEP_TOL['atol']} + "
                                 f"lr*|du| of auto by {excess:.3e}")
        for src, dst in mesh.stats.bytes:
            _link(src, dst)
        if abs(float(m["loss"]) - float(ref_m["loss"])) > 1e-5 * abs(float(ref_m["loss"])):
            raise AssertionError(f"[sync-train] {sync}: loss {float(m['loss'])} against "
                                 f"auto's {float(ref_m['loss'])}")
        g_range = [min(g_there), max(g_there)] if g_there else None
        steps[sync] = {"grad_rel_l2": grad_err, "grad_rel_l2_auto": auto_err,
                       "grad_norm": float(m["grad_norm"]), "grad_norm_rel_err": norm_err,
                       "max_abs_param_diff": worst,
                       "elements_past_rtol_atol": amplified, "their_abs_g_auto": g_range,
                       "s": secs, "loss": float(m["loss"])}
        log(f"[sync-train] {sync:11s} over {axes}: gradients {grad_err:.2e} (relative L2) "
            f"off the shards' fp64 mean, {auto_err:.2e} off auto's; grad_norm "
            f"{float(m['grad_norm']):.6f} ({norm_err:.1e} off the mean's, auto "
            f"{float(ref_m['grad_norm']):.6f}); params against auto: max |diff| {worst:.3e}, "
            f"{amplified} elements past rtol {SYNC_STEP_TOL['rtol']} atol "
            f"{SYNC_STEP_TOL['atol']} (|g| there {g_range}, clipped; eps {ocfg.eps}), each "
            f"within lr*|u(g_sync) - u(g_auto)| more; loss {float(m['loss']):.6f} (auto "
            f"{float(ref_m['loss']):.6f}), {secs:.2f} s, "
            f"{sum(mesh.stats.bytes.values()) / 1e6:.3f} MB by ppermute")
    launches = _counts()
    want = 4 * 16 * 2 * cfg.n_layers  # 4 steps, 16 ranks, forward and remat recompute
    log(f"[sync-train] launches over the four sync steps: {launches} (tf32 wanted {want})")
    if launches["flash_attention_fwd_tf32"] != want or launches["flash_attention_fwd_simt"]:
        raise AssertionError(f"[sync-train] launched {launches}, want {want} tf32 only")

    # check_compression of tests/multidevice_checks.py on 16 ranks of the card
    g = torch.randn(16, 64, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    line = make_test_mesh((16,), ("d",), "cuda")

    def sparse(c, gs):
        out, state = comp.sparse_allreduce(c, gs, comp.init_state(gs), 8, "d")
        return out, state.residual

    res = line.run(sparse, list(g))
    reduced = res[0][0]
    resid_sum = torch.stack([r for _, r in res]).sum(0)
    err = float((reduced + resid_sum / 16 - g.mean(0)).abs().max())
    if not torch.allclose(reduced + resid_sum / 16, g.mean(0), rtol=1e-4, atol=1e-5):
        raise AssertionError(f"[sync-train] sparse_allreduce loses mass: max |err| {err:.3e}")
    log(f"[sync-train] compress_k=8 over 16 ranks conserves the gradient mass (max |err| "
        f"{err:.3e}; {line.stats.all_gather_calls} all_gather calls)")

    # the CLI: a one-rank "data" mesh on this card, as the JAX driver on one device
    cli = {}
    for sync in ("auto", "ring"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli[sync] = train_cli.main(["--arch", "llama3.2-3b-smoke", "--steps", "3",
                                        "--sync", sync, "--use-kernel"])
    if abs(cli["ring"]["loss"] - cli["auto"]["loss"]) > 1e-6 * abs(cli["auto"]["loss"]):
        raise AssertionError(f"[sync-train] CLI --sync ring loss {cli['ring']['loss']} "
                             f"against auto's {cli['auto']['loss']}")
    for sync in ("torus", "hamiltonian"):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.main(["--arch", "llama3.2-3b-smoke", "--steps", "1", "--sync", sync])
        except ValueError as e:
            if "needs a 2D mesh" not in str(e):
                raise
        else:
            raise AssertionError(f"[sync-train] CLI --sync {sync} on a 1D mesh did not raise")
    log(f"[sync-train] CLI, 3 steps on one rank: --sync ring loss {cli['ring']['loss']:.7f}, "
        f"--sync auto {cli['auto']['loss']:.7f}; --sync torus and hamiltonian raise "
        f"'needs a 2D mesh' on the 1D mesh ({smi})")
    return {"steps": steps,
            "shard_floor_rel_l2": {"4": floor[("data",)], "16": floor[SYNC_AXES]},
            "shard_floor_rel_l2_plain": floor_plain, "fp32_vs_fp64_rel_l2": own,
            "matmul_rows_bitwise": rows_equal, "thread_rel_l2": thread_err,
            "thread_bitwise": bitwise, "launches": launches,
            "compression_max_abs_err": err,
            "cli_loss": {k: v["loss"] for k, v in cli.items()}}


# ---------------------------------------------------------------------------
# the MoE phases: moonshot-v1-16b-a3b served at full width and depth in bf16,
# fp32 checks and training at 4 of its 48 layers, expert parallelism on 4 ranks
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 4  # the fp32 phases' depth: 47.3 GB of training state (48 layers: ~449 GB)
# The fp32 phases' 4 layers carry the full 48-layer model's init: dense_init's
# fan-in is the stack's L (ROADMAP Queue C), so drawn at L = 4 the layer weights
# would be N(0, 1/4), not N(0, 1/48), and the attention scores ~450 instead of
# ~40.  There the gradients are ill-conditioned: on the H100 every path's
# gradients (plain, chunked, the kernel, the flash op in fp64) are 0.3-1.7
# (relative L2) from every other's.
# ceil(E / k) = 11 gives a capacity of at least the group: no token dropped, as
# decode (groups of one token, capacity 1) never drops one
MOE_NODROP_CF = 11.0
# the depth whose init the fp32 phases' layers carry (None: the full model's);
# MOE_LAYERS draws them with fan-in 4, as a 4-layer model would be
MOE_INIT_DEPTH = None
MOE_EP_RANKS = 4
# moe_apply_ep against moe_apply on the card: check_moe_ep's rtol 1e-4, its atol
# (1e-5 on outputs of ~0.1) scaled to the largest output, here ~1e3
MOE_EP_RTOL = 1e-4


@contextlib.contextmanager
def _routing_log():
    """Every MoE dispatch's (flat_e, keep): each (token, choice) pair's expert and
    whether it fits the capacity, token-major, in call order."""
    from unittest import mock

    from repro_torch.models import moe

    calls, real = [], moe._slots

    def slots(experts, n_experts, cap, *args):
        flat_e, pos_c, keep = real(experts, n_experts, cap, *args)
        calls.append((flat_e, keep))
        return flat_e, pos_c, keep

    with mock.patch.object(moe, "_slots", slots):
        yield calls


@contextlib.contextmanager
def _replayed_routing(log_, per_rank: bool = False):
    """Every MoE dispatch takes the experts of ``log_`` (a ``_routing_log`` of the
    same dispatches, in the same order) in place of its own top-k.  The gates and
    the aux loss are the router's at those experts, so gradients flow as in a run
    that chose them: two paths of the model then differ only continuously.  The
    dispatches read the log in turn, whatever thread runs them (the backward's
    remat recompute runs on the autograd engine's); with ``per_rank`` each rank
    thread of a ``LocalMesh`` replays the whole log on its own, each dispatch cut
    to the rows of the batch the thread routes if it names them through the
    ``claim(rows)`` this yields (a slice; one dispatch group a row: S <=
    GROUP_TOKENS)."""
    from unittest import mock

    from repro_torch.models import moe

    iters, rows, lock = {}, {}, threading.Lock()

    def top_k(probs, k):
        key = threading.get_ident() if per_rank else 0
        with lock:
            it = iters.setdefault(key, iter(log_))
        return next(it)[0][rows.get(key, slice(None))].reshape(*probs.shape[:-1], k)

    def claim(sl: slice) -> None:
        rows[threading.get_ident()] = sl

    with mock.patch.object(moe, "_top_k", top_k):
        yield claim
    if any(next(it, None) is not None for it in iters.values()) or (log_ and not iters):
        raise AssertionError("a replayed routing log outlived its dispatches")


def _routing_agreement(a, b) -> tuple[float, int, int]:
    """Share of (token, choice) pairs whose expert and keep agree between two
    logs of the same dispatches; the pairs that differ; the pairs dropped in ``b``."""
    if len(a) != len(b):
        raise AssertionError(f"routing logs of {len(a)} and {len(b)} dispatches")
    same = total = dropped = 0
    for (ea, ka), (eb, kb) in zip(a, b):
        if ea.shape != eb.shape:
            raise AssertionError(f"routing shapes {tuple(ea.shape)} and {tuple(eb.shape)}")
        same += int(((ea == eb) & (ka == kb)).sum())
        total += ea.numel()
        dropped += int((~kb).sum())
    return same / total, total - same, dropped


@contextlib.contextmanager
def _spans():
    """Device time by span of the calls inside, from the program's tracer
    (``repro_torch.trace``, read after the block): each span's own ms (less its
    children's) summed by its range name, ``<name>.<phase>``."""
    from repro_torch import trace

    ms = {}
    trace.reset()
    trace.enable()
    try:
        yield ms
    finally:
        trace.disable()
    for r in trace.snapshot().records:
        ms[r.label] = ms.get(r.label, 0.0) + r.self_ms
    trace.reset()


def _span_line(ms: dict, total_ms: float) -> str:
    rest = total_ms - sum(ms.values())
    return "; ".join(f"{k} {v:.1f} ms ({v / total_ms:.1%})" for k, v in
                     sorted(ms.items(), key=lambda kv: -kv[1])) + (
        f"; outside every span {rest:.1f} ms ({rest / total_ms:.1%})")


def phase_moe_serve(smi) -> tuple[dict, dict]:
    """moonshot-v1-16b-a3b at full width and depth in bf16: the prefill through the
    sm90 kernel (one warm-up call, three timed), its device time by part and under
    the profiler, then the serving loop of ``launch/serve.py``.  Returns the
    numbers and the weights (for ``phase_moe_ep_prefill``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.train.steps import make_decode_step

    cfg = get_config(MOE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in _named_leaves(params))
    weights = sum(p.numel() * p.element_size() for _, p in _named_leaves(params))
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv) of {cfg.kq_head_dim}, {cfg.n_experts} experts top-{cfg.top_k} "
        f"of d_ff {cfg.d_ff}, capacity factor {cfg.capacity_factor}, vocab {cfg.vocab}: "
        f"{n_params / 1e9:.3f}G params ({weights / 1e9:.2f} GB, the router in fp32) drawn in "
        f"{init_s:.1f}s; memory before {base / 2**30:.2f} GiB, init peak "
        f"{(torch.cuda.max_memory_allocated() - base - weights) / 2**30:.2f} GiB above the "
        f"weights")

    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)["tokens"]).cuda()
    want = {"flash_attention_fwd": cfg.n_layers, "rmsnorm": 0,
            **{f"flash_attention_fwd_{v}": cfg.n_layers * (v == "sm90") for v in fa.SOURCES}}
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(4):
        _reset_counts()
        logits, t = _prefill(cfg, params, tokens, use_kernel=True)
        launches = _counts()
        if launches != want:
            raise AssertionError(f"moe prefill launched {launches}, want {want}")
        if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"moe prefill logits {tuple(logits.shape)} not finite or "
                                 "misshapen")
        secs.append(t)
    median = sorted(secs[1:])[1]
    ntok = PREFILL_BATCH * PREFILL_LEN
    peak = torch.cuda.max_memory_allocated()
    log(f"[moe-prefill] {cfg.name} bf16 batch {PREFILL_BATCH} x {PREFILL_LEN} through the sm90 "
        f"kernel: {median:.3f}s median of 3 after a warm-up ({ntok / median:.0f} tok/s; calls "
        f"{[round(x, 3) for x in secs]} s), launches a call {launches}, peak "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) [{smi}]")
    with _spans() as ms:
        _, t_span = _prefill(cfg, params, tokens, use_kernel=True)
    log(f"[moe-prefill] device time by part over one prefill ({t_span * 1e3:.1f} ms on the "
        f"host clock; each span's own device time): {_span_line(ms, t_span * 1e3)}")
    _profile("one moonshot bf16 prefill", lambda: _prefill(cfg, params, tokens, use_kernel=True))

    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = serve(cfg, params, prompts, SERVE_DECODE)
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_DECODE) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"moe serve returned bad tokens {tuple(toks.shape)}")
    steps = SERVE_PROMPT + SERVE_DECODE
    log(f"[moe-serve] {cfg.name} bf16 batch {SERVE_BATCH}: prompt {SERVE_PROMPT} teacher-forced "
        f"in {res['prefill_s']:.3f}s ({res['prefill_s'] / SERVE_PROMPT * 1e3:.2f} ms a step); "
        f"decoded {SERVE_DECODE} toks/seq in {res['decode_s']:.3f}s "
        f"({SERVE_BATCH * SERVE_DECODE / res['decode_s']:.1f} tok/s, "
        f"{res['decode_s'] / SERVE_DECODE * 1e3:.2f} ms a step; each step reads every "
        f"expert: {weights / 1e9:.1f} GB, {weights / PEAK_BYTES_PER_S * 1e3:.1f} ms at "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); {steps} steps, launches {_counts()}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; sample {toks[0, :8].tolist()} "
        f"[{smi}]")
    cache = get_model(cfg).init_cache(cfg, SERVE_BATCH, 2, device="cuda")
    decode = make_decode_step(cfg)
    tok, cache = decode(params, cache, prompts[:, :1])  # warm-up
    _profile("one moonshot bf16 decode step", lambda: decode(params, cache, tok))
    out = {"launches": launches, "prefill_s": median, "prefill_calls_s": secs,
           "prefill_peak_gib": peak / 2**30, "prefill_spans_ms": ms,
           "prefill_span_wall_ms": t_span * 1e3,
           "decode_tok_s": SERVE_BATCH * SERVE_DECODE / res["decode_s"],
           "decode_ms_step": res["decode_s"] / SERVE_DECODE * 1e3,
           "n_params": n_params, "weights_gb": weights / 1e9}
    del logits, tokens, prompts, res, cache, tok
    torch.cuda.empty_cache()
    return out, params


def _by_layer(log_, n_layers: int, steps: int):
    """A decode loop's routing log (one dispatch a layer a step, (B, k) each) as a
    prefill's: one (B, steps·k) entry a layer, token-major."""
    return [(torch.cat([log_[t * n_layers + i][0] for t in range(steps)], 1),
             torch.cat([log_[t * n_layers + i][1] for t in range(steps)], 1))
            for i in range(n_layers)]


def _decode_order(log_, steps: int):
    """A prefill's routing log (one (B, steps·k) entry a layer) in the order of a
    decode loop over the same tokens: one (B, k) entry a layer a step."""
    b = log_[0][0].shape[0]
    split = [(e.reshape(b, steps, -1), keep.reshape(b, steps, -1)) for e, keep in log_]
    return [(e[:, t], keep[:, t]) for t in range(steps) for e, keep in split]


def _moe_fp32_model():
    """The fp32 phases' model: the full config, its MOE_LAYERS-layer cut, fp32
    weights with the scale of MOE_INIT_DEPTH's init, and that depth."""
    from repro_torch.configs import get_config

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    params, _ = _load_model(cfg, "moe-e2e", torch.float32)
    # the init depth's scale on every leaf drawn with fan-in L (the layers' weights)
    init_depth = MOE_INIT_DEPTH or full.n_layers
    _rescale_stacks(params["layers"], MOE_LAYERS, init_depth)
    return full, cfg, params, init_depth


def phase_moe_fp32(smi):
    """fp32 at 4 layers: the prefill through the tf32 kernel against the plain path,
    beside the floor of two plain paths, and the decode loop against the prefill at
    the no-drop capacity factor.  Each is run twice: with free routing (reported:
    the values and the share of (token, choice) pairs routed alike), and with the
    reference path's routing replayed (gated: the paths then differ only
    continuously).  Returns the config, the fp32 weights and the numbers."""
    from repro_torch.data.pipeline import make_batch

    full, cfg, params, init_depth = _moe_fp32_model()
    weights = sum(p.numel() * p.element_size() for _, p in _named_leaves(params))
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)["tokens"]).cuda()
    chunked_cfg = dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK)

    def prefill(c, use_kernel, toks=tokens):  # the last position's logits, not a view of all
        logits, secs = _prefill(c, params, toks, use_kernel=use_kernel)
        return logits.clone(), secs

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _routing_log() as log_k:
        free_k, t_k = prefill(cfg, True)
    launches = _counts()
    with _routing_log() as log_p:
        plain, t_p = prefill(cfg, False)
    with _routing_log() as log_c:
        free_c, _ = prefill(chunked_cfg, False)
    free_err, free_floor = rel_l2(free_k, plain), rel_l2(free_c, plain)
    agree_k, flips_k, dropped = _routing_agreement(log_k, log_p)
    agree_c, flips_c, _ = _routing_agreement(log_c, log_p)
    with _replayed_routing(log_p):
        with_k, _ = prefill(cfg, True)
    with _replayed_routing(log_p):
        chunked, _ = prefill(chunked_cfg, False)
    err, floor = rel_l2(with_k, plain), rel_l2(chunked, plain)
    pairs = sum(e.numel() for e, _ in log_p)
    log(f"[moe-e2e] {cfg.name} at {MOE_LAYERS} of {full.n_layers} layers with the "
        f"{init_depth}-layer init's scale, fp32 ({weights / 1e9:.2f} GB), batch "
        f"{PREFILL_BATCH} x {PREFILL_LEN}, capacity factor {cfg.capacity_factor} ({dropped} of "
        f"{pairs} (token, choice) pairs dropped): with the plain path's routing replayed, "
        f"kernel vs plain logits rel_l2 {err:.3e} (tol max({FP32_TOL}, floor)), floor (plain "
        f"chunked {FLOOR_CHUNK} vs plain dense) {floor:.3e}; free routing: rel_l2 "
        f"{free_err:.3e}, floor {free_floor:.3e}, kernel vs plain route {agree_k:.6f} of the "
        f"pairs alike ({flips_k} differ), chunked vs plain {agree_c:.6f} ({flips_c} differ); "
        f"{t_k:.3f}s with kernel, {t_p:.3f}s plain; launches with kernel {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    if launches["flash_attention_fwd_tf32"] != cfg.n_layers or launches[
            "flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"fp32 moe prefill launched {launches}, want {cfg.n_layers} tf32")
    if not (err <= max(FP32_TOL, floor) and torch.isfinite(free_k).all()):
        raise AssertionError(f"fp32 moe prefill with kernel disagrees with plain: rel_l2 "
                             f"{err:.3e}, floor {floor:.3e}")
    del free_k, free_c, with_k, chunked, plain, log_k, log_p, log_c
    torch.cuda.empty_cache()

    # decode against prefill, where neither drops a token
    ncfg = dataclasses.replace(cfg, capacity_factor=MOE_NODROP_CF)
    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    with _routing_log() as log_pre:
        pre, _ = prefill(ncfg, True, toks=prompts)
    with _routing_log() as log_d:
        free_dec = _decode_prompt(ncfg, params, prompts)
    agree_d, flips_d, dropped_d = _routing_agreement(
        _by_layer(log_d, cfg.n_layers, SERVE_PROMPT), log_pre)
    dropped_d += sum(int((~k).sum()) for _, k in log_d)
    with _replayed_routing(_decode_order(log_pre, SERVE_PROMPT)):
        dec = _decode_prompt(ncfg, params, prompts)
    with _replayed_routing(log_pre):  # the floor: the plain prefill against the kernel's
        pre_plain, _ = prefill(ncfg, False, toks=prompts)
    err_d, free_err_d = rel_l2(dec, pre), rel_l2(free_dec, pre)
    floor_d = rel_l2(pre_plain, pre)
    log(f"[moe-e2e] decode loop vs prefill, last prompt step, fp32, batch {SERVE_BATCH} x "
        f"{SERVE_PROMPT}, capacity factor {MOE_NODROP_CF} ({dropped_d} pairs dropped in "
        f"either): with the prefill's routing replayed rel_l2 {err_d:.3e} (tol "
        f"max({FP32_TOL}, floor)), floor (the plain prefill vs the kernel's) {floor_d:.3e}; "
        f"free routing rel_l2 {free_err_d:.3e}, argmax agreement "
        f"{float((free_dec.argmax(-1) == pre.argmax(-1)).float().mean()):.2f}, routed alike "
        f"{agree_d:.6f} of {SERVE_BATCH * SERVE_PROMPT * cfg.top_k * cfg.n_layers} pairs "
        f"({flips_d} differ)")
    if dropped_d or not (err_d <= max(FP32_TOL, floor_d) and torch.isfinite(free_dec).all()):
        raise AssertionError(f"moe decode loop disagrees with prefill: rel_l2 {err_d:.3e}, "
                             f"floor {floor_d:.3e}, {dropped_d} pairs dropped")
    out = {"prefill_rel_l2": err, "prefill_floor_rel_l2": floor,
           "free_prefill_rel_l2": free_err, "free_prefill_floor_rel_l2": free_floor,
           "routing_agree": agree_k, "routing_pairs_differ": flips_k,
           "routing_agree_floor": agree_c, "routing_pairs_differ_floor": flips_c,
           "pairs_dropped": dropped, "decode_rel_l2": err_d, "decode_floor_rel_l2": floor_d,
           "free_decode_rel_l2": free_err_d,
           "decode_routing_agree": agree_d, "decode_pairs_differ": flips_d}
    del dec, free_dec, pre, pre_plain, log_d, log_pre
    torch.cuda.empty_cache()
    return cfg, params, out


def phase_moe_train(cfg, params, smi) -> dict:
    """fp32 training at full width and 4 layers: the kernel-vs-plain gate on loss and
    gradients beside the floor of two plain paths, and against the flash op in
    fp64 beside the plain path's distance from it, with the routing's agreement;
    then 3 timed AdamW steps through the kernel."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    n_params = sum(p.numel() for _, p in _named_leaves(params))

    def batch_of(step):
        return {k: torch.from_numpy(v).cuda()
                for k, v in make_batch(cfg, TRAIN_LEN, TRAIN_BATCH, step=step).items()}

    batch = batch_of(0)
    chunked_cfg = dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK)
    paths = (("kernel", cfg, True), ("chunked", chunked_cfg, False), ("plain", cfg, False))
    # free routing: each path routes its own activations; (token, choice) pairs
    # near a top-k tie or at the capacity move between paths, and each moves one
    # token's output by O(1).  The loss is gated; the gradients are only printed.
    free, logs = {}, {}
    for name, c, use_kernel in paths:
        with _routing_log() as logs[name]:
            run = _loss_and_grads(c, params, batch, use_kernel=use_kernel)
        run["norm"] = float(opt.global_norm(run.pop("grads")))
        free[name] = run
        torch.cuda.empty_cache()
    agree_k, flips_k, dropped = _routing_agreement(logs["kernel"], logs["plain"])
    agree_c, flips_c, _ = _routing_agreement(logs["chunked"], logs["plain"])
    fk, fc, fp = free["kernel"], free["chunked"], free["plain"]
    free_loss, free_loss_floor = (abs(r["loss"] - fp["loss"]) / abs(fp["loss"]) for r in (fk, fc))
    free_norm, free_norm_floor = (abs(r["norm"] - fp["norm"]) / fp["norm"] for r in (fk, fc))
    log(f"[moe-train] free routing, {cfg.name} at {cfg.n_layers} layers, fp32, batch "
        f"{TRAIN_BATCH} x {TRAIN_LEN}, remat: loss kernel {fk['loss']:.7f} plain "
        f"{fp['loss']:.7f} chunked {fc['loss']:.7f} (kernel rel {free_loss:.2e}, floor "
        f"{free_loss_floor:.2e}, tol max({LOSS_RTOL}, floor)); grad norm kernel "
        f"{fk['norm']:.6e} plain {fp['norm']:.6e} chunked {fc['norm']:.6e} (kernel rel "
        f"{free_norm:.2e}, chunked rel {free_norm_floor:.2e}; not gated); routing (forward and "
        f"remat recompute): kernel vs plain agree on {agree_k:.6f} ({flips_k} pairs differ), "
        f"chunked vs plain {agree_c:.6f} ({flips_c} differ), {dropped} pairs dropped in all")
    if not (free_loss <= max(LOSS_RTOL, free_loss_floor) and math.isfinite(fk["loss"])):
        raise AssertionError(f"moe training: the kernel's loss is {free_loss:.3e} off the "
                             f"plain path's (floor {free_loss_floor:.3e})")

    # the gate: every path takes the plain path's routing, so the paths differ
    # only continuously, and the floor of two plain paths bounds the kernel again
    @contextlib.contextmanager
    def replayed(name):
        with _replayed_routing(logs["plain"]), _routing_log() as seen:
            yield
        if _routing_agreement(seen, logs["plain"])[1]:
            raise AssertionError(f"moe training: the {name} path's replayed routing differs")

    gate = {"free_loss_rel": free_loss, "free_loss_floor": free_loss_floor,
            "free_norm_rel": free_norm, "free_norm_floor": free_norm_floor,
            "routing_agree": agree_k, "routing_pairs_differ": flips_k,
            "routing_agree_floor": agree_c, "routing_pairs_differ_floor": flips_c,
            **_train_gate(cfg, params, batch, "moe", around=replayed)}
    del logs

    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                           schedule=cfg.schedule)
    step_fn = st.make_train_step(cfg, ocfg, st.TrainOptions(use_kernel=True, remat=True))
    ostate = opt.init(params)
    batches = [batch_of(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, per_step = [], []
    for s in range(TRAIN_STEPS):
        before = fa.launches
        t0 = time.perf_counter()
        params, ostate, m = step_fn(params, ostate, batches[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(fa.launches - before)
        loss, aux, gnorm = float(m["loss"]), float(m["aux"]), float(m["grad_norm"])
        log(f"[moe-train] step {s + 1}: loss {loss:.6f} aux {aux:.6f} (x {st.TrainOptions().moe_aux_weight} "
            f"in the objective) grad_norm {gnorm:.6e} {secs[-1]:.3f}s "
            f"({TRAIN_BATCH * TRAIN_LEN / secs[-1]:.0f} tok/s), flash launches {per_step[-1]}")
        if not (math.isfinite(loss) and math.isfinite(aux) and aux > 0 and math.isfinite(gnorm)):
            raise AssertionError(f"moe training step {s + 1}: loss {loss}, aux {aux}, "
                                 f"grad norm {gnorm}")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if (per_step != [2 * cfg.n_layers] * TRAIN_STEPS or launches["rmsnorm"] != 0
            or launches["flash_attention_fwd_tf32"] != launches["flash_attention_fwd"]):
        raise AssertionError(f"moe training steps launched {per_step} flash kernels a step, "
                             f"want {2 * cfg.n_layers}, all tf32: {launches}")
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    log(f"[moe-train] {cfg.name} at {cfg.n_layers} layers, fp32, {n_params / 1e9:.3f}G params, "
        f"batch {TRAIN_BATCH} x {TRAIN_LEN}, remat, AdamW: {TRAIN_STEPS} steps in "
        f"{[round(x, 3) for x in secs]} s; steady {steady:.3f} s/step "
        f"({TRAIN_BATCH * TRAIN_LEN / steady:.0f} tok/s); peak {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB); launches {launches} [{smi}]")
    with _spans() as ms:
        t0 = time.perf_counter()
        step_fn(params, ostate, batches[0])
        torch.cuda.synchronize()
        t_span = time.perf_counter() - t0
    log(f"[moe-train] device time by part over one step ({t_span * 1e3:.1f} ms on the host "
        f"clock; each span's own device time, forward, recompute and backward): "
        f"{_span_line(ms, t_span * 1e3)}")
    _profile("one moonshot train step", lambda: step_fn(params, ostate, batches[0]))
    del params, ostate, batches, batch, m
    torch.cuda.empty_cache()
    return {"launches": launches, "gate": gate, "steps_s": secs, "steady_s": steady,
            "peak_gib": peak / 2**30, "spans_ms": ms, "span_wall_ms": t_span * 1e3}


def phase_moe_ep(smi) -> dict:
    """One moonshot MoE layer at full width in fp32, expert-parallel over a
    ``LocalMesh`` of 4 rank threads on cuda:0 (16 experts a rank; tokens
    replicated, as check_moe_ep), against ``moe_apply`` on the card; the
    all-to-all bytes against the slab sizes.  Forward only: the ranks' backwards
    would share the card's one autograd thread (``_pipeline_probe``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import LocalMesh
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    d, f, e, k, n = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, MOE_EP_RANKS
    gen = torch.Generator("cuda").manual_seed(0)
    scale = cfg.n_layers ** -0.5  # a layer of the model's init (fan-in L)

    def rnd(*shape, s=scale):
        return torch.randn(shape, generator=gen, device="cuda").mul_(s)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = {"router": rnd(d, e), "w_gate": rnd(e, d, f), "w_up": rnd(e, d, f),
              "w_down": rnd(e, f, d)}
    x = rnd(1, PREFILL_LEN, d, s=1.0)
    cap = moe.capacity(PREFILL_LEN, k, e, cfg.capacity_factor)
    with torch.no_grad(), _routing_log() as log_ref:
        want, want_aux = moe.moe_apply(x, params, k, cfg.capacity_factor)
    el = e // n
    local = [{"router": params["router"],
              **{w: params[w][i * el:(i + 1) * el] for w in ("w_gate", "w_up", "w_down")}}
             for i in range(n)]
    mesh = LocalMesh((n,), ("model",), "cuda")

    def rank_fn(comm, p):
        with torch.no_grad():
            return moe.moe_apply_ep(comm, x, p, k, cfg.capacity_factor, "model")

    with _routing_log() as log_ep:
        outs, counts, times = _run_timed(mesh, rank_fn, [local])
    tol = MOE_EP_RTOL * float(want.abs().max())
    errs = []
    for r, (y, aux) in enumerate(outs):
        errs.append(float((y - want).abs().max()))
        if not torch.allclose(y, want, rtol=MOE_EP_RTOL, atol=tol) or \
                abs(float(aux) - float(want_aux)) > 1e-5 * abs(float(want_aux)):
            raise AssertionError(f"[moe-ep] rank {r}: max |err| {errs[-1]:.3e} against "
                                 f"moe_apply (atol {tol:.3e}), aux {float(aux)} vs "
                                 f"{float(want_aux)}")
    # every rank routes the same tokens as moe_apply's one group
    for flat_e, keep in log_ep[:n]:
        if not (torch.equal(flat_e, log_ref[0][0]) and torch.equal(keep, log_ref[0][1])):
            raise AssertionError("[moe-ep] a rank's routing differs from moe_apply's")
    slab = e * cap * d * 4
    want_rank = 2 * slab * (n - 1) // n
    sent = collections.Counter()
    for (src, _), b in counts["bytes"].items():
        sent[src] += b
    if set(sent.values()) != {want_rank} or len(sent) != n or \
            set(counts["bytes"].values()) != {2 * slab // n}:
        raise AssertionError(f"[moe-ep] all_to_all bytes {dict(counts['bytes'])}, want "
                             f"{want_rank} a rank")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    dropped = int((~log_ref[0][1]).sum())
    log(f"[moe-ep] one {cfg.name} MoE layer, fp32, {e} experts over {n} rank threads on "
        f"cuda:0 ({el} a rank), tokens B 1 x S {PREFILL_LEN} replicated, capacity factor "
        f"{cfg.capacity_factor} (cap {cap} in both paths, {dropped} of {PREFILL_LEN * k} pairs "
        f"dropped): moe_apply_ep against moe_apply max |err| {max(errs):.3e} (max |y| "
        f"{float(want.abs().max()):.3e}, rtol {MOE_EP_RTOL}, atol {tol:.3e}), routing equal; "
        f"all_to_all bytes a rank {want_rank:,} = 2 x 3/4 x the ({e}, {cap}, {d}) fp32 slab "
        f"({slab / 1e6:.1f} MB), {sum(counts['messages'].values())} messages; "
        f"{statistics.median(times):.2f} ms median of {SYNC_REPS} "
        f"({', '.join(f'{t:.2f}' for t in times)}; in-process transport); peak {peak:.2f} GiB "
        f"above the phase's start [{smi}]")
    del params, local, x, want, outs
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "bytes_a_rank": want_rank, "slab_bytes": slab,
            "cap": cap, "ms": statistics.median(times), "ms_runs": times, "peak_gib": peak,
            "pairs_dropped": dropped}


# ---------------------------------------------------------------------------
# the SSM (mamba2-130m) and hybrid (recurrentgemma-9b) families: no kernel
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "mamba2-130m", "recurrentgemma-9b"
SSD_RAGGED = 1000  # a ragged length for the SSD check (4 chunks of 256, the last padded)
SSM_OTHER_CHUNK = 64  # the SSM's floor: the prefill at ssm_chunk 64 against 256
ALGO_TOL = 1e-10  # a chunked or log-depth scan against its loop, both in fp64
# recurrentgemma-9b's fp32 phases run one (rec, rec, attn) block and the 38-layer
# model's tail of 2 recurrent layers: 3.22G params, 51.5 GB of training state
# (38 layers: 167 GB).  dense_init draws a stack of L layers at scale
# 1/sqrt(L), so the cut stacks (rec 2, attn 1) are scaled to the 38-layer
# model's (rec 24, attn 12; the tail has 2 either way).
HYBRID_LAYERS = 5
HYBRID_OTHER_CHUNK = 32  # the hybrid's floor: chunked attention at 128 tokens vs dense
HYBRID_TRAIN_BATCH = 2


class _Stop(Exception):
    pass


def _first_call_args(module, name: str, run) -> tuple:
    """The arguments of the first call of ``module.name`` while ``run()`` runs; the
    run stops there."""
    from unittest import mock

    seen = []

    def spy(*args, **kwargs):
        seen.append(args)
        raise _Stop

    with mock.patch.object(module, name, spy), torch.no_grad():
        try:
            run()
        except _Stop:
            pass
    return seen[0]


def _expect_launches(label: str, **by_variant) -> dict:
    """The launch counts since the last reset, which must be ``by_variant``'s flash
    launches (e.g. ``sm90=28``) and no other.  The SSM and hybrid families reach
    no kernel, in JAX or in the port (``use_kernel`` is ignored, as JAX's ``**_``
    ignores it); no model calls RMSNorm."""
    from repro_torch.kernels import flash_attention as fa

    counts = _counts()
    want = {"flash_attention_fwd": sum(by_variant.values()), "rmsnorm": 0,
            **{f"flash_attention_fwd_{v}": by_variant.get(v, 0) for v in fa.SOURCES}}
    if counts != want:
        raise AssertionError(f"{label} launched {counts}, want {want}")
    return counts


def _batch_extras(batch: dict) -> dict:
    """The batch's model inputs beside the tokens, on the card."""
    from repro_torch.train.steps import model_extras
    return {k: torch.from_numpy(v).cuda() for k, v in model_extras(batch).items()}


def _family_prefill(cfg, params, tag: str, smi, sm90: int = 0, extras=None) -> dict:
    """bf16 prefill at batch 4 x 2048 through ``make_prefill_step(use_kernel=True)``:
    one warm-up call, three timed (their median), the peak, one profiled call; each
    call launches the sm90 kernel ``sm90`` times and nothing else.  ``extras``
    replaces the batch's positions or frames."""
    from repro_torch.data.pipeline import make_batch

    batch = make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    extras = extras or _batch_extras(batch)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(4):
        _reset_counts()
        logits, t = _prefill(cfg, params, tokens, use_kernel=True, extras=extras)
        launches = _expect_launches(f"{cfg.name} prefill", sm90=sm90)
        if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} prefill logits {tuple(logits.shape)} not finite "
                                 "or misshapen")
        secs.append(t)
    median = sorted(secs[1:])[1]
    peak = torch.cuda.max_memory_allocated()
    ntok = PREFILL_BATCH * PREFILL_LEN
    log(f"[{tag}-prefill] {cfg.name} bf16 batch {PREFILL_BATCH} x {PREFILL_LEN}: {median:.3f}s "
        f"median of 3 after a warm-up ({ntok / median:.0f} tok/s; calls "
        f"{[round(x, 3) for x in secs]} s), launches a call {launches}, peak "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) [{smi}]")
    _profile(f"one {cfg.name} bf16 prefill",
             lambda: _prefill(cfg, params, tokens, True, extras=extras))
    return {"prefill_s": median, "prefill_calls_s": secs, "prefill_peak_gib": peak / 2**30,
            "prefill_tok_s": ntok / median, "launches": launches}


def _family_serve(cfg, params, tag: str, smi) -> dict:
    """The serving loop of ``launch/serve.py`` in bf16 (batch 4, prompt 128, 32 decoded)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import serve

    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    _reset_counts()
    res = serve(cfg, params, prompts, SERVE_DECODE)
    launches = _expect_launches(f"{cfg.name} serve")
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_DECODE) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name} serve returned bad tokens {tuple(toks.shape)}")
    log(f"[{tag}-serve] {cfg.name} bf16 batch {SERVE_BATCH}: prompt {SERVE_PROMPT} "
        f"teacher-forced in {res['prefill_s']:.3f}s "
        f"({res['prefill_s'] / SERVE_PROMPT * 1e3:.2f} ms a step); decoded {SERVE_DECODE} "
        f"toks/seq in {res['decode_s']:.3f}s ({SERVE_BATCH * SERVE_DECODE / res['decode_s']:.1f} "
        f"tok/s, {res['decode_s'] / SERVE_DECODE * 1e3:.2f} ms a step); launches {launches}; "
        f"sample {toks[0, :8].tolist()} [{smi}]")
    return {"decode_tok_s": SERVE_BATCH * SERVE_DECODE / res["decode_s"],
            "decode_ms_step": res["decode_s"] / SERVE_DECODE * 1e3,
            "prompt_ms_step": res["prefill_s"] / SERVE_PROMPT * 1e3, "launches": launches}


def _decode_vs_prefill(cfg, params, prompts, other_cfg, other_label: str, tag: str,
                       order_gate: bool = True) -> dict:
    """fp32: the decode loop's logits at the last prompt step against the prefill
    step's.  Two gates.  Accuracy: the decode's distance from the prefill with
    the weights in fp64 (where the model computes in fp32 by design, in norms,
    softmax and RoPE, it still does) at most max(FP32_TOL, twice the fp32
    prefill's).  Order (``order_gate``): decode vs prefill within
    max(FP32_TOL, floor), the floor being the prefill of ``other_cfg`` (another
    fp32 summation order) against the prefill.  Both families amplify rounding
    where that floor does not look (an RG-LRU decay a near 1 scales its input's
    error by ~1/(1 - a) in sqrt(1 - a^2); an SSD decay matrix subtracts
    cumulative sums up to ~1.8e4), so past the hybrid's window, 2112 steps in,
    only the accuracy gate is applied."""
    from repro_torch import tree as tree_lib

    dec = _decode_prompt(cfg, params, prompts)
    pre, _ = _prefill(cfg, params, prompts, use_kernel=False)
    other, _ = _prefill(other_cfg, params, prompts, use_kernel=False)
    params64 = tree_lib.tree_map(lambda t: t.double(), params)
    pre64, _ = _prefill(cfg, params64, prompts, use_kernel=False)
    del params64
    torch.cuda.empty_cache()
    r = {"decode_vs_prefill": rel_l2(dec, pre), "floor": rel_l2(other, pre),
         "decode_vs_fp64": rel_l2(dec, pre64), "prefill_vs_fp64": rel_l2(pre, pre64),
         "argmax_agree": float((dec.argmax(-1) == pre.argmax(-1)).float().mean()),
         "steps": prompts.shape[1]}
    tol_acc = max(FP32_TOL, 2 * r["prefill_vs_fp64"])
    tol_order = max(FP32_TOL, r["floor"])
    log(f"[{tag}] {cfg.name} fp32 decode vs prefill logits at the last of {prompts.shape[1]} "
        f"prompt steps (batch {prompts.shape[0]}): rel_l2 {r['decode_vs_prefill']:.3e}, "
        + (f"tol max({FP32_TOL}, floor) = {tol_order:.3e}" if order_gate else "not gated")
        + f" (floor: {other_label} {r['floor']:.3e}); argmax agreement "
          f"{r['argmax_agree']:.2f}; from the prefill on fp64 weights: decode "
          f"{r['decode_vs_fp64']:.3e}, tol max({FP32_TOL}, 2 x the fp32 prefill's "
          f"{r['prefill_vs_fp64']:.3e}) = {tol_acc:.3e}")
    if not (r["decode_vs_fp64"] <= tol_acc and torch.isfinite(dec).all()
            and (r["decode_vs_prefill"] <= tol_order or not order_gate)):
        raise AssertionError(f"{cfg.name}: the decode loop disagrees with the prefill: {r}")
    return r


def _family_train(cfg, params, batch_size: int, tag: str, smi, tf32: int = 0) -> dict:
    """fp32 training at batch_size x 2048 with remat: 3 timed AdamW steps through
    ``make_train_step`` (``use_kernel=True``), each launching the tf32 kernel
    ``tf32`` times and nothing else (the SSM and hybrid families ignore
    ``use_kernel``), then one profiled step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    n_params = sum(p.numel() for _, p in _named_leaves(params))
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                           schedule=cfg.schedule)
    step_fn = st.make_train_step(cfg, ocfg, st.TrainOptions(use_kernel=True, remat=True))
    ostate = opt.init(params)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in make_batch(cfg, TRAIN_LEN, batch_size, step=s).items()}
               for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    secs, losses, per_step = [], [], []
    for s in range(TRAIN_STEPS):
        before = fa.launches
        t0 = time.perf_counter()
        params, ostate, m = step_fn(params, ostate, batches[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(fa.launches - before)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        log(f"[{tag}-train] step {s + 1}: loss {loss:.6f} grad_norm {gnorm:.6e} "
            f"{secs[-1]:.3f}s ({batch_size * TRAIN_LEN / secs[-1]:.0f} tok/s), flash "
            f"launches {per_step[-1]}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{cfg.name} training step {s + 1}: loss {loss}, "
                                 f"grad norm {gnorm}")
    launches = _expect_launches(f"{cfg.name} training", tf32=TRAIN_STEPS * tf32)
    if per_step != [tf32] * TRAIN_STEPS:
        raise AssertionError(f"{cfg.name} training launched {per_step} flash kernels a step, "
                             f"want {tf32}")
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    log(f"[{tag}-train] {cfg.name} at {cfg.n_layers} layers, fp32, {n_params / 1e9:.3f}G "
        f"params, batch {batch_size} x {TRAIN_LEN}, remat, AdamW: {TRAIN_STEPS} steps in "
        f"{[round(x, 3) for x in secs]} s; steady {steady:.3f} s/step "
        f"({batch_size * TRAIN_LEN / steady:.0f} tok/s); peak {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB); launches {launches} [{smi}]")
    _profile(f"one {cfg.name} train step", lambda: step_fn(params, ostate, batches[0]))
    del ostate, batches, m
    return {"steps_s": secs, "steady_s": steady, "losses": losses, "batch": batch_size,
            "n_params": n_params, "peak_gib": peak / 2**30, "launches": launches}


def _ssd_sequential(x, dt, A, B, C):
    """The SSD as its recurrence, a step at a time in fp64 (tests/test_models.py's)."""
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * A)[..., None, None]
                 + torch.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], state))
    return torch.stack(ys, 1), state


def _ssd_checks(x, dt, A, B, C, chunk) -> dict:
    """``ssd_chunked`` on one layer's inputs against the recurrence in fp64: in fp64
    (the algorithm, to ALGO_TOL) and in fp32 (the model's arithmetic).  In fp32
    each decay is a sum of its own terms (``mamba2._segsum``), at fp32's relative
    error; the fp32 gate, max(1e-4, 2^-23·max|c|), is what a decay exp(c_i - c_j)
    of two cumulative sums rounded to fp32 (the JAX version's) would reach."""
    from repro_torch.models import mamba2

    out = {}
    for s in (x.shape[1], SSD_RAGGED):
        args = (x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s])
        y_ref, st_ref = _ssd_sequential(*args)
        y64, st64 = mamba2.ssd_chunked(*(a.double() for a in args), chunk)
        y32, st32 = mamba2.ssd_chunked(*args, chunk)
        dA = (dt[:, :s] * A).double().abs()
        max_cs = max(float(dA[:, c0:c0 + chunk].sum(1).max()) for c0 in range(0, s, chunk))
        bound = max(1e-4, 2.0 ** -23 * max_cs)
        err32 = (y32.double() - y_ref).abs()
        r = {"fp64_y": rel_l2(y64, y_ref), "fp64_state": rel_l2(st64, st_ref),
             "fp32_y": rel_l2(y32, y_ref), "fp32_state": rel_l2(st32, st_ref),
             "fp32_max_abs": float(err32.max()), "max_abs_y": float(y_ref.abs().max()),
             "fp32_share_outside_1e-4": float((err32 > 1e-5 + 1e-4 * y_ref.abs())
                                               .double().mean()),
             "max_cumsum": max_cs, "fp32_bound": bound}
        log(f"[ssd] S {s} (B {x.shape[0]}, H {x.shape[2]}, P {x.shape[3]}, N {B.shape[-1]}, "
            f"chunk {chunk}) against the recurrence in fp64: fp64 y {r['fp64_y']:.2e} state "
            f"{r['fp64_state']:.2e} (tol {ALGO_TOL}); fp32 y {r['fp32_y']:.2e} state "
            f"{r['fp32_state']:.2e} (tol max(1e-4, 2^-23 x max|cumsum dA| {max_cs:.1f}) = "
            f"{bound:.2e}), max_abs_err {r['fp32_max_abs']:.3e} on |y| <= "
            f"{r['max_abs_y']:.1f}, {r['fp32_share_outside_1e-4']:.2%} of elements outside "
            f"rtol 1e-4 / atol 1e-5")
        if not (r["fp64_y"] <= ALGO_TOL and r["fp64_state"] <= ALGO_TOL
                and r["fp32_y"] <= bound and r["fp32_state"] <= bound):
            raise AssertionError(f"ssd_chunked at S {s} disagrees with the recurrence: {r}")
        out[s] = r
        del y_ref, y64, y32, err32
    return out


def phase_ssm(smi) -> dict:
    """mamba2-130m at full width and depth: the SSD check on layer 0's inputs, bf16
    prefill and serving, fp32 decode against prefill, fp32 training."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import get_model, mamba2

    cfg = get_config(SSM_ARCH)
    desc = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {mamba2.dims(cfg)[1]} heads of "
            f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}")
    params32, _ = _load_model(cfg, "ssm", torch.float32, desc)
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, 1)["tokens"]).cuda()
    x, dt, A, B, C, chunk, _ = _first_call_args(
        mamba2, "ssd_chunked", lambda: get_model(cfg).forward(cfg, params32, tokens, remat=False))
    out = {"ssd": _ssd_checks(x, dt, A, B, C, chunk)}
    del x, dt, A, B, C

    params, _ = _load_model(cfg, "ssm", desc=desc)
    out.update(_family_prefill(cfg, params, "ssm", smi))
    out["serve"] = _family_serve(cfg, params, "ssm", smi)
    del params
    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    out["decode_vs_prefill"] = _decode_vs_prefill(
        cfg, params32, prompts, dataclasses.replace(cfg, ssm_chunk=SSM_OTHER_CHUNK),
        f"ssm_chunk {SSM_OTHER_CHUNK} vs {cfg.ssm_chunk}", "ssm")
    out["train"] = _family_train(cfg, params32, TRAIN_BATCH, "ssm", smi)
    del params32
    torch.cuda.empty_cache()
    return out


def _rglru_checks(d: int, init_depth: int) -> dict:
    """``rglru`` (the log-depth scan) against a loop of ``rglru_step`` at B 1 x 2048
    x d, forward and gradient, both in fp64 (to ALGO_TOL); and both in fp32 (the
    relation of tests/test_models.py::test_rglru_scan_matches_step, to its rtol
    1e-5 as relative L2), each beside its distance from the fp64 loop.  In fp32
    a decay a = 1 - δ near 1 is rounded to ~3e-8, and a state kept over up to
    2048 steps carries that many roundings, so both fp32 paths sit further
    from fp64 than from each other.  The weights at ``dense_init``'s scale for
    ``init_depth`` stacked layers."""
    from repro_torch.models import recurrentgemma as rg

    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float64) * scale

    lp = {"w_a": rnd(d, d, scale=init_depth ** -0.5), "w_i": rnd(d, d, scale=init_depth ** -0.5),
          "lambda_p": torch.full((d,), 0.5, dtype=torch.float64, device=gen.device)}
    x, h0 = rnd(1, PREFILL_LEN, d), rnd(1, d)
    cot_y, cot_h = rnd(1, PREFILL_LEN, d), rnd(1, d)

    def grads(fn):
        leaves = [x, h0, lp["w_a"], lp["w_i"], lp["lambda_p"]]
        views = [t.detach().requires_grad_(True) for t in leaves]
        y, h = fn(views[0], dict(zip(("w_a", "w_i", "lambda_p"), views[2:])), views[1])
        g = torch.autograd.grad((y * cot_y).sum() + (h * cot_h).sum(), views)
        return y.detach(), h.detach(), g

    def loop(xx, p, hh):
        ys = []
        for t in range(xx.shape[1]):
            yt, hh = rg.rglru_step(xx[:, t:t + 1], p, hh)
            ys.append(yt)
        return torch.cat(ys, 1), hh

    t0 = time.perf_counter()
    y_s, h_s, g_s = grads(rg.rglru)
    y_l, h_l, g_l = grads(loop)
    names = ("x", "h0", "w_a", "w_i", "lambda_p")
    r = {"fp64_y": rel_l2(y_s, y_l), "fp64_h": rel_l2(h_s, h_l),
         **{f"fp64_grad_{n}": rel_l2(a, b) for n, a, b in zip(names, g_s, g_l)}}
    args32 = (x.float(), {k: v.float() for k, v in lp.items()}, h0.float())
    with torch.no_grad():
        y32, h32 = rg.rglru(*args32)
        y32_l, h32_l = loop(*args32)
    r.update(fp32_y=rel_l2(y32, y32_l), fp32_h=rel_l2(h32, h32_l))
    vs64 = {"scan_y": rel_l2(y32, y_l), "scan_h": rel_l2(h32, h_l),
            "loop_y": rel_l2(y32_l, y_l), "loop_h": rel_l2(h32_l, h_l)}
    a, _ = rg._gates(x, lp)
    log(f"[rglru] B 1 x {PREFILL_LEN} x {d} (weights at the {init_depth}-layer scale, a in "
        f"[{float(a.min()):.2e}, {float(a.max()):.8f}]): scan vs step loop in fp64: "
        + ", ".join(f"{k[5:]} {v:.2e}" for k, v in r.items() if k.startswith("fp64"))
        + f" (tol {ALGO_TOL}); in fp32: y {r['fp32_y']:.2e}, h {r['fp32_h']:.2e} (tol 1e-5); "
          "from the fp64 loop, the fp32 scan " + f"y {vs64['scan_y']:.2e} h "
          f"{vs64['scan_h']:.2e}, the fp32 loop y {vs64['loop_y']:.2e} h {vs64['loop_h']:.2e}; "
          f"{time.perf_counter() - t0:.1f}s")
    r["fp32_from_fp64"] = vs64
    bad = [k for k, v in r.items() if k != "fp32_from_fp64"
           and v > (ALGO_TOL if k.startswith("fp64") else 1e-5)]
    if bad:
        raise AssertionError(f"rglru's scan disagrees with its step loop: {bad}: {r}")
    return r


def _hybrid_desc(cfg) -> str:
    return (f"{cfg.n_layers} layers ({cfg.n_layers // 3} x (rec, rec, attn) + "
            f"{cfg.n_layers % 3} rec), d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} "
            f"heads ({cfg.n_kv_heads} kv) of {cfg.kq_head_dim}, window {cfg.local_window}, "
            f"vocab {cfg.vocab}")


def _hybrid_fp32_model():
    """recurrentgemma-9b cut to HYBRID_LAYERS layers at full width, fp32, each
    cut stack scaled to the 38-layer model's init (the comment at HYBRID_LAYERS)."""
    from repro_torch.configs import get_config
    from repro_torch.models import recurrentgemma as rg

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    params, _ = _load_model(cfg, "hybrid", torch.float32, _hybrid_desc(cfg))
    (_, nb, nr, nt), (_, nb_full, nr_full, nt_full) = rg._layout(cfg), rg._layout(full)
    for tree, n, n_full in ((params["blocks"]["rec"], nr, nr_full),
                            (params["blocks"]["attn"], nb, nb_full),
                            (params["tail"], nt, nt_full)):
        _rescale_stacks(tree, n, n_full, skip=("conv_w", "lambda_p"))
    return full, cfg, params


def phase_hybrid(smi) -> dict:
    """recurrentgemma-9b: the RG-LRU check at full width, bf16 prefill and serving at
    full width and depth, then fp32 at HYBRID_LAYERS layers: decode against prefill
    (a 128-token prompt, and past the 2048-token window) and training."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch

    cfg = get_config(HYBRID_ARCH)
    out = {"rglru": _rglru_checks(cfg.d_model, init_depth=24)}
    params, sizes = _load_model(cfg, "hybrid", desc=_hybrid_desc(cfg))
    out.update(sizes)
    out.update(_family_prefill(cfg, params, "hybrid", smi))
    out["serve"] = _family_serve(cfg, params, "hybrid", smi)
    del params
    torch.cuda.empty_cache()

    full, cfg, params = _hybrid_fp32_model()
    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    out["decode_vs_prefill"] = _decode_vs_prefill(
        cfg, params, prompts, dataclasses.replace(cfg, attn_chunk=HYBRID_OTHER_CHUNK),
        f"chunked attention ({HYBRID_OTHER_CHUNK}) vs dense", "hybrid")
    long = torch.from_numpy(make_batch(cfg, cfg.local_window + 64, 1)["tokens"]).cuda()
    out["decode_vs_prefill_past_window"] = _decode_vs_prefill(
        cfg, params, long, dataclasses.replace(cfg, attn_chunk=cfg.local_window + 64),
        "dense vs chunked attention", "hybrid", order_gate=False)
    out["train"] = _family_train(cfg, params, HYBRID_TRAIN_BATCH, "hybrid", smi)
    del params
    torch.cuda.empty_cache()
    return out


# qwen2-vl-7b (the VLM family: M-RoPE over (t, h, w) positions, GQA 28 / 4 heads of
# 128) and whisper-tiny (the audio family: an encoder over 1500 frames and a decoder
# with cross-attention).  Both reach the flash kernel in the decoder's
# self-attention only, as in JAX.  qwen2-vl-7b's fp32 phases run VLM_LAYERS of its
# 28 layers: 2.95G params, ~47 GB of training state (28 layers: ~122 GB);
# dense_init draws a stack of L at 1/sqrt(L), so the cut stacks are scaled by
# sqrt(VLM_LAYERS / 28) to the 28-layer init.  whisper-tiny runs whole.
VLM_ARCH, AUDIO_ARCH = "qwen2-vl-7b", "whisper-tiny"
VLM_LAYERS = 8
VLM_OTHER_CHUNK = 32  # the VLM's decode floor: chunked attention at 128 tokens vs dense
# the image-like positions: text runs of IMAGE_TEXT tokens between images of
# IMAGE_GRID (frames, rows, columns) patches
IMAGE_TEXT, IMAGE_GRID = 64, (2, 16, 24)


def _image_positions(b: int, s: int) -> torch.Tensor:
    """(3, B, S) M-RoPE positions, Qwen2-VL's way, of text runs and images in turn:
    text carries t == h == w counting on; an image's patches carry t constant over
    a frame and h, w walking its grid from the image's first position; the text
    after an image counts on from the largest position before it."""
    rows, nxt, n = [], 0, 0
    while n < s:
        text = nxt + torch.arange(IMAGE_TEXT)
        grid = torch.stack(torch.meshgrid(*(torch.arange(g) for g in IMAGE_GRID),
                                          indexing="ij")).reshape(3, -1)
        image = text[-1] + 1 + grid
        rows += [text.expand(3, -1), image]
        nxt, n = int(image.max()) + 1, n + IMAGE_TEXT + image.shape[1]
    pos = torch.cat(rows, 1)[:, :s]
    return pos[:, None].expand(3, b, s).to(torch.int32).contiguous().cuda()


def _prefill_gate(cfg, params, tokens, extras, tag: str) -> dict:
    """fp32 prefill through the tf32 kernel (one launch a layer) against the plain
    path: the last position's logits within max(FP32_TOL, floor), the floor being
    the plain chunked path (FLOOR_CHUNK) against plain dense."""

    def run(c, use_kernel):  # the last position's logits, not a view of all
        logits, secs = _prefill(c, params, tokens, use_kernel, extras=extras)
        return logits.clone(), secs

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with_k, t_k = run(cfg, True)
    launches = _expect_launches(f"{cfg.name} fp32 prefill", tf32=cfg.n_layers)
    plain, t_p = run(cfg, False)
    chunked, _ = run(dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK), False)
    err, floor = rel_l2(with_k, plain), rel_l2(chunked, plain)
    log(f"[{tag}] {cfg.name} at {cfg.n_layers} layers, fp32, batch {tokens.shape[0]} x "
        f"{tokens.shape[1]}: kernel vs plain logits rel_l2 {err:.3e} (tol max({FP32_TOL}, "
        f"floor)), floor (plain chunked {FLOOR_CHUNK} vs plain dense) {floor:.3e}, max_abs_err "
        f"{float((with_k - plain).abs().max()):.3e} on max|logit| "
        f"{float(plain.abs().max()):.3e}, same argmax "
        f"{bool((with_k.argmax(-1) == plain.argmax(-1)).all())}; {t_k:.3f}s with kernel, "
        f"{t_p:.3f}s plain; launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (err <= max(FP32_TOL, floor) and torch.isfinite(with_k).all()):
        raise AssertionError(f"{cfg.name} fp32 prefill with kernel disagrees with plain: "
                             f"rel_l2 {err:.3e}, floor {floor:.3e}")
    return {"rel_l2": err, "floor": floor, "kernel_s": t_k, "plain_s": t_p,
            "launches": launches}


def _reference_runs(cfg, params, batch, around=None) -> tuple[dict, dict]:
    """The training gates' four fp32 runs of ``cfg``'s loss and gradients (remat)
    on ``params`` and ``batch``: through the kernel, the plain path chunked at
    FLOOR_CHUNK, the kernel with the flash op computed in fp64, and the plain
    dense path; ``around(name)``, where given, is the context each runs in (the
    MoE gate's replayed routing).  Returns the runs (loss, global norm, launches,
    seconds, peak) and the gradients by leaf name of every run but the plain one
    on the host; the plain run's stay on the card, under its ``"grads"``.  The
    kernel launches twice a layer (forward and remat recompute), all tf32; the
    other runs, never."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import optimizer as opt

    runs, host = {}, {}
    for name, c, use_kernel in (("kernel", cfg, True),
                                ("chunked", dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK),
                                 False),
                                ("fp64", cfg, True),
                                ("plain", cfg, False)):
        with (around(name) if around else contextlib.nullcontext(),
              mock.patch.object(fa, "launch", _attention_fp64) if name == "fp64"
              else contextlib.nullcontext()):
            runs[name] = _loss_and_grads(c, params, batch, use_kernel=use_kernel)
        runs[name]["norm"] = float(opt.global_norm(runs[name]["grads"]))
        if name != "plain":  # keep on the host, free the card
            host[name] = {n: g.cpu() for n, g in _named_leaves(runs[name].pop("grads"))}
            torch.cuda.empty_cache()
    k = runs["kernel"]
    if k["launches"] != k["tf32"] or k["launches"] != 2 * cfg.n_layers or any(
            runs[name]["launches"] for name in ("chunked", "fp64", "plain")):
        raise AssertionError(f"{cfg.name} loss and gradient launched the flash kernel "
                             f"{k['launches']} times ({k['tf32']} tf32) with it and "
                             f"{[runs[n]['launches'] for n in ('chunked', 'fp64', 'plain')]} "
                             f"without; want {2 * cfg.n_layers} tf32 and 0")
    return runs, host


def _train_gate(cfg, params, batch, tag: str, around=None) -> dict:
    """fp32 loss and gradients (remat) through the kernel against the plain path
    (``_reference_runs``): the loss, the gradient norm and each leaf within
    max(tol, floor), the floor being the plain chunked path's distance from plain
    dense; and the loss, the gradient norm, each leaf and the whole gradient (its
    relative L2 distance) no further from a run with the flash op in fp64 than the
    plain path is (within max(tol, plain's))."""
    runs, host = _reference_runs(cfg, params, batch, around)
    k, c, p, x = runs["kernel"], runs["chunked"], runs["plain"], runs["fp64"]
    leaf_err, leaf_floor, kernel_fp64, plain_fp64, chunked_fp64 = {}, {}, {}, {}, {}
    sq = dict.fromkeys(("kernel", "plain", "fp64"), 0.0)  # squared distances from fp64, |g64|²
    for n, g in _named_leaves(p.pop("grads")):
        g64, gk = host["fp64"][n].cuda().double(), host["kernel"][n].cuda()
        gc = host["chunked"][n].cuda()
        leaf_err[n], kernel_fp64[n] = rel_l2(gk, g), rel_l2(gk, g64)
        leaf_floor[n], chunked_fp64[n] = rel_l2(gc, g), rel_l2(gc, g64)
        plain_fp64[n] = rel_l2(g, g64)
        sq["kernel"] += float(torch.sum((gk.double() - g64) ** 2))
        sq["plain"] += float(torch.sum((g.double() - g64) ** 2))
        sq["fp64"] += float(torch.sum(g64 ** 2))
        del g64, gk, gc
    del host
    torch.cuda.empty_cache()
    rel = {name: {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                  "norm": abs(r["norm"] - ref["norm"]) / ref["norm"]}
           for name, r, ref in (("kernel", k, p), ("floor", c, p), ("kernel_fp64", k, x),
                                ("plain_fp64", p, x))}
    for name in ("kernel", "plain"):
        rel[f"{name}_fp64"]["grad_rel_l2"] = math.sqrt(sq[name] / sq["fp64"])
    bad = [n for n in leaf_err if not (leaf_err[n] <= max(GRAD_RTOL, leaf_floor[n])
                                       and kernel_fp64[n] <= max(GRAD_RTOL, plain_fp64[n]))]
    log(f"[{tag}-train] gate {cfg.name} at {cfg.n_layers} layers, fp32, batch "
        f"{batch['tokens'].shape[0]} x {batch['tokens'].shape[1]}, remat: loss kernel "
        f"{k['loss']:.7f} plain {p['loss']:.7f} chunked {c['loss']:.7f} fp64 op "
        f"{x['loss']:.7f} (kernel rel {rel['kernel']['loss']:.2e}, floor "
        f"{rel['floor']['loss']:.2e}, tol max({LOSS_RTOL}, floor)); grad norm kernel "
        f"{k['norm']:.6e} plain {p['norm']:.6e} (rel {rel['kernel']['norm']:.2e}, floor "
        f"{rel['floor']['norm']:.2e}, tol max({GRAD_RTOL}, floor)); against the fp64 op, "
        f"the kernel within max(tol, plain's): loss kernel {rel['kernel_fp64']['loss']:.2e} "
        f"plain {rel['plain_fp64']['loss']:.2e}, norm kernel {rel['kernel_fp64']['norm']:.2e} "
        f"plain {rel['plain_fp64']['norm']:.2e}, gradient rel_l2 kernel "
        f"{rel['kernel_fp64']['grad_rel_l2']:.2e} plain {rel['plain_fp64']['grad_rel_l2']:.2e}; "
        f"flash launches {k['launches']}, {c['launches']}, {x['launches']}, {p['launches']}; "
        f"{k['s']:.2f}s, {c['s']:.2f}s, {p['s']:.2f}s; peak {k['peak_gib']:.1f}, "
        f"{c['peak_gib']:.1f}, {p['peak_gib']:.1f} GiB")
    for n in leaf_err:
        log(f"[{tag}-train] gate leaf {n:28s} rel_l2 kernel {leaf_err[n]:.2e} vs floor "
            f"(chunked) {leaf_floor[n]:.2e}, tol max({GRAD_RTOL}, floor); against the fp64 "
            f"op: kernel {kernel_fp64[n]:.2e}, plain {plain_fp64[n]:.2e} (tol max({GRAD_RTOL}, "
            f"plain's)), chunked {chunked_fp64[n]:.2e}")
    fp64_ok = all(rel["kernel_fp64"][m] <= max(tol, rel["plain_fp64"][m]) for m, tol in (
        ("loss", LOSS_RTOL), ("norm", GRAD_RTOL), ("grad_rel_l2", GRAD_RTOL)))
    if bad or not (rel["kernel"]["loss"] <= max(LOSS_RTOL, rel["floor"]["loss"])
                   and rel["kernel"]["norm"] <= max(GRAD_RTOL, rel["floor"]["norm"])
                   and fp64_ok and math.isfinite(k["loss"]) and math.isfinite(k["norm"])):
        raise AssertionError(f"{cfg.name} training gate: the kernel's loss, gradient norm or "
                             f"gradients {bad} disagree with the plain path's")
    return {"rel": rel, "leaf_rel_l2": leaf_err, "leaf_floor": leaf_floor,
            "leaf_kernel_vs_fp64": kernel_fp64, "leaf_plain_vs_fp64": plain_fp64,
            "leaf_chunked_vs_fp64": chunked_fp64, "launches": k["launches"]}


def _load_model(cfg, tag: str, dtype=torch.bfloat16, desc: str | None = None):
    """``cfg``'s weights drawn on the card, with a line on their size and the init's
    peak; ``desc`` describes the architecture where the attention's shape does not."""
    from repro_torch.models import get_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in _named_leaves(params))
    weights = sum(p.numel() * p.element_size() for _, p in _named_leaves(params))
    init_peak = torch.cuda.max_memory_allocated() - base - weights
    desc = desc or (f"{cfg.n_layers} layers" + (
        f" (+ {cfg.enc_layers} encoder layers over {cfg.enc_seq} frames)" if cfg.enc_layers
        else "") + f", d_model {cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
        f"{cfg.kq_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    log(f"[{tag}] {cfg.name} {str(dtype).removeprefix('torch.')}: {desc}: "
        f"{n_params / 1e9:.3f}G params ({weights / 1e9:.2f} GB) drawn in {init_s:.1f}s, init "
        f"peak {init_peak / 2**30:.2f} GiB above the weights")
    return params, {"n_params": n_params, "weights_gb": weights / 1e9,
                    "init_peak_gib": init_peak / 2**30}


def _rescale_stacks(tree, n: int, full: int | None, skip=()) -> None:
    """Scale in place each weight of a stack of ``n`` layers, which ``dense_init``
    draws at 1/sqrt(n), to 1/sqrt(``full``): the init of the same stack at ``full``
    layers; or, where ``full`` is None, to 1/sqrt(the weight's own input width,
    shape[-2]), an init whose attention scores are of order 1.  Norm scales and the
    leaves named in ``skip`` keep their values (zero biases and norm biases, whose
    shape[-2] is n, keep theirs too)."""
    for name, leaf in _named_leaves(tree):
        if name not in skip and not name.endswith("norm.scale"):
            leaf.mul_(math.sqrt(n / (full or leaf.shape[-2])))


def _vlm_fp32_model():
    """qwen2-vl-7b cut to VLM_LAYERS layers at full width, fp32, each stack scaled
    to the 28-layer init (the comment at VLM_LAYERS)."""
    from repro_torch.configs import get_config

    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    params, _ = _load_model(cfg, "vlm", torch.float32)
    _rescale_stacks(params["layers"], VLM_LAYERS, full.n_layers)
    return cfg, params


def phase_vlm(smi) -> dict:
    """qwen2-vl-7b: bf16 prefill at full width and depth through the sm90 kernel (28
    launches a call) at the text positions and at an image grid, the serving loop;
    then fp32 at VLM_LAYERS layers: kernel-vs-plain prefill at both positions,
    decode vs prefill, the training gate and 3 AdamW steps (16 tf32 launches a step)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch

    cfg = get_config(VLM_ARCH)
    params, out = _load_model(cfg, "vlm")
    out.update(_family_prefill(cfg, params, "vlm", smi, sm90=cfg.n_layers))
    batch = make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)
    tokens, text = torch.from_numpy(batch["tokens"]).cuda(), _batch_extras(batch)
    grid = {"positions": _image_positions(PREFILL_BATCH, PREFILL_LEN)}
    _reset_counts()
    image, t_image = _prefill(cfg, params, tokens, True, extras=grid)
    launches = _expect_launches(f"{cfg.name} prefill at the image grid", sm90=cfg.n_layers)
    plain_text = _prefill(cfg, params, tokens, True, extras=text)[0]
    pos = grid["positions"][:, 0]
    moved = rel_l2(image.float(), plain_text.float())
    log(f"[vlm-prefill] at an image grid ({IMAGE_TEXT}-token text runs between images of "
        f"{IMAGE_GRID} patches; t == h in {float((pos[0] == pos[1]).float().mean()):.2f}, "
        f"h == w in {float((pos[1] == pos[2]).float().mean()):.2f} of the positions, largest "
        f"{int(pos.max())}): {t_image:.3f}s, launches {launches}; last-position logits "
        f"{moved:.3e} (rel_l2) from the text positions'")
    if not (torch.isfinite(image).all() and moved > 0):
        raise AssertionError(f"{cfg.name} prefill at the image grid: logits not finite, or "
                             "equal to the text positions'")
    out["image"] = {"prefill_s": t_image, "rel_l2_vs_text": moved, "launches": launches}
    out["serve"] = _family_serve(cfg, params, "vlm", smi)
    del params, image, plain_text
    torch.cuda.empty_cache()

    cfg, params = _vlm_fp32_model()
    out["fp32_layers"] = cfg.n_layers
    out["prefill_gate"] = {name: _prefill_gate(cfg, params, tokens, extras, f"vlm-e2e {name}")
                           for name, extras in (("text", text), ("image", grid))}
    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    out["decode_vs_prefill"] = _decode_vs_prefill(
        cfg, params, prompts, dataclasses.replace(cfg, attn_chunk=VLM_OTHER_CHUNK),
        f"chunked attention ({VLM_OTHER_CHUNK}) vs dense", "vlm")
    train_batch = {k: torch.from_numpy(v).cuda()
                   for k, v in make_batch(cfg, TRAIN_LEN, TRAIN_BATCH).items()}
    out["train_gate"] = _train_gate(cfg, params, train_batch, "vlm")
    del train_batch
    out["train"] = _family_train(cfg, params, TRAIN_BATCH, "vlm", smi, tf32=2 * cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    return out


def _decode_vs_fp64(cfg, params, prompts, tag: str) -> dict:
    """fp32: the decode loop's logits at the last prompt step against the same loop
    on fp64 weights, within FP32_TOL."""
    from repro_torch import tree as tree_lib

    dec = _decode_prompt(cfg, params, prompts)
    params64 = tree_lib.tree_map(lambda t: t.double(), params)
    dec64 = _decode_prompt(cfg, params64, prompts)
    del params64
    err = rel_l2(dec, dec64)
    log(f"[{tag}] {cfg.name} fp32 decode loop vs the same on fp64 weights, logits at the last "
        f"of {prompts.shape[1]} prompt steps (batch {prompts.shape[0]}): rel_l2 {err:.3e} "
        f"(tol {FP32_TOL}), argmax agreement "
        f"{float((dec.argmax(-1) == dec64.argmax(-1)).float().mean()):.2f}")
    if not (err <= FP32_TOL and torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name}: the fp32 decode loop is {err:.3e} from fp64")
    return {"rel_l2": err, "steps": prompts.shape[1]}


def phase_audio(smi) -> dict:
    """whisper-tiny at full width and depth: bf16 prefill through the sm90 kernel
    (4 launches a call; the encoder and the cross-attention plain), the serving
    loop; fp32 kernel-vs-plain prefill, the decode loop against itself on fp64
    weights, the training gate and 3 AdamW steps (8 tf32 launches a step).  The
    decode loop's cross-attention reads the zero xk/xv of the cache, as in JAX, so
    it ignores the encoder and has no relation to the prefill to gate.

    The reference init draws each 4-layer stack at 1/sqrt(4): attention scores
    of ~100, near-one-hot softmax, and fp32 paths 0.2-1.3 (relative L2) apart,
    so gates of max(tol, floor) would pass a kernel that far off.  The three fp32
    gates run on a copy of the weights scaled to 1/sqrt(input width)
    (``_rescale_stacks``), where the floor is small; the timed steps run on the
    reference init."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch

    cfg = get_config(AUDIO_ARCH)
    params, out = _load_model(cfg, "audio")
    out.update(_family_prefill(cfg, params, "audio", smi, sm90=cfg.n_layers))
    out["serve"] = _family_serve(cfg, params, "audio", smi)
    del params
    params, _ = _load_model(cfg, "audio", torch.float32)
    well = tree_lib.tree_map(torch.clone, params)
    _rescale_stacks(well["layers"], cfg.n_layers, None)
    _rescale_stacks(well["encoder"]["layers"], cfg.enc_layers, None)
    log("[audio-e2e] the fp32 gates below run on the weights scaled to 1/sqrt(input width)")
    batch = make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)
    out["prefill_gate"] = _prefill_gate(cfg, well, torch.from_numpy(batch["tokens"]).cuda(),
                                        _batch_extras(batch), "audio-e2e")
    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    out["decode_vs_fp64"] = _decode_vs_fp64(cfg, well, prompts, "audio-e2e")
    train_batch = {k: torch.from_numpy(v).cuda()
                   for k, v in make_batch(cfg, TRAIN_LEN, TRAIN_BATCH).items()}
    out["train_gate"] = _train_gate(cfg, well, train_batch, "audio")
    del train_batch, well
    out["train"] = _family_train(cfg, params, TRAIN_BATCH, "audio", smi, tf32=2 * cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# pipeline training, expert parallelism in the model, sharding with elastic
# resharding, and the torchrun launch
# ---------------------------------------------------------------------------

PIPE_ARCH = "llama3.2-3b"
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 4, 1  # 4 stages; 4 microbatches of 1 x 2048
# the pipeline's depth, at the 28-layer init's scale: 2 layers a stage (28, 7 a
# stage, once: 86.2 s of the whole script's 1186.1 s, measured on one H100;
# cut so that the fifteenth slice's phases fit the script's time limit)
PIPE_LAYERS = 8
# autograd through the rank threads' ppermutes on one card, probed at
# check_pipeline_parallel's size: each wait at a collective ends after this
# many seconds, and a wait that nothing else can end (a deadlock) then raises
PIPE_PROBE_TIMEOUT = 5.0
EP_GATE_BATCH = 1  # the EP fp32 gate: 1 x 2048 tokens; no-drop slabs of (64, 2112, 2048) a rank
# the bf16 EP prefill: 2 x 2048 tokens a rank, so that the 4 ranks' logits and
# activations fit beside 56.1 GB of weights
EP_PREFILL_BATCH = 2
SHARD_LAYERS = 2  # llama3.2-3b at 2 of 28 layers: 1.98 GB of bf16 written and read
SHARD_MESHES = ((4, 4), (2, 8))
TORCHRUN_TIMEOUT = 300


def _pipeline_probe(smi) -> dict:
    """``loss.backward()`` of ``make_pipelined_loss`` on 4 rank threads on cuda:0
    (4 stages of tanh(h @ w), 8 microbatches of 4 x 16): the ranks' backward
    ppermutes all queue on the card's one autograd thread.  Records how it ends."""
    from repro_torch.core.comm import LocalMesh
    from repro_torch.parallel import pipeline as pp

    gen = torch.Generator("cuda").manual_seed(0)
    ws = torch.randn(4, 16, 16, generator=gen, device="cuda") * 0.3
    x = torch.randn(8, 4, 16, generator=gen, device="cuda")
    loss_fn = pp.make_pipelined_loss(lambda w, h: torch.tanh(h @ w),
                                     lambda o, lab: torch.mean((o - lab) ** 2), "pipe")
    mesh = LocalMesh((4,), ("pipe",), "cuda", timeout=PIPE_PROBE_TIMEOUT)

    def rank_fn(comm, w):
        w = w.clone().requires_grad_(True)
        loss_fn(comm, w, x, torch.zeros_like(x)).backward()
        return w.grad

    t0 = time.perf_counter()
    try:
        mesh.run(rank_fn, list(ws))
        outcome = "completed"
    except threading.BrokenBarrierError as e:
        outcome = f"deadlocked ({type(e).__name__})"
    secs = time.perf_counter() - t0
    log(f"[pipeline] probe: loss.backward() through Comm.ppermute's backward on 4 rank threads "
        f"of cuda:0 (smoke size) {outcome} after {secs:.1f}s (barrier timeout "
        f"{PIPE_PROBE_TIMEOUT}s) [{smi}]")
    return {"outcome": outcome, "s": secs, "timeout_s": PIPE_PROBE_TIMEOUT}


def _pipeline_fns(cfg, params):
    """(stage_fn, final_fn) of llama3.2-3b's pipeline: a stage's decoder layers
    through the flash op (no remat inside: the route recomputes each stage from
    its saved input), and the final norm, unembed and cross-entropy over the
    (M, mb, S, d) outputs."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as st

    def stage_fn(layers, h):
        return T.forward_layers(cfg, layers, h, remat=False, use_kernel=True)[0]

    def final_fn(outs, labels):
        h = L.apply_norm(outs.reshape(-1, *outs.shape[2:]), params["final_norm"], cfg.norm_type)
        return st.cross_entropy(h @ L.unembed(params), labels.reshape(-1, labels.shape[-1]))

    return stage_fn, final_fn


def _sequential_grads(cfg, params, x, labels, final_fn, use_kernel: bool,
                      micro: bool = True) -> dict:
    """The loss of the whole stack of layers (remat) and its gradient by layer leaf,
    on the host: a microbatch at a time through one graph, as the pipeline splits
    the batch (``micro``), or every microbatch at once."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import transformer as T

    flat, spec = tree_lib.flatten(params["layers"])
    views = [t.detach().requires_grad_(True) for t in flat]
    layers = tree_lib.unflatten(spec, views)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if micro:
        h = torch.stack([T.forward_layers(cfg, layers, xm, remat=True, use_kernel=use_kernel)[0]
                         for xm in x])
    else:
        h = T.forward_layers(cfg, layers, x.flatten(0, 1), remat=True,
                             use_kernel=use_kernel)[0].reshape(x.shape)
    loss = final_fn(h, labels)
    grads = torch.autograd.grad(loss, views)
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()), "s": time.perf_counter() - t0, "launches": _counts(),
           "grads": {n: g.cpu() for (n, _), g in
                     zip(_named_leaves(params["layers"]), grads, strict=True)}}
    del h, loss, grads, views
    torch.cuda.empty_cache()
    return out


def phase_pipeline(smi) -> dict:
    """llama3.2-3b at full width in fp32, PIPE_LAYERS of its 28 layers (the 28-layer
    init's scale) as 4 stages on a ("pipe",) LocalMesh of 4 rank threads on
    cuda:0, 4 microbatches of 1 x 2048,
    through ``make_pipelined_value_and_grad`` (the tf32 kernel in every stage): the
    loss and every stage's gradient against the sequential run of the same layers
    on the same weights and microbatches, within max(FP32_TOL, floor) (the floor:
    plain chunked against plain dense, as ``_train_gate``); the ppermute bytes and
    the tf32 launches exactly; then a timed training step (the pipeline and AdamW
    on each stage).  First the probe of the autograd route (``_pipeline_probe``).
    The sequential run over the 4 microbatches at once is reported beside: at the
    init's near one-hot attention the backward amplifies the rounding of the
    other GEMM shapes (1 x 2048 rows against 4 x 2048) past the floor."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core.comm import LocalMesh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.parallel import pipeline as pp
    from repro_torch.train import optimizer as opt

    probe = _pipeline_probe(smi)
    full = get_config(PIPE_ARCH)
    cfg = dataclasses.replace(full, n_layers=PIPE_LAYERS)
    p, m, ls = PIPE_STAGES, PIPE_MICRO, cfg.n_layers // PIPE_STAGES
    ticks = m + p - 1
    params, meta = _load_model(cfg, "pipeline", torch.float32)
    _rescale_stacks(params["layers"], cfg.n_layers, full.n_layers)
    batch = make_batch(cfg, TRAIN_LEN, m * PIPE_MB)
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    labels = torch.from_numpy(batch["labels"]).cuda().reshape(m, PIPE_MB, TRAIN_LEN)
    x_micro = params["embed"][tokens.long()].reshape(m, PIPE_MB, TRAIN_LEN, cfg.d_model)
    stage_fn, final_fn = _pipeline_fns(cfg, params)
    stages = [tree_lib.tree_map(lambda v, i=i: v[i * ls:(i + 1) * ls], params["layers"])
              for i in range(p)]
    vg = pp.make_pipelined_value_and_grad(stage_fn, final_fn, "pipe")
    mesh = LocalMesh((p,), ("pipe",), "cuda")
    hop = PIPE_MB * TRAIN_LEN * cfg.d_model * 4
    want_bytes = {**{(i, i + 1): ticks * hop for i in range(p - 1)},
                  **{(i + 1, i): ticks * hop for i in range(p - 1)}}
    want_launches = p * 2 * ticks * ls  # every tick forward, and again in reverse

    def run(fn):
        """One pipelined call on every rank: results, seconds, launches, peak."""
        mesh.stats.reset()
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mesh.run(fn, stages)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, _counts()
        if dict(mesh.stats.bytes) != want_bytes or mesh.stats.psum_calls != p:
            raise AssertionError(f"[pipeline] ppermute bytes {dict(mesh.stats.bytes)}, want "
                                 f"{want_bytes}; psum calls {mesh.stats.psum_calls}")
        if launches["flash_attention_fwd_tf32"] != want_launches or launches[
                "flash_attention_fwd"] != want_launches:
            raise AssertionError(f"[pipeline] launched {launches}, want {want_launches} tf32")
        return res, secs, launches, torch.cuda.max_memory_allocated() / 2**30

    res, gate_s, _, gate_peak = run(lambda c, sp: vg(c, sp, x_micro, labels))
    losses = [float(loss) for loss, _ in res]
    host = [{n: g.cpu() for n, g in _named_leaves(grads)} for _, grads in res]
    del res
    torch.cuda.empty_cache()
    seq = {name: _sequential_grads(c, params, x_micro, labels, final_fn, use_kernel=k,
                                   micro=name != "batched")
           for name, c, k in (("kernel", cfg, True), ("plain", cfg, False),
                              ("chunked", dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK),
                               False), ("batched", cfg, True))}
    if seq["kernel"]["launches"]["flash_attention_fwd_tf32"] != m * 2 * cfg.n_layers or seq[
            "batched"]["launches"]["flash_attention_fwd_tf32"] != 2 * cfg.n_layers:
        raise AssertionError(f"[pipeline] the sequential runs launched "
                             f"{seq['kernel']['launches']}, {seq['batched']['launches']}")
    ref = seq["kernel"]
    loss_err = abs(losses[-1] - ref["loss"]) / abs(ref["loss"])
    loss_floor = abs(seq["chunked"]["loss"] - seq["plain"]["loss"]) / abs(seq["plain"]["loss"])
    leaf_err, leaf_floor, leaf_batched, bad = {}, {}, {}, []
    for s in range(p):
        for n, g in host[s].items():
            sl = slice(s * ls, (s + 1) * ls)
            want = ref["grads"][n][sl].cuda()
            leaf_err[f"{s}.{n}"] = err = rel_l2(g.cuda(), want)
            leaf_floor[f"{s}.{n}"] = floor = rel_l2(seq["chunked"]["grads"][n][sl].cuda(),
                                                    seq["plain"]["grads"][n][sl].cuda())
            leaf_batched[f"{s}.{n}"] = rel_l2(seq["batched"]["grads"][n][sl].cuda(), want)
            if not err <= max(FP32_TOL, floor):
                bad.append(f"{s}.{n}")
    for v in seq.values():
        del v["grads"]
    del host
    torch.cuda.empty_cache()
    log(f"[pipeline] {cfg.name} fp32, {cfg.n_layers} layers as {p} stages of {ls} on {p} rank "
        f"threads of cuda:0, {m} microbatches of {PIPE_MB} x {TRAIN_LEN}, tf32 kernel: loss "
        f"{losses[-1]:.7f} on every rank {len(set(losses)) == 1} (sequential kernel "
        f"{ref['loss']:.7f}, rel {loss_err:.2e}; plain {seq['plain']['loss']:.7f}, chunked "
        f"{seq['chunked']['loss']:.7f}, floor {loss_floor:.2e}; tol max({FP32_TOL}, floor); "
        f"the microbatches at once {seq['batched']['loss']:.7f}); {gate_s:.2f}s, peak "
        f"{gate_peak:.2f} GiB; sequential {seq['kernel']['s']:.2f}s / {seq['plain']['s']:.2f}s "
        f"/ {seq['chunked']['s']:.2f}s / {seq['batched']['s']:.2f}s (kernel / plain / chunked, "
        f"a microbatch at a time; kernel, all at once)")
    for n in leaf_err:
        log(f"[pipeline] gate stage.leaf {n:22s} rel_l2 vs sequential {leaf_err[n]:.2e}, "
            f"floor (chunked vs plain) {leaf_floor[n]:.2e}, tol max({FP32_TOL}, floor); the "
            f"microbatches at once vs a microbatch at a time {leaf_batched[n]:.2e} (reported)")
    if bad or len(set(losses)) != 1 or not (loss_err <= max(FP32_TOL, loss_floor)
                                            and math.isfinite(losses[-1])):
        raise AssertionError(f"[pipeline] the pipelined loss or stage gradients {bad} disagree "
                             f"with the sequential run's")

    # one timed training step: the pipeline, then AdamW on each rank's stage
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                           schedule=cfg.schedule)
    ostates = [opt.init(sp) for sp in stages]

    def train_step(comm, sp):
        loss, grads = vg(comm, sp, x_micro, labels)
        opt.apply(ocfg, ostates[comm.rank], sp, grads)
        return loss

    losses, step_s, launches, step_peak = run(train_step)
    if not all(math.isfinite(float(v)) for v in losses):
        raise AssertionError(f"[pipeline] training step loss {losses}")
    bubble = (p - 1) / ticks
    ntok = m * PIPE_MB * TRAIN_LEN
    log(f"[pipeline] training step (pipeline + AdamW on each stage): {step_s:.2f}s "
        f"({ntok / step_s:.0f} tok/s), peak {step_peak:.2f} GiB ({step_peak * 2**30 / 1e9:.2f} "
        f"GB); ppermute {sum(want_bytes.values()) // 2:,} B forward and the same backward "
        f"({ticks} ticks x {p - 1} hops x {hop:,} B); tf32 launches a step {want_launches} "
        f"({p} ranks x {ticks} ticks x {ls} layers, forward and again in reverse); bubble "
        f"{p - 1}/{ticks} = {bubble:.4f} of the ticks; loss {float(losses[0]):.7f} [{smi}]")
    del ostates, stages, params, x_micro
    torch.cuda.empty_cache()
    return {"probe": probe, "stages": p, "microbatches": m, "microbatch": [PIPE_MB, TRAIN_LEN],
            "loss": float(ref["loss"]), "loss_rel": loss_err, "loss_floor": loss_floor,
            "leaf_rel_l2": leaf_err, "leaf_floor": leaf_floor,
            "leaf_batched_rel_l2": leaf_batched, "gate_s": gate_s,
            "gate_peak_gib": gate_peak, "step_s": step_s, "step_peak_gib": step_peak,
            "sequential_s": {k: v["s"] for k, v in seq.items()},
            "ppermute_bytes_each_way": sum(want_bytes.values()) // 2,
            "bubble_share": bubble, "launches": launches, **meta}


def _ep_bytes_check(tag, stats, n, slab, layers) -> int:
    """Every rank sends each other rank 2 x slab / n a layer (the exchange there and
    back); the bytes a rank sends."""
    pair = 2 * layers * slab // n
    want = {(a, b): pair for a in range(n) for b in range(n) if a != b}
    if dict(stats.bytes) != want:
        raise AssertionError(f"[{tag}] all_to_all bytes {dict(stats.bytes)}, want {pair} a pair")
    return (n - 1) * pair


def phase_moe_ep_gate(cfg, params, smi) -> dict:
    """The MoE model with ``moe_mode="ep"`` in fp32 at 4 of 48 layers (the weights of
    ``phase_moe_fp32``), over a ("model",) LocalMesh of 4 rank threads on cuda:0,
    at the no-drop capacity factor, batch 1 x 2048, through the tf32 kernel,
    against ``moe_mode="tp"`` on the same weights: the last position's logits
    with the tp path's routing replayed within max(FP32_TOL, floor) (the floor:
    plain chunked against plain dense, with the same routing); with free
    routing, reported.  The aux losses are reported: they differ by design."""
    from repro_torch.core.comm import LocalMesh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    ncfg = dataclasses.replace(cfg, capacity_factor=MOE_NODROP_CF)
    ep_cfg = dataclasses.replace(ncfg, moe_mode="ep")
    n = MOE_EP_RANKS
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, EP_GATE_BATCH)["tokens"]).cuda()

    def last(c, use_kernel, act=None):
        with torch.no_grad():
            logits, aux = T.forward(c, params, tokens, use_kernel=use_kernel, act_specs=act)
        return logits[:, -1:].clone(), float(aux)

    with _routing_log() as log_ref:
        ref, aux_ref = last(ncfg, True)
    with _replayed_routing(log_ref):
        plain, _ = last(ncfg, False)
    with _replayed_routing(log_ref):
        chunked, _ = last(dataclasses.replace(ncfg, attn_chunk=FLOOR_CHUNK), False)
    floor = rel_l2(chunked, plain)
    mesh = LocalMesh((n,), ("model",), "cuda")

    def ep_rank(comm):
        return last(ep_cfg, True, {"mesh": comm})

    torch.cuda.reset_peak_memory_stats()
    mesh.stats.reset()
    _reset_counts()
    t0 = time.perf_counter()
    free = mesh.run(ep_rank)
    torch.cuda.synchronize()
    secs, launches = time.perf_counter() - t0, _counts()
    cap = moe.capacity(EP_GATE_BATCH * PREFILL_LEN, cfg.top_k, cfg.n_experts, MOE_NODROP_CF)
    slab = cfg.n_experts * cap * cfg.d_model * 4
    sent = _ep_bytes_check("moe-ep-gate", mesh.stats, n, slab, cfg.n_layers)
    with _replayed_routing(log_ref, per_rank=True):
        replayed = mesh.run(ep_rank)
    errs = [rel_l2(y, ref) for y, _ in replayed]
    free_errs = [rel_l2(y, ref) for y, _ in free]
    dropped = sum(int((~k).sum()) for _, k in log_ref)
    log(f"[moe-ep-gate] {cfg.name} moe_mode='ep' at {cfg.n_layers} layers, fp32, {n} rank "
        f"threads of cuda:0 ({cfg.n_experts // n} experts a rank), batch {EP_GATE_BATCH} x "
        f"{PREFILL_LEN}, capacity factor {MOE_NODROP_CF} (cap {cap}, {dropped} pairs dropped): "
        f"last logits vs moe_mode='tp' with tp's routing replayed rel_l2 "
        f"{max(errs):.3e} (tol max({FP32_TOL}, floor)), floor (plain chunked vs plain dense) "
        f"{floor:.3e}; free routing {max(free_errs):.3e}; aux ep {free[0][1]:.6f} tp "
        f"{aux_ref:.6f} (reported); all_to_all {sent:,} B a rank ({cfg.n_layers} layers x 2 x "
        f"3/4 x the ({cfg.n_experts}, {cap}, {cfg.d_model}) fp32 slab); launches {launches}; "
        f"{secs:.2f}s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    if launches["flash_attention_fwd_tf32"] != n * cfg.n_layers:
        raise AssertionError(f"[moe-ep-gate] launched {launches}, want {n * cfg.n_layers} tf32")
    if dropped or not (max(errs) <= max(FP32_TOL, floor)
                       and all(torch.isfinite(y).all() for y, _ in free)):
        raise AssertionError(f"[moe-ep-gate] ep logits {errs} from tp's, floor {floor:.3e}, "
                             f"{dropped} pairs dropped")
    aux_ep = free[0][1]
    del free, replayed, ref, plain, chunked, log_ref
    torch.cuda.empty_cache()
    return {"rel_l2": max(errs), "floor": floor, "free_rel_l2": max(free_errs),
            "aux_ep": aux_ep, "aux_tp": aux_ref, "cap": cap,
            "all_to_all_bytes_a_rank": sent, "s": secs, "launches": launches}


def phase_moe_ep_prefill(params, smi) -> dict:
    """moonshot-v1-16b-a3b at full width and depth in bf16 with ``moe_mode="ep"``: the
    prefill step (batch 2 x 2048, the config's capacity factor) on each of 4 rank
    threads of cuda:0, through the sm90 kernel, on ``phase_moe_serve``'s weights
    (every rank reads the same tensors; each takes views of its 16 experts).
    Forward only: the ranks' backwards would share the card's one autograd
    thread (the pipeline probe).  The all-to-all bytes against the slab sizes;
    one warm-up call, then three timed; the logits against ``moe_mode="tp"``'s on
    the same tokens, reported: tp routes each row as a group (capacity 240), EP
    a rank's 4096 tokens as one (capacity 480), so they drop other pairs."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import LocalMesh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import moe
    from repro_torch.train import steps as st

    cfg = get_config(MOE_ARCH)
    ep_cfg = dataclasses.replace(cfg, moe_mode="ep")
    n = MOE_EP_RANKS
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, EP_PREFILL_BATCH)["tokens"]).cuda()
    tp_logits, tp_s = _prefill(cfg, params, tokens, use_kernel=True)
    mesh = LocalMesh((n,), ("model",), "cuda")
    opts = st.TrainOptions(use_kernel=True)

    def rank_fn(comm):
        return st.make_prefill_step(ep_cfg, opts, act_specs={"mesh": comm})(
            params, {"tokens": tokens})

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh.stats.reset()
    _reset_counts()
    outs = mesh.run(rank_fn)
    torch.cuda.synchronize()
    launches = _counts()
    cap = moe.capacity(EP_PREFILL_BATCH * PREFILL_LEN, cfg.top_k, cfg.n_experts,
                       cfg.capacity_factor)
    slab = cfg.n_experts * cap * cfg.d_model * 2
    sent = _ep_bytes_check("moe-ep-prefill", mesh.stats, n, slab, cfg.n_layers)
    want = n * cfg.n_layers
    if launches["flash_attention_fwd_sm90"] != want or launches["flash_attention_fwd"] != want:
        raise AssertionError(f"[moe-ep-prefill] launched {launches}, want {want} sm90")
    for r, y in enumerate(outs):
        if y.shape != (EP_PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(y).all():
            raise AssertionError(f"[moe-ep-prefill] rank {r} logits {tuple(y.shape)} not finite "
                                 "or misshapen")
    spread = max(float((y.float() - outs[0].float()).abs().max()) for y in outs)
    err = rel_l2(outs[0], tp_logits)
    agree = float((outs[0].argmax(-1) == tp_logits.argmax(-1)).float().mean())
    del outs
    secs = []
    for _ in range(SYNC_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.run(rank_fn)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ntok = EP_PREFILL_BATCH * PREFILL_LEN
    log(f"[moe-ep-prefill] {cfg.name} bf16 moe_mode='ep', {cfg.n_layers} layers, {n} rank "
        f"threads of cuda:0 ({cfg.n_experts // n} experts a rank), batch {EP_PREFILL_BATCH} x "
        f"{PREFILL_LEN} on every rank, capacity factor {cfg.capacity_factor} (cap {cap}): "
        f"{statistics.median(secs):.3f}s median of {SYNC_REPS} ({', '.join(f'{t:.3f}' for t in secs)};"
        f" {ntok / statistics.median(secs):.0f} tok/s; tp's prefill of the same tokens "
        f"{tp_s:.3f}s), peak {peak:.2f} GiB; all_to_all {sent:,} B a rank ({cfg.n_layers} layers "
        f"x 2 x 3/4 x the ({cfg.n_experts}, {cap}, {cfg.d_model}) bf16 slab); launches a call "
        f"{launches}; ranks' logits within {spread:.3e} of rank 0's; vs tp rel_l2 {err:.3e}, "
        f"argmax agreement {agree:.2f} (bf16, reported) [{smi}]")
    del tp_logits, tokens
    torch.cuda.empty_cache()
    return {"s": statistics.median(secs), "s_runs": secs, "tp_s": tp_s, "peak_gib": peak,
            "cap": cap, "all_to_all_bytes_a_rank": sent, "launches": launches,
            "rank_spread": spread, "tp_rel_l2": err, "tp_argmax_agree": agree}


def _named_block(mesh, rank, spec, shape) -> tuple:
    """The slices of a global tensor that ``rank`` holds under ``spec``, from its
    coordinates (the block index's digits are the entry's axes, the first the most
    significant): the check of ``NamedSharding.block``."""
    coords, out = mesh.coords(rank), []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for a in axes:
            parts, index = parts * mesh.shape[a], index * mesh.shape[a] + coords[a]
        out.append(slice(index * (size // parts), (index + 1) * (size // parts)))
    return tuple(out)


def _check_sharded(tag, params, sharded, specs) -> int:
    """Every rank's block of every leaf equal, bit for bit, to the slice of the
    global tensor its spec names; the number of blocks checked."""
    from repro_torch import tree as tree_lib

    checked = 0
    for (name, x), s, spec in zip(_named_leaves(params), tree_lib.leaves(sharded),
                                  tree_lib.leaves(specs), strict=True):
        mesh = s.sharding.mesh
        for r in range(mesh.size):
            if not torch.equal(s.blocks[r], x[_named_block(mesh, r, spec, x.shape)]):
                raise AssertionError(f"[{tag}] {name}: rank {r}'s block is not its slice {spec}")
            checked += 1
    return checked


def phase_sharding(smi) -> dict:
    """llama3.2-3b at full width, 2 of its 28 layers, in bf16: its parameters under
    ``default_policy`` and ``sanitize_specs`` on a (4, 4) LocalMesh on cuda:0, every
    rank's block against its slice of the global tensor; saved, restored on a
    (2, 8) mesh under that mesh's specs, every block again bit for bit."""
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.comm import LocalMesh
    from repro_torch.parallel import sharding as sh

    cfg = dataclasses.replace(get_config(PIPE_ARCH), n_layers=SHARD_LAYERS)
    params, meta = _load_model(cfg, "sharding", torch.bfloat16)
    policy = sh.default_policy(cfg)
    out = {"policy": dataclasses.asdict(policy), **meta}
    meshes = [LocalMesh(shape, ("data", "model"), "cuda") for shape in SHARD_MESHES]
    specs = [sh.sanitize_specs(params, sh.param_specs(cfg, params, policy), mesh)
             for mesh in meshes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = sh.shard_tree(params, sh.to_shardings(meshes[0], specs[0]))
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    checked = _check_sharded("sharding", params, sharded, specs[0])
    rank_bytes = [sum(s.blocks[r].numel() * s.blocks[r].element_size()
                      for s in tree_lib.leaves(sharded)) for r in range(meshes[0].size)]
    spec_line = ", ".join(f"{n} {tuple(s)}" for (n, _), s in
                          zip(_named_leaves(params), tree_lib.leaves(specs[0])))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(f"{d}/c", sharded, step=1)
        save_s = time.perf_counter() - t0
        del sharded
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, step = ckpt.restore(f"{d}/c", params,
                                      shardings=sh.to_shardings(meshes[1], specs[1]))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if step != 1:
        raise AssertionError(f"[sharding] restored step {step}")
    checked += _check_sharded("resharding", params, restored, specs[1])
    new_bytes = [sum(s.blocks[r].numel() * s.blocks[r].element_size()
                     for s in tree_lib.leaves(restored)) for r in range(meshes[1].size)]
    log(f"[sharding] {cfg.name} bf16 at {SHARD_LAYERS} of 28 layers ({meta['weights_gb']:.2f} "
        f"GB), default_policy {policy}: specs on {SHARD_MESHES[0]}: {spec_line}; bytes a rank "
        f"on {SHARD_MESHES[0]}: {rank_bytes[0]:,} (min {min(rank_bytes):,}, max "
        f"{max(rank_bytes):,}; all ranks {sum(rank_bytes):,}), on {SHARD_MESHES[1]}: min "
        f"{min(new_bytes):,} max {max(new_bytes):,}; put {put_s:.2f}s, save (gather to the host, "
        f"write) {save_s:.2f}s, restore on {SHARD_MESHES[1]} {restore_s:.2f}s; {checked} blocks "
        f"equal to their slices, bit for bit [{smi}]")
    del restored, params
    torch.cuda.empty_cache()
    return {**out, "meshes": SHARD_MESHES, "rank_bytes": rank_bytes, "rank_bytes_after": new_bytes,
            "blocks_checked": checked, "put_s": put_s, "save_s": save_s, "restore_s": restore_s}


def phase_torchrun(smi) -> dict:
    """``torchrun --standalone --nproc_per_node 1 -m repro_torch.launch.train --sync
    ring`` at smoke width through the tf32 kernel: the CLI initialises NCCL, builds a
    ``DistMesh`` of one rank (the constructor's all-reduce) and trains 3 steps;
    its checkpoint against the same CLI's in this process (a one-rank LocalMesh)."""
    import os
    import signal

    import numpy as np

    from repro_torch.launch import train as train_cli

    args = ["--arch", "llama3.2-3b-smoke", "--steps", "3", "--sync", "ring", "--use-kernel",
            "--checkpoint-every", "3"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "repro_torch.launch.train", *args,
               "--checkpoint-dir", f"{d}/dist"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=TORCHRUN_TIMEOUT)
        finally:
            if proc.poll() is None:  # stop torchrun and its worker
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        secs = time.perf_counter() - t0
        for line in text.splitlines():
            log(f"[torchrun] {line}")
        if proc.returncode:
            raise AssertionError(f"[torchrun] exited {proc.returncode}")
        with contextlib.redirect_stdout(io.StringIO()):
            local = train_cli.main([*args, "--checkpoint-dir", f"{d}/local"])
        files = sorted(f for f in os.listdir(f"{d}/local/step_3") if f.endswith(".npy"))
        if files != sorted(f for f in os.listdir(f"{d}/dist/step_3") if f.endswith(".npy")):
            raise AssertionError("[torchrun] the two checkpoints hold other leaves")
        worst, equal = 0.0, 0
        for f in files:
            a = np.load(f"{d}/dist/step_3/{f}")
            b = np.load(f"{d}/local/step_3/{f}")
            equal += int(np.array_equal(a, b))
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            worst = max(worst, float(np.linalg.norm(a64 - b64) / max(np.linalg.norm(b64), 1e-30)))
    loss = re.findall(r"\[train\] step\s+3 loss (\S+)", text)
    log(f"[torchrun] world size 1 over NCCL on cuda:0: 3 steps of --sync ring in {secs:.1f}s "
        f"(process start, NCCL init, DistMesh's all-reduce, the steps); its checkpoint against "
        f"the one-process run's: {equal} of {len(files)} leaves bit for bit, worst rel_l2 "
        f"{worst:.2e}; loss {loss} and {local['loss']:.4f}.  A run over NCCL with more than one "
        f"rank needs at least two cards; this run has {torch.cuda.device_count()} [{smi}]")
    if not loss or worst > 1e-6:
        raise AssertionError(f"[torchrun] the torchrun checkpoint is {worst:.2e} from the "
                             "one-process run's")
    return {"s": secs, "leaves_equal": equal, "leaves": len(files), "worst_rel_l2": worst,
            "loss": float(loss[0]), "local_loss": local["loss"]}


# ---------------------------------------------------------------------------
# the dry-run and the flow simulator's device backend (the tenth slice)
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "llama3.2-3b"
DRYRUN_PEAK_RTOL = 0.10  # the predicted peak against max_memory_allocated
GEMM_N = 8192  # the bf16 GEMM that measures the card's tensor-core rate
COPY_BYTES = 1 << 31  # the device-to-device copy that measures HBM bandwidth
FLOWSIM_RTOL = 1e-5  # the JAX backend's own tolerance against NumPy (float32)
# the paper's small Hx2Mesh (2 x 2 boards, 16 x 16: 1,024 accelerators, 64
# switches) against the NumPy engine's full pass, then 40 x 40 (6,400
# accelerators) against the symmetry reduction, exact (its NumPy pass took ~26 s
# on the host)
FLOWSIM_MESHES = ((2, 2, 16, 16, "numpy"), (2, 2, 40, 40, "symmetry"))
# Table II's large cluster (core/topology.py: large_cluster): Hx2Mesh 64 x 64 and
# Hx4Mesh 32 x 32, 16,384 accelerators each, uniform all-to-all through the card's
# chunked pass against the symmetry reduction; beside each, its max link load from
# the JAX package's NumPy engine on a CPU, and the paper's alltoall fraction
FLOWSIM_TABLE2 = {(2, 2, 64, 64): 0.984435085149, (4, 4, 32, 32): 2.764483509329}
# the small Hx2Mesh under failures, then a job's sub-fabric on its boards (r, c),
# r, c < FLOWSIM_PLACEMENT; Table II's dragonflies (16, 8, 8, 8) and (32, 17, 16,
# 30) fail build_dragonfly's assertion (a*h must divide groups - 1), in the JAX
# package too, so the dragonfly is the nearest that builds (1,152 endpoints)
FLOWSIM_FAILED = ((2, 2, 16, 16), "fail=boards:1%:seed7")
FLOWSIM_PLACEMENT = 8
FLOWSIM_DRAGONFLY = {"a": 16, "p": 8, "h": 8, "groups": 9}
FLOWSIM_EXACT_PATHS = 2 ** 24  # the torch backend keeps path counts in float32
# sparse demands (core/traffic.py) through the chunked pass, at 4,096 accelerators
# (32 x 32 boards): a non-symmetric token and bisection, whose NumPy references
# take ~10 s each on the host
FLOWSIM_SPARSE_MESH = (2, 2, 32, 32)
FLOWSIM_SPARSE_TOKENS = ("skewed-alltoall:h8:seed3", "bisection")


def _fake_batch_like(batch: dict):
    """Fake tensors of ``batch``'s shapes and dtypes (inside FakeTensorMode)."""
    spec = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
    return lambda: {k: torch.empty(s, dtype=d) for k, (s, d) in spec.items()}


def _card_rates() -> dict:
    """The card's own bf16 GEMM TFLOP/s and HBM copy GB/s (CUDA events)."""
    a = torch.randn(GEMM_N, GEMM_N, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(GEMM_N, GEMM_N, device="cuda", dtype=torch.bfloat16)
    gemm_ms = cuda_ms(lambda: a @ b, reps=20, warmup=3)
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), reps=20, warmup=3)
    del a, b, src, dst
    torch.cuda.empty_cache()
    return {"gemm_tflops": 2 * GEMM_N ** 3 / (gemm_ms * 1e-3) / 1e12, "gemm_ms": gemm_ms,
            "copy_gbs": 2 * COPY_BYTES / (copy_ms * 1e-3) / 1e9, "copy_ms": copy_ms}


def phase_dryrun(smi) -> dict:
    """The dry-run on the card's host: the production cell at full width, then the
    cell of the step that runs on this card, its prediction held to the real step."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import roofline_torch as roof
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import abstract_params, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    # -- the production cell, as `python -m repro_torch.launch.dryrun` traces it
    rec = dryrun.run_cell(DRYRUN_ARCH, "train_4k", False, st.TrainOptions(sync="auto"))
    if not rec["ok"]:
        raise AssertionError(f"dry-run of {DRYRUN_ARCH} train_4k failed: {rec['error']}")
    log("[dryrun] " + json.dumps(rec))
    log("[dryrun] roofline twin: " + json.dumps(roof.row(rec)))

    # -- the step that runs on this card: llama3.2-3b fp32, batch 2 x 2048, remat,
    #    the plain attention (FlopCounterMode sees it), one rank, sync="auto"
    cfg = get_config(DRYRUN_ARCH)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2, schedule=cfg.schedule)
    step_fn = st.make_train_step(cfg, ocfg, st.TrainOptions(remat=True, use_kernel=False))
    host_batch = {k: torch.from_numpy(v)
                  for k, v in make_batch(cfg, TRAIN_LEN, TRAIN_BATCH, step=0).items()}
    params_abs = abstract_params(cfg, dtype=torch.float32)
    fake_batch = _fake_batch_like(host_batch)

    def make_args():
        params = dryrun._fake(params_abs)
        return params, opt.init(params), fake_batch()

    t0 = time.perf_counter()
    pred = dryrun.trace(make_args, step_fn)
    trace_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    ostate = opt.init(params)
    batch = {k: v.cuda() for k, v in host_batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with FlopCounterMode(display=False) as counter:
        params, ostate, m = step_fn(params, ostate, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    flops = counter.get_total_flops()
    t0 = time.perf_counter()
    params, ostate, m = step_fn(params, ostate, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _counts()
    loss = float(m["loss"])
    del params, ostate, batch, m
    torch.cuda.empty_cache()
    peak_err = abs(pred["peak_bytes"] - peak) / peak
    terms = roof.terms(flops, pred["bytes_accessed"], 0)
    rates = _card_rates()
    log(f"[dryrun] {cfg.name} fp32 train step, batch {TRAIN_BATCH} x {TRAIN_LEN}, remat, plain "
        f"attention: predicted on fake tensors in {trace_s:.1f}s: {pred['flops']} FLOPs, peak "
        f"{pred['peak_bytes']} B ({pred['peak_bytes'] / 2**30:.2f} GiB), {pred['bytes_accessed']} "
        f"B accessed; on the card: {flops} FLOPs (FlopCounterMode), peak {peak} B "
        f"({peak / 2**30:.2f} GiB, max_memory_allocated; predicted rel {peak_err:.4f}, tol "
        f"{DRYRUN_PEAK_RTOL}); step {step_s:.3f}s, loss {loss:.6f} [{smi}]")
    log(f"[dryrun] roofline twin's terms for this step ({roof.HARDWARE}, bf16 peak): compute "
        f"{terms['compute']:.4f}s, memory {terms['memory']:.4f}s (unfused bytes) beside the "
        f"measured {step_s:.3f}s in fp32; the card measured: bf16 GEMM {GEMM_N}^3 "
        f"{rates['gemm_tflops']:.1f} TFLOP/s (data sheet {roof.PEAK_FLOPS / 1e12:g}), HBM copy "
        f"{rates['copy_gbs']:.1f} GB/s (data sheet {roof.HBM_BW / 1e9:g}) [{smi}]")
    if flops != pred["flops"]:
        raise AssertionError(f"dry-run FLOPs {pred['flops']} != the step's {flops} on the card")
    if peak_err > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dry-run peak {pred['peak_bytes']} B is {peak_err:.3f} from the "
                             f"card's {peak} B (tol {DRYRUN_PEAK_RTOL})")
    if any(launches.values()) or not math.isfinite(loss):
        raise AssertionError(f"the plain step launched kernels {launches} or lost its loss {loss}")
    return {"cell": rec, "step": {"predicted": pred, "flops": flops, "peak_bytes": peak,
                                  "peak_rel_err": peak_err, "trace_s": trace_s,
                                  "step_s": step_s, "terms_s": terms},
            "tp_moe_rank": _dryrun_tp_moe(smi), "tp_hybrid_rank": _dryrun_tp_hybrid(smi),
            "card": rates, "datasheet": {"hardware": roof.HARDWARE,
                                         "peak_flops": roof.PEAK_FLOPS,
                                         "hbm_bw": roof.HBM_BW, "link_bw": roof.LINK_BW}}


def _dryrun_tp_moe(smi) -> dict:
    """The dry-run's prediction of one rank's sharded MoE train step against that
    rank on the card: moonshot-v1-16b-a3b at FAM_DRYRUN_LAYERS layer
    (``_dryrun_tp_rank``), its peak within DRYRUN_PEAK_RTOL."""
    from repro_torch.configs import get_config

    return _dryrun_tp_rank(dataclasses.replace(get_config(MOE_ARCH), n_layers=FAM_DRYRUN_LAYERS),
                           DRYRUN_PEAK_RTOL, smi)


def _dryrun_tp_hybrid(smi) -> dict:
    """The same for one rank of recurrentgemma-9b's sharded train step at
    REC_TRAIN_LAYERS (one (rec, rec, attn) block), B 1 x REC_DRYRUN_LEN on
    REC_DRYRUN_SHAPE, its peak
    within REC_DRYRUN_PEAK_RTOL; the ranks' losses within 1e-6 (rank 0's log and
    mean round on the card, the others' on the host)."""
    from repro_torch.configs import get_config

    return _dryrun_tp_rank(dataclasses.replace(get_config(HYBRID_ARCH), n_layers=REC_TRAIN_LAYERS),
                           REC_DRYRUN_PEAK_RTOL, smi, tokens=REC_DRYRUN_LEN,
                           shape=REC_DRYRUN_SHAPE, loss_rtol=1e-6)


def _dryrun_tp_rank(cfg, rtol: float, smi, tokens: int | None = None, shape=None,
                    loss_rtol: float = 0.0) -> dict:
    """The dry-run's prediction of one rank's sharded train step against that rank
    on the card: ``cfg`` at full width, fp32, remat, the plain attention that
    ``FlopCounterMode`` sees, B 1 x ``tokens`` (FAM_DRYRUN_LEN), TP over ``model``
    on (data, model) = ``shape`` (FAM_DRYRUN_SHAPE), rank 0 a thread on the card and
    the others threads on the host, so that the card holds rank 0 alone: its FLOPs
    (``FlopCounterMode`` in its thread) equal to the trace's, exactly, and its peak
    (``max_memory_allocated``, its blocks, moments and rows included, as the trace
    counts them) within ``rtol``; every rank's loss within ``loss_rtol`` of rank
    0's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree as tree_lib
    from repro_torch.core.comm import Comm, LocalMesh, TraceMesh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    policy = sh.Policy()
    tokens, shape = tokens or FAM_DRYRUN_LEN, shape or FAM_DRYRUN_SHAPE
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2, schedule=cfg.schedule)
    opts = st.TrainOptions(remat=True, use_kernel=False)
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    params = tree_lib.tree_map(lambda t: t.cpu(), params)  # the weights on the host
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, tokens, 1, step=0).items()}
    devices = [TP_DEVICE] + ["cpu"] * (math.prod(shape) - 1)
    mesh = LocalMesh(shape, TP_AXES, devices)
    specs = sh.sanitize_specs(params, sh.param_specs(cfg, params, policy), mesh)

    def step_of(comm):
        return st.make_train_step(cfg, ocfg, opts, act_specs={"mesh": comm, "policy": policy})

    trace_mesh = TraceMesh(shape, TP_AXES)
    meta = tree_lib.tree_map(lambda t: t.to("meta"),
                             sh.block_views(params, specs, trace_mesh, 0))

    def make_args():
        blocks = dryrun._fake(meta)
        return blocks, opt.init(blocks), {k: torch.empty(v.shape, dtype=v.dtype)
                                          for k, v in batch.items()}

    t0 = time.perf_counter()
    pred = dryrun.trace(make_args, step_of(Comm(trace_mesh, 0)))
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    blocks = [tree_lib.tree_map(lambda t, r=r: t.to(mesh.device(r), copy=True,
                                                    memory_format=torch.contiguous_format),
                                sh.block_views(params, specs, mesh, r))
              for r in range(mesh.size)]
    rows = [{k: v.to(mesh.device(r)) for k, v in batch.items()} for r in range(mesh.size)]
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = {}

    def fn(comm, p, b):
        state, step = opt.init(p), step_of(comm)
        if comm.rank:
            return float(step(p, state, b)[2]["loss"])
        with FlopCounterMode(display=False) as counter:
            m = step(p, state, b)[2]
        counted["flops"] = counter.get_total_flops()
        return float(m["loss"])

    _reset_counts()
    t0 = time.perf_counter()
    losses = mesh.run(fn, blocks, rows)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launches = _counts()
    del blocks, rows
    torch.cuda.empty_cache()
    peak_err = abs(pred["peak_bytes"] - peak) / max(1, peak)
    agree = all(abs(x - losses[0]) <= loss_rtol * abs(losses[0]) for x in losses)
    rec = {"predicted": pred, "flops": counted["flops"], "peak_bytes": peak,
           "peak_rel_err": peak_err, "trace_s": trace_s, "step_s": step_s, "loss": losses[0],
           "shape": shape, "layers": cfg.n_layers, "tokens": tokens,
           "peak_rtol": rtol}
    log(f"[dryrun] {cfg.name} at {cfg.n_layers} layers, fp32, TP on (data, model) = "
        f"{shape}, batch 1 x {tokens}, remat, plain attention, rank 0 on "
        f"the card ({mesh.size - 1} more on the host): predicted on fake tensors in "
        f"{trace_s:.1f}s: {pred['flops']} FLOPs, peak {pred['peak_bytes']} B; rank 0 on the "
        f"card: {counted['flops']} FLOPs, peak {peak} B (predicted rel {peak_err:.4f}, tol "
        f"{rtol}); step {step_s:.2f}s, loss {losses[0]:.6f} (every rank alike: "
        f"{agree}) [{smi}]")
    if counted["flops"] != pred["flops"]:
        raise AssertionError(f"the dry-run's {cfg.name} rank FLOPs {pred['flops']} != the "
                             f"card's {counted['flops']}")
    if peak_err > rtol or not agree or any(launches.values()):
        raise AssertionError(f"the dry-run's {cfg.name} rank peak {pred['peak_bytes']} B is "
                             f"{peak_err:.3f} from the card's {peak} B, or the ranks' losses "
                             f"{losses} differ, or kernels {launches} launched")
    return rec


def phase_flowsim(smi) -> dict:
    """The flow simulator's torch backend on the card against a reference on the
    host: the max ECMP link load of uniform all-to-all on HxMesh planes
    (``_flowsim_table2`` at 16,384 accelerators), of failed, placed and dragonfly
    fabrics (``_flowsim_fabrics``) and of sparse demands at 4,096 accelerators
    (``_flowsim_sparse``).  Every card case runs the torch backend's chunked pass
    (``flowsim.device_chunks`` above 0)."""
    from repro_torch.core import flowsim as fs
    from repro_torch.core import traffic as tr

    out = {}
    for a, b, x, y, reference in FLOWSIM_MESHES:
        net = fs.build_hxmesh(a, b, x, y)
        traffic = fs.traffic_matrix(net, "alltoall")
        t0 = time.perf_counter()
        if reference == "numpy":
            ref = fs.max_link_load(net, traffic)
        else:
            ref = fs.symmetric_max_link_load(net, tr.demand(net, "alltoall"))
        ref_s = time.perf_counter() - t0
        tag = f"hx{a}x{b}-{x}x{y}"
        runs = [_flowsim_on_card(tag, lambda: fs.max_link_load(net, traffic, backend="torch"))
                for _ in range(2)]  # the first call includes the card's warm-up
        got = runs[-1][0]
        rel = abs(got - ref) / ref
        log(f"[flowsim] {tag}: {net.n_endpoints} accelerators, "
            f"{net.n_nodes - net.n_endpoints} switches, {len(net.directed_edges()[0])} directed "
            f"links; all-to-all max link load {reference} {ref:.9f} in {ref_s:.2f}s (host), "
            f"torch {got:.9f} in {runs[0][1]:.3f}s / {runs[1][1]:.3f}s, {runs[1][2]} device "
            f"chunks (cuda, float32); rel {rel:.2e} (tol {FLOWSIM_RTOL}) [{smi}]")
        if not rel <= FLOWSIM_RTOL:
            raise AssertionError(f"flowsim {tag}: torch {got} vs {reference} {ref} "
                                 f"(rel {rel:.2e})")
        out[tag] = {"endpoints": net.n_endpoints, "nodes": net.n_nodes, "reference": reference,
                    reference: ref, "torch": got, "rel": rel, f"{reference}_s": ref_s,
                    "torch_s": [r[1] for r in runs], "device_chunks": runs[1][2]}
    first = out[next(iter(out))]
    if (first["endpoints"], first["nodes"] - first["endpoints"]) != (1024, 64):
        raise AssertionError(f"the small Hx2Mesh has {first['endpoints']} accelerators and "
                             f"{first['nodes'] - first['endpoints']} switches, want 1024 and 64")
    out["table2"] = _flowsim_table2(smi)
    out["fabrics"] = _flowsim_fabrics(smi)
    out["sparse"] = _flowsim_sparse(smi)
    return out


def _flowsim_on_card(tag, call):
    """(value, seconds, device chunks) of one call that must run the torch
    backend's chunked pass on the card."""
    from repro_torch.core import flowsim as fs

    fs.device_chunks = 0
    t0 = time.perf_counter()
    value = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if fs.device_chunks == 0:
        raise AssertionError(f"flowsim {tag}: the card case ran no device chunk")
    return value, seconds, fs.device_chunks


def _flowsim_max_paths(net, sources) -> float:
    """The most shortest paths between any of ``sources`` and any node (NumPy):
    the torch backend's float32 counts are exact below FLOWSIM_EXACT_PATHS."""
    from repro_torch.core import flowsim as fs

    most = float(fs.shortest_paths(net, sources)[1].max())
    if not most < FLOWSIM_EXACT_PATHS:
        raise AssertionError(f"{most} shortest paths: float32 counts are not exact")
    return most


def _flowsim_table2(smi) -> dict:
    """Table II's 16,384-accelerator HxMeshes: uniform all-to-all through the
    card's chunked pass over every source (``demand_edge_loads``), against the
    symmetry reduction on the host (one NumPy BFS a class of endpoints), which
    is held to the JAX package's value (FLOWSIM_TABLE2)."""
    import numpy as np

    from repro_torch.core import flowsim as fs
    from repro_torch.core import traffic as tr

    out = {}
    for (a, b, x, y), want in FLOWSIM_TABLE2.items():
        tag = f"hx{a}x{b}-{x}x{y}"
        t0 = time.perf_counter()
        net = fs.build_hxmesh(a, b, x, y)
        n_links = len(net.directed_edges()[0])
        dem = tr.demand(net, "alltoall")
        build_s = time.perf_counter() - t0
        if net.n_endpoints != 16384:
            raise AssertionError(f"{tag} has {net.n_endpoints} accelerators, want 16384")
        t0 = time.perf_counter()
        ref = fs.symmetric_max_link_load(net, dem)
        sym_s = time.perf_counter() - t0
        frac = fs.alltoall_fraction(net, net.meta["links_per_endpoint"])
        reps = np.unique(fs.endpoint_classes(net), return_index=True)[1]
        max_paths = _flowsim_max_paths(net, reps)
        # one call: the card is warm from FLOWSIM_MESHES, and a call takes seconds
        loads, torch_s, chunks = _flowsim_on_card(
            tag, lambda: fs.demand_edge_loads(net, dem, backend="torch"))
        got = float(loads.max())
        rel = abs(got - ref) / ref
        split = _flowsim_chunk_split(net, dem)
        log(f"[flowsim] {tag} (Table II): {net.n_endpoints} accelerators, "
            f"{net.n_nodes - net.n_endpoints} switches, {n_links} directed links, built with "
            f"its demand in {build_s:.2f}s; all-to-all max link load: symmetry {ref:.12f} "
            f"({len(reps)} representatives) in {sym_s:.3f}s (host; JAX's NumPy engine "
            f"{want:.12f}), fraction {frac:.9f}; torch {got:.12f} in {torch_s:.3f}s over "
            f"{chunks} device chunks (cuda, fp64 BFS, float32 sweep; at most "
            f"{max_paths:.0f} shortest paths); rel {rel:.2e} (tol "
            f"{FLOWSIM_RTOL}); a chunk of {split['sources']}: its rows {split['rows_ms']:.1f} "
            f"ms (host), the BFS {split['bfs_ms']:.1f} ms ({split['products']} fp64 products, "
            f"{split['bfs_tflops']:.1f} TFLOP/s), the whole chunk {split['chunk_ms']:.1f} ms "
            f"(CUDA events) [{smi}]")
        if not rel <= FLOWSIM_RTOL or abs(ref - want) > 1e-9 * want:
            raise AssertionError(f"flowsim {tag}: torch {got} vs symmetry {ref} (rel "
                                 f"{rel:.2e}), JAX's NumPy engine {want}")
        out[tag] = {"endpoints": net.n_endpoints, "nodes": net.n_nodes, "links": n_links,
                    "symmetry": ref, "fraction": frac, "torch": got, "rel": rel,
                    "build_s": build_s, "symmetry_s": sym_s,
                    "torch_s": torch_s, "device_chunks": chunks, "max_paths": max_paths,
                    "chunk": split}
        del net, dem, loads
        torch.cuda.empty_cache()  # the 2.2 GB fp64 adjacency
    return out


def _flowsim_chunk_split(net, dem, sources: int = 512) -> dict:
    """Where one source chunk of the torch backend's pass goes: the host's dense
    rows (host clock), the BFS alone and the whole chunk on the card (CUDA
    events), and the BFS's fp64 rate from its products, (S, n) . (n, n) each."""
    from repro_torch.core import flowsim as fs

    U, V, M = net.directed_edges()
    A = fs._dense_adjacency(net, torch.device("cuda"))
    sources = min(sources, dem.n_sources)
    srcs = dem.sources[:sources]
    t0 = time.perf_counter()
    rows = dem.rows(0, sources)
    rows_ms = (time.perf_counter() - t0) * 1e3
    bfs_ms = cuda_ms(lambda: fs._bfs_torch(A, srcs), reps=3, warmup=1)
    chunk_ms = cuda_ms(lambda: fs._edge_loads_chunk_torch(net, srcs, rows, U, V, M, None, A),
                       reps=3, warmup=1)
    products = int(fs._bfs_torch(A, srcs)[0].max()) + 1  # one past the deepest level
    n = net.n_nodes
    del A
    return {"sources": sources, "rows_ms": rows_ms, "bfs_ms": bfs_ms, "chunk_ms": chunk_ms,
            "products": products,
            "bfs_tflops": products * 2 * sources * n * n / (bfs_ms * 1e-3) / 1e12}


def _flowsim_fabrics(smi) -> dict:
    """Failures, a placement and the dragonfly, built with ``build_network`` from
    the port's topology specs: the torch backend's chunked pass on the card
    against the NumPy engine on the host (none of these fabrics declares
    symmetry classes, so each whole call runs every source)."""
    from repro_torch.core import flowsim as fs
    from repro_torch.core import topology as top

    (a, b, x, y), failures = FLOWSIM_FAILED
    failed = fs.build_network(top.HxMesh(a, b, x, y), failures)
    k = FLOWSIM_PLACEMENT
    boards = [(r, c) for r in range(k) for c in range(k)]
    cases = {
        f"hx{a}x{b}-{x}x{y} {failures}": (failed, "alltoall_fraction"),
        f"hx{a}x{b}-{x}x{y} subnetwork {k}x{k} boards": (
            fs.subnetwork(failed, fs.placement_endpoints(failed, boards)),
            "alltoall_fraction"),
        "dragonfly a{a} p{p} h{h} g{groups}".format(**FLOWSIM_DRAGONFLY): (
            fs.build_network(top.Dragonfly(**FLOWSIM_DRAGONFLY)), "max_link_load"),
    }
    out = {}
    for tag, (net, metric) in cases.items():
        links = net.meta["links_per_endpoint"]
        if metric == "alltoall_fraction":
            call = functools.partial(fs.alltoall_fraction, net, links)
        else:
            call = functools.partial(fs.max_link_load, net, "alltoall")
        act = net.active_endpoints()
        t0 = time.perf_counter()
        ref = call()
        numpy_s = time.perf_counter() - t0
        max_paths = _flowsim_max_paths(net, act)
        runs = [_flowsim_on_card(tag, lambda: call(backend="torch")) for _ in range(2)]
        got = runs[-1][0]
        rel = abs(got - ref) / ref
        log(f"[flowsim] {tag}: {len(act)} active endpoints of {net.n_endpoints}, "
            f"{net.n_nodes - net.n_endpoints} switches; all-to-all {metric} numpy {ref:.9f} in "
            f"{numpy_s:.2f}s (host), torch {got:.9f} in {runs[0][1]:.3f}s / {runs[1][1]:.3f}s "
            f"over {runs[1][2]} device chunks (cuda; at most {max_paths:.0f} shortest paths, "
            f"float32 exact below 2**24); rel {rel:.2e} (tol {FLOWSIM_RTOL}) [{smi}]")
        if not rel <= FLOWSIM_RTOL:
            raise AssertionError(f"flowsim {tag}: torch {got} vs numpy {ref} (rel {rel:.2e})")
        out[tag] = {"active": len(act), "nodes": net.n_nodes, metric: ref, "torch": got,
                    "rel": rel, "numpy_s": numpy_s, "torch_s": [r[1] for r in runs],
                    "device_chunks": runs[1][2], "max_paths": max_paths}
    return out


def _flowsim_sparse(smi) -> dict:
    """The torch backend on a sparse ``Demand`` (a traffic token bound to the
    fabric, its rows made a source chunk at a time) on the card against the NumPy
    engine's chunked pass on the host, on FLOWSIM_SPARSE_MESH: the token itself
    (its demand built in the call, the card's warm-up), then its ``Demand``.  A
    bisection on a healthy HxMesh takes the symmetry fast path in
    ``max_link_load``, on the host, so its card case calls ``demand_edge_loads``;
    the symmetry value is held to the same reference."""
    from repro_torch.core import flowsim as fs
    from repro_torch.core import traffic as tr

    a, b, x, y = FLOWSIM_SPARSE_MESH
    net = fs.build_hxmesh(a, b, x, y)
    if net.n_endpoints < 4096:
        raise AssertionError(f"the sparse case has {net.n_endpoints} accelerators, want >= 4096")
    out = {}
    for token in FLOWSIM_SPARSE_TOKENS:
        t0 = time.perf_counter()
        dem = tr.demand(net, token)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = float(fs.demand_edge_loads(net, dem).max())
        numpy_s = time.perf_counter() - t0
        sym = fs.symmetric_max_link_load(net, dem)
        tag = f"hx{a}x{b}-{x}x{y} {token}"
        if sym is None:
            calls = [lambda: fs.max_link_load(net, token, backend="torch"),
                     lambda: fs.max_link_load(net, dem, backend="torch")]
        else:
            calls = [lambda: float(fs.demand_edge_loads(net, tr.demand(net, token),
                                                        backend="torch").max()),
                     lambda: float(fs.demand_edge_loads(net, dem, backend="torch").max())]
        runs = [_flowsim_on_card(tag, call) for call in calls]
        got = [r[0] for r in runs]
        rel = max(abs(g - ref) / ref for g in [*got, *([sym] if sym is not None else [])])
        log(f"[flowsim] {tag}: {net.n_endpoints} accelerators, sparse demand of "
            f"{dem.n_sources} sources ({len(dem.dsts)} explicit entries, {len(dem.groups)} "
            f"spread groups) built in {build_s:.3f}s; max link load numpy {ref:.9f} in "
            f"{numpy_s:.2f}s (host, the chunked pass), symmetry {sym}, torch {got[0]:.9f} from "
            f"the token in {runs[0][1]:.3f}s (its demand built, warm-up) / {got[1]:.9f} from "
            f"the Demand in {runs[1][1]:.3f}s over {runs[1][2]} device chunks (cuda, float32); "
            f"rel {rel:.2e} (tol {FLOWSIM_RTOL}) [{smi}]")
        if not rel <= FLOWSIM_RTOL:
            raise AssertionError(f"flowsim {tag}: torch {got}, symmetry {sym} vs numpy {ref} "
                                 f"(rel {rel:.2e})")
        out[token] = {"endpoints": net.n_endpoints, "numpy": ref, "symmetry": sym, "torch": got,
                      "rel": rel, "build_s": build_s, "numpy_s": numpy_s,
                      "torch_s": [r[1] for r in runs], "device_chunks": runs[1][2]}
    return out


# ---------------------------------------------------------------------------
# the eleventh slice: tensor parallelism over model in serving (dense family)
# ---------------------------------------------------------------------------

TP_ARCH = "llama3.2-3b"
TP_MESHES = ((1, 16), (2, 8))  # (data, model): the bf16 path and the decode on the first
TP_AXES = ("data", "model")
TP_DEVICE = "cuda"  # the TP phases' ranks' device ("cpu" rehearses them at smoke size)
# The TP decode loops: teacher-forced prompt, then greedy steps.  16 rank threads
# share one GIL, so a TP decode step costs 16 ranks' host work (1.1-1.9 s on the
# H100's host): the fp32 gate's loop is cut from the serve phase's 128 + 32 to
# 8 + 2 (64 + 8 before the SSM and hybrid phases took ~150 s of the script's
# time, 16 + 4 before the fifteenth slice's ~170 s), the bf16 loop (reported,
# not gated) to 8 + 2.
TP_PROMPT, TP_DECODE = 8, 2
TP_PROMPT_BF16 = 8
# The collectives GSPMD puts in the JAX package's jitted steps for one layer of
# llama3.2-3b on (data, model) = (1, 16) host devices, B 4 (prefill x 2048), from
# ``PYTHONPATH=src python benchmarks/gspmd_tp_collectives.py`` (jax 0.9.0 on the
# CPU, whose backend upcasts bf16 dots: the f32 is not evidence about a TPU).
GSPMD_LAYER = (
    "prefill: 3 all-reduce f32[4,2048,3072] over 16 (embed, wo, w_down), 1 all-reduce of "
    "the scores f32[4,3,2048,2048] over groups of 2 (head_dim split between 2 ranks a kv "
    "head), all-gathers f32[4,2048,384] and f32[4,2048,3,128] over 2, 4 collective-permutes "
    "of f32[4,2048,1|3,32], 6 all-to-alls of (1|2, 2048, 1|3, 32|64) pieces over 2; decode: "
    "2 all-gathers of the whole KV cache f32[4,2048,8,1,128] over 16 ('involuntary full "
    "rematerialization'), 3 all-reduce f32[4,1,3072], 2 all-to-alls, 3 collective-permutes, "
    "3 small all-gathers, and the greedy argmax as all-gathers of (max, index) s32/f32[4,16]")


def _tp_policy():
    from repro_torch.parallel import sharding as sh

    return sh.Policy()  # (data, model): FSDP over data, TP over model (llama's default_policy)


def _tp_shard(cfg, params, shape, policy=None, free: bool = False) -> tuple:
    """``params`` cut into each rank's blocks on a (data, model) ``LocalMesh`` of the
    card under ``sanitize_specs(param_specs(policy))`` (``_tp_policy()`` by
    default), a leaf at a time (with ``free`` each whole leaf leaves ``params``
    once cut, so that the blocks and the whole tree are never both held): (mesh,
    specs, per-rank block trees), each rank's bytes held to its blocks' under the
    specs."""
    from repro_torch import tree as tree_lib
    from repro_torch.core.comm import LocalMesh
    from repro_torch.parallel import sharding as sh

    policy = policy or _tp_policy()
    mesh = LocalMesh(shape, TP_AXES, TP_DEVICE)  # ranks on one card take turns
    specs = sh.sanitize_specs(params, sh.param_specs(cfg, params, policy), mesh)
    leaves, structure = tree_lib.flatten(params)
    names = [n for n, _ in _named_leaves(params)]
    blocks, want = [[] for _ in range(mesh.size)], [0] * mesh.size
    for i, (name, spec) in enumerate(zip(names, tree_lib.leaves(specs))):
        x = leaves[i]
        leaves[i] = None
        if free:
            *path, key = name.split(".")
            node = params
            for k in path:
                node = node[k]
            node[key] = None
        ns = sh.NamedSharding(mesh, spec)
        for r in range(mesh.size):
            sl = ns.block(r, x.shape)
            blocks[r].append(x[sl].to(TP_DEVICE, copy=True,
                                       memory_format=torch.contiguous_format))
            want[r] += math.prod(s.stop - s.start for s in sl) * x.element_size()
        del x
    trees = [tree_lib.unflatten(structure, b) for b in blocks]
    got = [sum(t.numel() * t.element_size() for t in b) for b in blocks]
    if got != want:
        raise AssertionError(f"[tp] {cfg.name}: the ranks hold {got} B, their blocks "
                             f"under the specs {want}")
    return mesh, specs, trees


def _tree_bytes(tree) -> int:
    from repro_torch import tree as tree_lib

    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


def _tp_rows(mesh, policy, batch: dict, comm) -> dict:
    """The rank's rows of every batch leaf under ``batch_specs`` (the batch axis of
    M-RoPE's (3, B, S) positions is its second)."""
    from repro_torch.parallel import sharding as sh

    n, i = mesh.axis_size(policy.data_axes), comm.axis_index(policy.data_axes)
    out = {}
    for k, v in batch.items():
        dim = sh.batch_axis(k)
        rows = v.shape[dim] // n
        out[k] = v.narrow(dim, i * rows, rows)
    return out


def _tp_heads(mesh, policy) -> list[int]:
    """One rank of each data position (the ranks sharing rows compute alike)."""
    first = {}
    for r in range(mesh.size):
        first.setdefault(mesh.axis_index(r, policy.data_axes), r)
    return [first[i] for i in range(len(first))]


def _rank_slice(mesh, policy, batch, comm, cfg=None):
    """What a rank claims of a replayed routing log's dispatch (``_replayed_routing``):
    its rows (one dispatch group a row), or under ``moe_mode="ep"`` its tokens'
    (token, choice) pairs of the one group of the whole batch (``_ep_whole``)."""
    n, i = mesh.axis_size(policy.data_axes), comm.axis_index(policy.data_axes)
    rows = batch["tokens"].shape[0] // n
    if cfg is not None and cfg.family == "moe" and cfg.moe_mode == "ep":
        pairs = rows * batch["tokens"].shape[1] * cfg.top_k
        return slice(None), slice(i * pairs, (i + 1) * pairs)
    return slice(i * rows, (i + 1) * rows)


@contextlib.contextmanager
def _ep_whole():
    """The unsharded model's EP layer (``moe_mode="ep"`` and no mesh) as the sharded
    path routes it: the whole batch's tokens one dispatch group, as JAX's
    ``_moe_ep`` does and ``moe_apply_ep`` does on one rank."""
    from unittest import mock

    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    real = T._moe_block

    def block(cfg, mp, x, act_specs=None, tp=None):
        if tp is not None or cfg.moe_mode != "ep":
            return real(cfg, mp, x, act_specs, tp)
        b, s, d = x.shape
        xg = x.reshape(1, b * s, d)
        cap = moe.capacity(b * s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        gates, experts, aux = moe._route(xg, mp["router"], cfg.top_k)
        y = moe._group_dispatch(xg, gates, experts, mp["w_gate"], mp["w_up"], mp["w_down"],
                                cap)
        return y.reshape(b, s, d), aux[0]

    with mock.patch.object(T, "_moe_block", block):
        yield


def _tp_prefill(cfg, mesh, blocks, batch, use_kernel=True, policy=None, replay=None) -> tuple:
    """The sharded prefill step on every rank, with an unsharded run's MoE routing
    replayed where ``replay`` holds its log (each rank its rows): (the last
    position's logits in batch order, seconds, the largest difference between
    ranks that share rows)."""
    from repro_torch.train import steps as st

    policy = policy or _tp_policy()
    claim = None

    def fn(comm, p):
        rows = _tp_rows(mesh, policy, batch, comm)
        if claim is not None:
            claim(_rank_slice(mesh, policy, batch, comm, cfg))
        return st.make_prefill_step(cfg, st.TrainOptions(use_kernel=use_kernel),
                                    act_specs={"mesh": comm, "policy": policy})(p, rows)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (_replayed_routing(replay, per_rank=True) if replay is not None
          else contextlib.nullcontext()) as claim:
        outs = mesh.run(fn, blocks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    heads = _tp_heads(mesh, policy)
    spread = max(float((outs[r].float() - outs[h].float()).abs().max()) for r in range(mesh.size)
                 for h in heads if mesh.axis_index(r, policy.data_axes)
                 == mesh.axis_index(h, policy.data_axes))
    return torch.cat([outs[h] for h in heads]), secs, spread


def _tp_decode(cfg, mesh, blocks, prompts, steps: int, policy=None, replay=None) -> tuple:
    """Teacher-force ``prompts`` through ``decode_step`` on every rank under ``policy``
    (``_tp_policy()`` by default), then ``steps`` greedy tokens through
    ``make_decode_step``: (the prompt steps' logits (B, P, V) in batch order, the
    greedy tokens (B, steps), seconds a step).  ``mesh`` None: the unsharded model
    on ``blocks`` (the whole weights).  Where ``replay`` holds a routing log of the
    same steps, the MoE takes its experts (each rank its rows)."""
    from repro_torch.models import get_model
    from repro_torch.train import steps as st

    policy = policy or _tp_policy()
    p_len = prompts.shape[1]
    heads = [0] if mesh is None else _tp_heads(mesh, policy)
    T = get_model(cfg)
    claim = None

    def fn(comm, p):
        act = None if comm is None else {"mesh": comm, "policy": policy}
        toks = prompts if comm is None else _tp_rows(mesh, policy, {"tokens": prompts},
                                                      comm)["tokens"]
        if claim is not None and comm is not None:
            claim(_rank_slice(mesh, policy, {"tokens": prompts}, comm))
        keep = comm is None or comm.rank in heads  # one rank of those sharing rows
        cache = T.init_cache(cfg, toks.shape[0], p_len + steps, dtype=p["embed"].dtype,
                             device=TP_DEVICE, act_specs=act)
        logits = []
        with torch.no_grad():
            for t in range(p_len):
                lg, cache = T.decode_step(cfg, p, cache, toks[:, t:t + 1], act_specs=act)
                if keep:
                    logits.append(lg.float())
        serve = st.make_decode_step(cfg, act_specs=act)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(steps - 1):
            tok, cache = serve(p, cache, tok)
            out.append(tok)
        return (torch.cat(logits, 1) if keep else None), torch.cat(out, 1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (_replayed_routing(replay, per_rank=mesh is not None) if replay is not None
          else contextlib.nullcontext()) as claim:
        outs = [fn(None, blocks)] if mesh is None else mesh.run(fn, blocks)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / (p_len + steps - 1)
    return (torch.cat([outs[r][0] for r in heads]), torch.cat([outs[r][1] for r in heads]),
            secs)


def _tp_fp64(cfg, params, tokens, prompts) -> tuple:
    """The exact answers the fp32 gates measure from: the prefill's last logits and
    the decode's prompt steps' logits of the unsharded model in fp64 (plain
    attention), on ``params`` cast to fp64."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    p64 = tree_lib.tree_map(lambda t: t.double(), params)
    with torch.no_grad():
        hidden = T.forward(cfg, p64, tokens, return_hidden=True)[0]
        last = (hidden[:, -1:] @ layers.unembed(p64)).float()
        del hidden
        cache = T.init_cache(cfg, prompts.shape[0], prompts.shape[1], dtype=torch.float64,
                             device=TP_DEVICE)
        steps = []
        for t in range(prompts.shape[1]):
            lg, cache = T.decode_step(cfg, p64, cache, prompts[:, t:t + 1])
            steps.append(lg.float())
    del p64, cache
    torch.cuda.empty_cache()
    return last, torch.cat(steps, 1)


def _tp_closed_forms(cfg, mesh, batch: int, seq: int, dtype) -> dict:
    """What one rank of the TP prefill moves, from the shapes: calls and input bytes
    by collective, and the all-to-all bytes it sends to each rank of its group."""
    from repro_torch.parallel import sharding as sh

    dp, n = mesh.shape["data"], mesh.shape["model"]
    rows, d, hd, n_l = batch // dp, cfg.d_model, cfg.kq_head_dim, cfg.n_layers
    elt = torch.tensor([], dtype=dtype).element_size()
    act = rows * seq * d
    psum = {"calls": 1, "bytes": act * elt}  # the embed
    # wo and w_down a layer: a reduce-scatter of the fp32 partial over model and
    # an all-gather of the sums, rounded to the model's dtype
    rs = {"calls": 2 * n_l, "bytes": 2 * n_l * act * 4}
    ag = {"calls": 2 * n_l, "bytes": 2 * n_l * act // n * elt}
    # FSDP: every (L, ., .) weight, the embed and the unembed, a block over data
    layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
             + 3 * d * cfg.d_ff)
    fsdp_calls = (7 * n_l + 2) if dp > 1 else 0
    fsdp_bytes = (n_l * layer + 2 * cfg.vocab * d) * elt // (dp * n) if dp > 1 else 0
    gather = {"calls": fsdp_calls + 1 + ag["calls"],
              "bytes": fsdp_bytes + rows * cfg.vocab // n * elt + ag["bytes"]}
    hs = sh.head_split(rows, cfg.n_kv_heads, n)
    if hs is None:
        raise AssertionError(f"[tp-serve] {rows} rows x {cfg.n_kv_heads} kv heads over {n}: "
                             "the chip's meshes take the pair route")
    qo = rows * seq * cfg.n_heads * hd // n * elt  # q in, and the output back
    kv = rows * seq * cfg.n_kv_heads * hd // n * elt
    a2a = {"calls": 2 * n_l, "bytes": n_l * (2 * qo + 2 * kv)}  # q, k, v in one; o
    pair = n_l * (2 * qo + 2 * kv) // hs.groups  # to each other rank of the group
    return {"psum": psum, "all_gather": gather, "all_to_all": a2a, "reduce_scatter": rs,
            "pair_bytes": pair,
            "sum_bytes": rs["bytes"] // n, "model": n, "groups": hs.groups,
            "split": (hs.rows, hs.kv_heads)}


def _tp_stats_check(tag, mesh, want) -> dict:
    """``mesh.stats`` of one TP prefill against ``_tp_closed_forms``, every rank alike."""
    st, size = mesh.stats, mesh.size
    got = {kind: {"calls": getattr(st, f"{kind}_calls") // size,
                  "bytes": st.payload[kind] // size}
           for kind in ("psum", "all_gather", "all_to_all", "reduce_scatter")}
    for kind in got:
        if got[kind] != want[kind] or getattr(st, f"{kind}_calls") % size:
            raise AssertionError(f"[{tag}] {kind}: {got[kind]} a rank, want {want[kind]}")
    g, n = want["groups"], want["model"]  # ranks along model are consecutive
    pairs = {(a, b): want["pair_bytes"] * (a // g == b // g) + want["sum_bytes"]
             for a in range(size) for b in range(size) if a != b and a // n == b // n}
    if dict(st.bytes) != pairs:
        raise AssertionError(f"[{tag}] all_to_all sends {dict(st.bytes)}, want "
                             f"{want['pair_bytes']} to each other rank of a group of {g} and "
                             f"{want['sum_bytes']} to each other rank along model")
    return {**got, "sent_a_rank": (g - 1) * want["pair_bytes"], "group": g,
            "sum_sent_a_rank": (n - 1) * want["sum_bytes"], "split_rows_kv": want["split"]}


def phase_tp_serve(smi) -> dict:
    """llama3.2-3b at full width and depth served tensor-parallel over ``model`` on 16
    rank threads of cuda:0 (``parallel/tensor_parallel.py``), each rank computing
    from its blocks alone:

    * bf16 on (data, model) = (1, 16): the prefill step (B 4 x 2048) through the sm90
      kernel, 448 launches a call (28 a rank), one warm-up and three timed calls;
      CommStats against the closed forms; the decode loop (TP_PROMPT_BF16
      teacher-forced, TP_DECODE greedy) beside the unsharded one, token agreement
      reported;
    * fp32 through the tf32 kernel, on (1, 16) and on (2, 8) (whose FSDP gathers over
      data run): the TP prefill's last logits, and on (1, 16) the TP decode's
      TP_PROMPT prompt steps' logits, against the fp64 run of the same weights and
      tokens, within max(FP32_TOL, floor), the floor the plain chunked path against
      plain dense.  The unsharded fp32 steps (``make_prefill_step`` through the
      tf32 kernel; the decode loop) are held to the fp64 run too and reported:
      at this init they are ~1e-3 from it themselves (their long fp32 dot
      products), so TP is reported beside them, not gated on them.  The greedy
      tokens' agreement is reported.

    Forward only: the ranks' backwards would share the card's one autograd thread."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch

    cfg = get_config(TP_ARCH)
    out = {"gspmd_layer": GSPMD_LAYER}
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)["tokens"]).cuda()
    prompts = tokens[:, :TP_PROMPT].contiguous()
    prompts16 = tokens[:, :TP_PROMPT_BF16].contiguous()
    n_l = cfg.n_layers

    # -- bf16 on (1, 16) ------------------------------------------------------
    params, meta = _load_model(cfg, "tp-serve", torch.bfloat16)
    ref16, _ = _prefill(cfg, params, tokens, use_kernel=True)
    ref16 = ref16.clone()
    dref16, tref16, dsec_ref16 = _tp_decode(cfg, None, params, prompts16, TP_DECODE)
    log(f"[tp-serve] the unsharded bf16 prefill and decode ({dsec_ref16 * 1e3:.1f} ms a step) "
        "done; cutting the weights into 16 ranks' blocks")
    mesh, _, blocks = _tp_shard(cfg, params, TP_MESHES[0])
    rank_bytes = [_tree_bytes(b) for b in blocks]
    del params
    torch.cuda.empty_cache()
    ranks = mesh.size
    secs, launches = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        mesh.stats.reset()
        _reset_counts()
        logits, t, spread = _tp_prefill(cfg, mesh, blocks, {"tokens": tokens})
        launches = _expect_launches("[tp-serve] bf16 TP prefill", sm90=ranks * n_l)
        secs.append(t)
        log(f"[tp-serve] bf16 TP prefill call {i}: {t:.3f}s")
        if i == 0:
            stats = _tp_stats_check("tp-serve bf16", mesh,
                                    _tp_closed_forms(cfg, mesh, PREFILL_BATCH, PREFILL_LEN,
                                                     torch.bfloat16))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"[tp-serve] bf16 TP logits {tuple(logits.shape)} not finite or "
                             "misshapen")
    bf16_err = rel_l2(logits.float(), ref16.float())
    bf16_agree = float((logits.argmax(-1) == ref16.argmax(-1)).float().mean())
    median = statistics.median(secs[1:])
    dtp16, ttp16, dsec_tp16 = _tp_decode(cfg, mesh, blocks, prompts16, TP_DECODE)
    dec16_err = rel_l2(dtp16, dref16)
    agree16 = float((ttp16 == tref16).float().mean())
    ntok = PREFILL_BATCH * PREFILL_LEN
    log(f"[tp-serve] {cfg.name} bf16, {n_l} layers, {ranks} rank threads of cuda:0 on "
        f"(data, model) = {TP_MESHES[0]}, batch {PREFILL_BATCH} x {PREFILL_LEN}: TP prefill "
        f"{median:.3f}s median of 3 after a warm-up ({', '.join(f'{t:.3f}' for t in secs)} s; "
        f"{ntok / median:.0f} tok/s; no speed claim: 16 ranks share one card), peak "
        f"{peak:.2f} GiB; launches a call {launches} ({n_l} a rank); each rank's "
        f"parameters {rank_bytes[0]:,} B (min {min(rank_bytes):,}, max {max(rank_bytes):,}, "
        f"all {sum(rank_bytes):,}), its blocks' under param_specs; ranks along model within "
        f"{spread:.3e}; vs the unsharded prefill rel_l2 {bf16_err:.3e}, argmax agreement "
        f"{bf16_agree:.2f} (bf16, reported) [{smi}]")
    log(f"[tp-serve] CommStats a rank, one bf16 prefill, equal to the closed forms: psum "
        f"{stats['psum']['calls']} calls / {stats['psum']['bytes']:,} B in (the embed), "
        f"all_gather {stats['all_gather']['calls']} / {stats['all_gather']['bytes']:,} B (the "
        f"logits; the {2 * n_l} row sums' bf16 sums), all_to_all "
        f"{stats['all_to_all']['calls']} / {stats['all_to_all']['bytes']:,} B in (q, k, v and o: "
        f"{stats['sent_a_rank']:,} B sent to the {stats['group'] - 1} other ranks of its "
        f"group, a rank attending {stats['split_rows_kv'][0]} row x {stats['split_rows_kv'][1]} "
        f"kv heads), reduce_scatter {stats['reduce_scatter']['calls']} / "
        f"{stats['reduce_scatter']['bytes']:,} B in (the row sums' fp32 partials: "
        f"{stats['sum_sent_a_rank']:,} B sent to the other ranks along model) [{smi}]")
    log(f"[tp-serve] GSPMD's collectives for one layer of the JAX step, for the record: "
        f"{GSPMD_LAYER}")
    log(f"[tp-serve] bf16 decode ({TP_PROMPT_BF16} teacher-forced, {TP_DECODE} greedy, batch "
        f"{PREFILL_BATCH}): TP {dsec_tp16 * 1e3:.1f} ms a step, unsharded "
        f"{dsec_ref16 * 1e3:.1f} ms; prompt logits rel_l2 {dec16_err:.3e}, greedy token "
        f"agreement {agree16:.3f} (bf16, reported) [{smi}]")
    out["bf16"] = {"mesh": TP_MESHES[0], "s": median, "s_runs": secs, "peak_gib": peak,
                   "launches": launches, "rank_param_bytes": rank_bytes, "stats": stats,
                   "rank_spread": spread, "rel_l2_vs_unsharded": bf16_err,
                   "argmax_agree": bf16_agree, "decode_ms_tp": dsec_tp16 * 1e3,
                   "decode_ms_unsharded": dsec_ref16 * 1e3, "decode_rel_l2": dec16_err,
                   "token_agree": agree16, **meta}
    del blocks, mesh, ref16, dref16, dtp16, logits
    torch.cuda.empty_cache()

    # -- fp32 gates on (1, 16) and (2, 8) ---------------------------------------
    params, meta32 = _load_model(cfg, "tp-serve", torch.float32)
    ex, dex = _tp_fp64(cfg, params, tokens, prompts)

    def last(c, use_kernel):
        logits, _ = _prefill(c, params, tokens, use_kernel=use_kernel)
        return logits.clone()

    ref = last(cfg, True)
    floor = rel_l2(last(dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK), False),
                   last(cfg, False))
    dref, tref, dsec_ref = _tp_decode(cfg, None, params, prompts, TP_DECODE)
    bound = max(FP32_TOL, floor)
    ref_err, dref_err = rel_l2(ref, ex), rel_l2(dref, dex)
    log(f"[tp-serve] {cfg.name} fp32, batch {PREFILL_BATCH} x {PREFILL_LEN}: the unsharded "
        f"prefill (tf32 kernel) is {ref_err:.3e} (rel_l2) from the fp64 run of the same weights "
        f"and tokens, its decode's {TP_PROMPT} prompt steps {dref_err:.3e} (reported); floor "
        f"(plain chunked {FLOOR_CHUNK} vs plain dense) {floor:.3e}, TP's bound max({FP32_TOL}, "
        f"floor) = {bound:.3e} [{smi}]")
    out["fp32"] = {"floor": floor, "bound": bound, "unsharded_vs_fp64": ref_err,
                   "unsharded_decode_vs_fp64": dref_err, **meta32}
    for shape in TP_MESHES:
        mesh, _, blocks = _tp_shard(cfg, params, shape)
        rank_bytes = [_tree_bytes(b) for b in blocks]
        mesh.stats.reset()
        _reset_counts()
        logits, t, spread = _tp_prefill(cfg, mesh, blocks, {"tokens": tokens})
        launches = _expect_launches(f"[tp-serve] fp32 TP prefill on {shape}",
                                    tf32=mesh.size * n_l)
        stats = _tp_stats_check(f"tp-serve fp32 {shape}", mesh, _tp_closed_forms(
            cfg, mesh, PREFILL_BATCH, PREFILL_LEN, torch.float32))
        err, vs_ref = rel_l2(logits, ex), rel_l2(logits, ref)
        rec = {"vs_fp64": err, "vs_unsharded": vs_ref, "s": t, "launches": launches,
               "stats": stats, "rank_param_bytes": rank_bytes, "rank_spread": spread,
               "argmax_agree": float((logits.argmax(-1) == ref.argmax(-1)).float().mean())}
        line = (f"[tp-serve] {cfg.name} fp32 on (data, model) = {shape}, batch {PREFILL_BATCH} x "
                f"{PREFILL_LEN}, through tf32: TP prefill last logits vs the fp64 run rel_l2 "
                f"{err:.3e} (tol max({FP32_TOL}, floor) = {bound:.3e}; the unsharded prefill's "
                f"{ref_err:.3e}), vs the unsharded prefill {vs_ref:.3e}, same argmax "
                f"{rec['argmax_agree']:.2f}; {t:.3f}s; launches {launches}; rank bytes "
                f"{rank_bytes[0]:,}; CommStats a rank psum {stats['psum']['calls']} / "
                f"{stats['psum']['bytes']:,} B, all_gather {stats['all_gather']['calls']} / "
                f"{stats['all_gather']['bytes']:,} B, all_to_all {stats['all_to_all']['calls']}"
                f" / {stats['all_to_all']['bytes']:,} B, reduce_scatter "
                f"{stats['reduce_scatter']['calls']} / {stats['reduce_scatter']['bytes']:,} B "
                f"(closed forms)")
        if not (err <= bound and torch.isfinite(logits).all()):
            raise AssertionError(f"{line}: over the bound")
        if shape == TP_MESHES[0]:
            dtp, ttp, dsec_tp = _tp_decode(cfg, mesh, blocks, prompts, TP_DECODE)
            derr, dvs_ref = rel_l2(dtp, dex), rel_l2(dtp, dref)
            rec.update(decode_vs_fp64=derr, decode_vs_unsharded=dvs_ref,
                       token_agree=float((ttp == tref).float().mean()),
                       decode_ms_tp=dsec_tp * 1e3, decode_ms_unsharded=dsec_ref * 1e3)
            line += (f"; decode ({TP_PROMPT} teacher-forced, {TP_DECODE} greedy): prompt "
                     f"logits vs the fp64 run's rel_l2 {derr:.3e} (tol {bound:.3e}; the "
                     f"unsharded decode's {dref_err:.3e}), vs the unsharded decode's "
                     f"{dvs_ref:.3e}, greedy token agreement {rec['token_agree']:.3f} "
                     f"(reported), TP {dsec_tp * 1e3:.1f} ms a step, unsharded "
                     f"{dsec_ref * 1e3:.1f} ms")
            if not (derr <= bound and torch.isfinite(dtp).all()):
                raise AssertionError(f"{line}: decode over the bound")
            del dtp
        log(line + f" [{smi}]")
        out["fp32"]["x".join(map(str, shape))] = rec
        del blocks, mesh, logits
        torch.cuda.empty_cache()
    del params, ref, dref, ex, dex
    torch.cuda.empty_cache()
    out["launches"] = out["bf16"]["launches"]
    return out


# ---------------------------------------------------------------------------
# the twelfth slice: FSDP and tensor parallelism in training (dense family)
# ---------------------------------------------------------------------------

TP_TRAIN_LAYERS = 4  # the gate's depth, of llama3.2-3b's 28, at the 28-layer init's scale
# (sync, (data, model)): TP alone; the FSDP gathers and their reduce-scatters; the
# paper's ring over data on blocks whole over data
TP_TRAIN_RUNS = (("auto", (1, 16)), ("auto", (2, 8)), ("ring", (2, 8)))
TP_TRAIN_OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)  # the sync gate's
TP_TRAIN_FULL = (2, 8)  # the full-depth step: 1 row's layer inputs a rank (2 on (1, 16))


def _tp_train_closed_forms(cfg, shape, batch: int, seq: int, sync: str) -> dict:
    """What one rank of a TP train step (``make_tp_value_and_grad``, then AdamW)
    calls and moves, from the shapes: calls and input bytes by collective, fp32.
    The forward runs each layer and the embed twice (no-grad, then recomputed
    under the tape), and the backward runs each cut's transpose once."""
    from repro_torch.parallel import sharding as sh

    dp, n = shape
    n_l, d, hd, f, v = cfg.n_layers, cfg.d_model, cfg.kq_head_dim, cfg.d_ff, cfg.vocab
    rows = batch // dp
    tok, act = rows * seq, rows * seq * d
    fsdp = sync == "auto" and dp > 1
    qkv = tok * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd // n  # q, k, v in one exchange
    layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d + 3 * d * f
    top = v * d  # the embed and the unembed, each
    out = {kind: {"calls": 0, "bytes": 0}
           for kind in ("psum", "all_gather", "all_to_all", "reduce_scatter")}

    def add(kind, calls, elems):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += 4 * elems

    # the row sums, forward and recomputed: a reduce-scatter of the fp32 partial and
    # an all-gather of the sums, 2 a layer
    add("reduce_scatter", 4 * n_l, 4 * n_l * act)
    add("all_gather", 4 * n_l, 4 * n_l * act // n)
    if fsdp:  # 7 weights a layer and the embed, forward and recomputed; the unembed once
        add("all_gather", 14 * n_l + 3, (2 * n_l * layer + 3 * top) // (dp * n))
        add("reduce_scatter", 7 * n_l + 2, (n_l * layer + 2 * top) // n)  # the transposes
    if sh.head_split(rows, cfg.n_kv_heads, n) is None:  # the gather route
        add("all_gather", 2 * n_l, 2 * n_l * qkv)
        add("reduce_scatter", n_l, n_l * n * qkv)
    else:  # q, k, v in, o back: forward, recomputed and the transposes
        add("all_to_all", 6 * n_l, 3 * n_l * (qkv + tok * cfg.n_heads * hd // n))
    add("all_gather", 1, tok)  # the loss's row max
    # the embed, twice; the loss's exp-sums and label logit; the pvarys'
    # transposes (the loss's and 2 a layer); the norm's square sums
    add("psum", 2 + 2 + 1 + 2 * n_l + 1, 2 * act + 2 * tok + act + 2 * n_l * act + 1)
    if sync == "auto" and dp > 1:  # the loss's mean over data; the norm scales
        add("psum", 1 + 3, 1 + 2 * n_l * d + d)
    if sync != "auto":  # the loss and aux over data, after the ring
        add("psum", 2, 2)
    blocks = (n_l * layer + 2 * top) // (dp * n if fsdp else n) + (2 * n_l + 1) * d
    ring = 0 if sync == "auto" else 2 * (dp - 1) * -(-blocks // dp) * 4
    return {**out, "ppermute_bytes": ring, "rank_param_bytes": 4 * blocks}


def _tp_step_stats_check(tag, mesh, want) -> dict:
    """``mesh.stats`` of one sharded step against its closed forms
    (``_tp_train_closed_forms``, ``_fam_closed_forms``), every rank alike; under a
    sync mode also the ring's ppermute bytes, the sends between ranks of two data
    rows (the step's other sends stay in a rank's model group)."""
    st, size, n = mesh.stats, mesh.size, mesh.shape["model"]
    got = {kind: {"calls": getattr(st, f"{kind}_calls") // size,
                  "bytes": st.payload[kind] // size}
           for kind in ("psum", "all_gather", "all_to_all", "reduce_scatter")}
    for kind in got:
        if got[kind] != want[kind] or getattr(st, f"{kind}_calls") % size:
            raise AssertionError(f"[{tag}] {kind}: {got[kind]} a rank, want {want[kind]}")
    if want["ppermute_bytes"]:
        cross = sum(b for (src, dst), b in st.bytes.items() if src // n != dst // n)
        if cross != size * want["ppermute_bytes"]:
            raise AssertionError(f"[{tag}] the ring sent {cross} B, want {size} x "
                                 f"{want['ppermute_bytes']}")
        got["ppermute_bytes"] = cross // size
    return got


def _tp_whole(mesh, spec, shape, blocks) -> torch.Tensor:
    """The global tensor of ``shape`` put together on the card from every rank's block
    under ``spec``."""
    from repro_torch.parallel import sharding as sh

    out = torch.empty(shape, dtype=blocks[0].dtype, device=TP_DEVICE)
    ns = sh.NamedSharding(mesh, spec)
    for r, b in enumerate(blocks):
        out[ns.block(r, shape)] = b
    return out


def _row_chunks(shape, elements: int = 1 << 25) -> list[slice]:
    """Slices of a tensor of ``shape`` along its first dimension, each of at most
    ``elements`` (at least one row): the fp64 comparisons' working set."""
    rows = max(1, elements // max(1, math.prod(shape[1:])))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


@contextlib.contextmanager
def _no_autograd_collectives():
    """Every collective's ``autograd.Function`` raises while this is open: rank
    threads on one card share its one autograd engine thread, so a TP train step
    here must take the cut route (``make_tp_value_and_grad``)."""
    from unittest import mock

    from repro_torch.core import comm as comm_lib
    from repro_torch.parallel import tensor_parallel as tp_lib

    def refuse(*_):
        raise AssertionError("a collective under autograd on rank threads of one card")

    fns = [getattr(comm_lib, n) for n in ("_PSum", "_PVary", "_AllGather", "_ReduceScatter",
                                          "_AllToAll", "_PPermute")] + [tp_lib._RowSum]
    with contextlib.ExitStack() as stack:
        for fn in fns:
            stack.enter_context(mock.patch.object(fn, "apply", refuse))
        yield


def _tp_train_step(cfg, ocfg, mesh, blocks, batch, sync, policy=None, replay=None,
                   ce_chunk: int = 0) -> dict:
    """One sharded train step (AdamW from the init state) of every rank's ``blocks``
    under ``policy`` (``_tp_policy()`` by default; the rows by ``batch_specs``),
    through the tf32 kernel, which it takes over (the list is emptied), with an
    unsharded run's MoE routing replayed where ``replay`` holds its log, the loss
    chunked with ``ce_chunk``: every rank's updated blocks and first moment, its
    metrics, the step's seconds and peak memory; the launches and CommStats are
    left in the counters."""
    from repro_torch import tree as tree_lib
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as st

    policy = policy or _tp_policy()
    opts = st.TrainOptions(sync=sync, use_kernel=True, remat=True, ce_chunk=ce_chunk)
    per_rank = list(blocks)
    blocks.clear()
    claim = None

    def fn(comm, p):
        step = st.make_train_step(cfg, ocfg, opts, act_specs={"mesh": comm, "policy": policy})
        rows = _tp_rows(mesh, policy, batch, comm)
        if claim is not None:
            claim(_rank_slice(mesh, policy, batch, comm, cfg))
        p, state, m = step(p, opt.init(p), rows)
        return p, state.m, {k: float(v) for k, v in m.items()}

    from unittest import mock

    from repro_torch.models import transformer as T
    from repro_torch.parallel import tensor_parallel as tp_lib

    # the loss's peak: from the first rank's entry into the loss (the peak reset
    # there, the one before kept) to the last rank's first layer recomputed after
    # it (every rank's loss and its backward done; the transformer families)
    lock = threading.Lock()
    marks = {"pre": 0, "base": None, "ranks": set(), "loss_peak": None}

    def entered(real):
        def loss(*args, **kwargs):
            with lock:
                if marks["base"] is None:
                    torch.cuda.synchronize()
                    marks["pre"] = torch.cuda.max_memory_allocated()
                    marks["base"] = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
            return real(*args, **kwargs)
        return loss

    real_layer = T.decoder_layer

    def decoder_layer(*args, **kwargs):
        if torch.is_grad_enabled() and marks["base"] is not None:
            with lock:
                marks["ranks"].add(threading.get_ident())
                if len(marks["ranks"]) == mesh.size and marks["loss_peak"] is None:
                    torch.cuda.synchronize()
                    marks["loss_peak"] = torch.cuda.max_memory_allocated() - marks["base"]
        return real_layer(*args, **kwargs)

    # the peak up to the gradient: read as each rank enters the clipping norm
    # (every rank's gradient is done when the last does; AdamW follows its psum)
    grad_peaks, real_norm = [], tp_lib.TensorParallel.global_norm

    def global_norm(self, grads):
        grad_peaks.append(torch.cuda.max_memory_allocated())
        return real_norm(self, grads)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh.stats.reset()
    _reset_counts()
    t0 = time.perf_counter()
    replayed = (_replayed_routing(replay, per_rank=True) if replay is not None
                else contextlib.nullcontext())
    with _no_autograd_collectives(), replayed as claim, \
            mock.patch.object(tp_lib.TensorParallel, "global_norm", global_norm), \
            mock.patch.object(st, "_tp_loss", entered(st._tp_loss)), \
            mock.patch.object(st, "_tp_chunked_loss_cut", entered(st._tp_chunked_loss_cut)), \
            mock.patch.object(T, "decoder_layer", decoder_layer):
        outs = mesh.run(fn, per_rank)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = max(marks["pre"], torch.cuda.max_memory_allocated())
    del per_rank
    if not all(t.device.type == TP_DEVICE for t in tree_lib.leaves(outs[0][0])):
        raise AssertionError("[tp] the step's blocks left the card")
    metrics = [o[2] for o in outs]
    if any(m != metrics[0] for m in metrics):
        raise AssertionError(f"[tp] the ranks' metrics differ: {metrics}")
    return {"outs": outs, "metrics": metrics[0], "s": secs, "peak": peak,
            "grad_peak": max([marks["pre"]] + grad_peaks[-1:]), "loss_peak": marks["loss_peak"]}


def phase_tp_train(smi, train_loss: dict) -> dict:
    """llama3.2-3b at full width trained tensor-parallel over ``model`` (FSDP over
    ``data``) on 16 rank threads of cuda:0, each rank on its blocks of the weights and
    AdamW moments and its rows, through ``make_train_step`` (``make_tp_value_and_grad``:
    no collective under autograd, which this phase enforces) and the tf32 kernel:

    * the gate, at TP_TRAIN_LAYERS of 28 layers at the 28-layer init's scale, fp32, B
      2 x 2048, remat, one AdamW step from the init state: on (data, model) = (1, 16),
      on (2, 8) (the FSDP gathers and their reduce-scatters) and on (2, 8) with
      ``sync="ring"``; against the unsharded model in fp64 on the same weights and
      tokens (plain attention): the loss, ``grad_norm`` and every leaf's clipped
      gradient (the first moment over 1 - b1, put together from the blocks) within
      max(FP32_TOL, floor), the floor being the fp32 error of a path that shares
      no code of TP's and no kernel: the plain chunked step's (``_reference_runs``)
      own distance from the fp64 model; and the updated parameters within
      SYNC_STEP_TOL plus lr·|u(g) - u(g64)| (AdamW's first update, the sync gate's
      term).  The ring run is held to the (2, 8) auto run, two fp32 paths, within
      max(FP32_TOL, floor), the floor being the plain chunked path's distance from
      plain dense (as ``phase_train`` measures it).  The other fp32 runs' own
      distances from fp64 (plain dense, the unsharded step through the tf32 kernel,
      as TP, and the same with the flash op in fp64) are printed beside, not gated.
      2 tf32 launches a layer a rank (the forward and the recompute): 128 a step;
      ``CommStats`` against ``_tp_train_closed_forms``;
    * llama3.2-3b whole (28 layers) on TP_TRAIN_FULL: one step, its seconds, peak
      memory and 896 launches; its loss against ``phase_train``'s on the same init
      and tokens (within LOSS_RTOL)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt

    full = get_config(TP_ARCH)
    cfg = dataclasses.replace(full, n_layers=TP_TRAIN_LAYERS)
    ocfg = opt.AdamWConfig(**TP_TRAIN_OCFG, schedule=full.schedule)
    lr = float(opt.schedule_lr(ocfg, torch.tensor(1)))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(full, TRAIN_LEN, TRAIN_BATCH).items()}
    params, meta = _load_model(cfg, "tp-train", torch.float32)
    _rescale_stacks(params["layers"], TP_TRAIN_LAYERS, full.n_layers)
    names = [n for n, _ in _named_leaves(params)]
    out = {"layers": TP_TRAIN_LAYERS, "batch": [TRAIN_BATCH, TRAIN_LEN], **meta, "runs": {}}
    t_phase = time.perf_counter()

    def first_update(g):  # u(g) of AdamW's first step: m^ = g, sqrt(v^) = |g|
        return g / (g.abs() + ocfg.eps)

    # -- the unsharded references: the model in fp64 (plain attention); then
    #    _reference_runs' four fp32 runs (the gate's floor: the plain chunked one)
    p64 = tree_lib.tree_map(lambda t: t.double(), params)
    ref = _loss_and_grads(cfg, p64, batch, use_kernel=False)
    del p64
    g64 = dict(_named_leaves(ref.pop("grads")))
    norm64 = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
    scale64 = min(1.0, ocfg.clip_norm / norm64)
    # the clipped fp64 gradient and the fp64 update, kept on the host (the ring
    # run's blocks are whole over data: twice the auto runs' on the card)
    p1_64 = {}
    for n, p in _named_leaves(params):
        g64[n] = g64[n] * scale64
        p1_64[n] = (p.double() - lr * (first_update(g64[n]) + ocfg.weight_decay
                                       * p.double())).cpu()
        g64[n] = g64[n].cpu()
    torch.cuda.empty_cache()
    runs, host = _reference_runs(cfg, params, batch)
    host["plain"] = {n: g.cpu() for n, g in _named_leaves(runs["plain"].pop("grads"))}
    torch.cuda.empty_cache()
    vs64 = {}  # each run's distances from the fp64 model
    for name, r in runs.items():
        scale = min(1.0, ocfg.clip_norm / r["norm"])
        vs64[name] = {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                      "norm": abs(r["norm"] - norm64) / norm64,
                      "leaves": {n: rel_l2(g.cuda().double() * scale, g64[n].cuda())
                                 for n, g in host[name].items()}}
    # the floor of two fp32 paths (plain chunked against plain dense, as
    # phase_train measures it), for the ring run against the auto run
    plain, chunked, kern = runs["plain"], runs["chunked"], runs["kernel"]
    floor = {"loss": abs(chunked["loss"] - plain["loss"]) / abs(plain["loss"]),
             "norm": abs(chunked["norm"] - plain["norm"]) / plain["norm"],
             "leaves": {n: rel_l2(g.cuda(), host["plain"][n].cuda())
                        for n, g in host["chunked"].items()}}
    del host
    torch.cuda.empty_cache()
    bound_fp32 = {"loss": max(FP32_TOL, floor["loss"]), "norm": max(FP32_TOL, floor["norm"]),
                  "leaves": {n: max(FP32_TOL, f) for n, f in floor["leaves"].items()}}
    # against fp64: the fp32 floor of a path that shares no code of TP's and no
    # kernel, the plain chunked path's own distance from fp64
    bound = {"loss": max(FP32_TOL, vs64["chunked"]["loss"]),
             "norm": max(FP32_TOL, vs64["chunked"]["norm"]),
             "leaves": {n: max(FP32_TOL, f) for n, f in vs64["chunked"]["leaves"].items()}}
    kern_vs = {"loss": vs64["kernel"]["loss"], "norm": vs64["kernel"]["norm"],
               "leaf_max": max(vs64["kernel"]["leaves"].values())}
    plain_vs = vs64["plain"]
    log(f"[tp-train] {cfg.name} at {cfg.n_layers} of {full.n_layers} layers (the "
        f"{full.n_layers}-layer init's scale), fp32, batch {TRAIN_BATCH} x {TRAIN_LEN}, remat: "
        f"fp64 loss {ref['loss']:.7f}, grad norm {norm64:.6e}; against it (loss, norm, leaves "
        f"up to; rel_l2 of the clipped gradient): "
        + "; ".join(f"{label} {vs64[name]['loss']:.2e}, {vs64[name]['norm']:.2e}, "
                    f"{max(vs64[name]['leaves'].values()):.2e}"
                    for name, label in (("chunked", "the plain chunked fp32 step (the gate's "
                                         "floor)"),
                                        ("plain", "plain dense fp32 (reported)"),
                                        ("kernel", "the unsharded tf32 step (reported)"),
                                        ("fp64", "it with the flash op in fp64 (reported)")))
        + f"; floor of two fp32 paths (plain chunked {FLOOR_CHUNK} vs plain dense): loss "
        f"{floor['loss']:.2e}, norm {floor['norm']:.2e}, leaves up to "
        f"{max(floor['leaves'].values()):.2e}; {kern['s']:.2f}s, peak {kern['peak_gib']:.1f} GiB "
        f"[{smi}]")
    out["fp64"] = {"loss": ref["loss"], "grad_norm": norm64, "s": ref["s"],
                   "peak_gib": ref["peak_gib"]}
    out["unsharded_fp32"] = {"loss": kern["loss"], "grad_norm": kern["norm"],
                             "vs_fp64": kern_vs, "leaf_vs_fp64": vs64["kernel"]["leaves"],
                             "s": kern["s"], "peak_gib": kern["peak_gib"]}
    out["floor"] = floor
    out["chunked_fp32_vs_fp64"] = vs64["chunked"]
    out["plain_fp32_vs_fp64"] = plain_vs
    out["fp64_op_vs_fp64"] = vs64["fp64"]

    # -- the TP steps
    auto = None
    for sync, shape in TP_TRAIN_RUNS:
        tag = f"{sync}_{shape[0]}x{shape[1]}"
        label = f"[tp-train] {cfg.name} {sync} on (data, model) = {shape}"
        policy = _tp_policy() if sync == "auto" else dataclasses.replace(_tp_policy(), fsdp=False)
        mesh, specs, blocks = _tp_shard(cfg, params, shape, policy)
        run = _tp_train_step(cfg, ocfg, mesh, blocks, batch, sync)
        outs, m = run["outs"], run["metrics"]
        launches = _expect_launches(label, tf32=mesh.size * 2 * cfg.n_layers)
        want = _tp_train_closed_forms(cfg, shape, TRAIN_BATCH, TRAIN_LEN, sync)
        stats = _tp_step_stats_check(f"tp-train {tag}", mesh, want)
        spec_of = dict(zip(names, tree_lib.leaves(specs)))
        leaf_err, leaf_vs_auto, excess, worst = {}, {}, -1.0, 0.0
        new_auto = {}
        for i, (n, p0) in enumerate(_named_leaves(params)):
            gt = _tp_whole(mesh, spec_of[n], p0.shape, [tree_lib.leaves(o[1])[i] for o in outs])
            pt = _tp_whole(mesh, spec_of[n], p0.shape, [tree_lib.leaves(o[0])[i] for o in outs])
            gt /= 1 - ocfg.b1  # the clipped gradient the step applied
            sq = dict.fromkeys(("fp64", "fp64_ref", "auto", "auto_ref"), 0.0)
            for sl in _row_chunks(p0.shape):  # fp64 on the card, a chunk of rows at a time
                g, p = gt[sl].double(), pt[sl].double()
                refs = [("fp64", g64[n][sl].cuda(), p1_64[n][sl].cuda())]
                if auto is not None:  # the ring run against the auto run on its mesh
                    refs.append(("auto", auto[n][0][sl].cuda().double(),
                                 auto[n][1][sl].cuda().double()))
                for key, g_ref, p_ref in refs:
                    sq[key] += float(((g - g_ref) ** 2).sum())
                    sq[key + "_ref"] += float((g_ref ** 2).sum())
                    d = (p - p_ref).abs()
                    if key == "fp64":
                        worst = max(worst, float(d.max()))
                    d -= SYNC_STEP_TOL["rtol"] * p_ref.abs() + SYNC_STEP_TOL["atol"]
                    d -= lr * (first_update(g) - first_update(g_ref)).abs()
                    excess = max(excess, float(d.max()))
                    del g_ref, p_ref, d
                del g, p, refs
            leaf_err[n] = math.sqrt(sq["fp64"] / sq["fp64_ref"])
            if auto is not None:
                leaf_vs_auto[n] = math.sqrt(sq["auto"] / sq["auto_ref"])
            elif sync == "auto" and shape == (2, 8):
                new_auto[n] = (gt.cpu(), pt.cpu())
            del gt, pt
        secs, peak = run["s"], run["peak"]
        del outs, run
        torch.cuda.empty_cache()
        loss_err = abs(m["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_err = abs(m["grad_norm"] - norm64) / norm64
        bad = [n for n, e in leaf_err.items() if e > bound["leaves"][n]]
        bad += [n for n, e in leaf_vs_auto.items() if e > bound_fp32["leaves"][n]]
        # reported: the leaves past max(FP32_TOL, the floor of two fp32 paths)
        past_fixed = [n for n, e in leaf_err.items() if e > bound_fp32["leaves"][n]]
        rec = {"past_floor_of_two_paths": past_fixed,
               "loss": m["loss"], "grad_norm": m["grad_norm"], "loss_vs_fp64": loss_err,
               "norm_vs_fp64": norm_err, "leaf_vs_fp64": leaf_err,
               "leaf_vs_auto_2x8": leaf_vs_auto or None, "param_max_abs_diff": worst,
               "param_excess": excess, "s": secs, "peak_bytes": peak,
               "launches": launches, "stats": stats}
        line = (f"{label}, {TRAIN_BATCH} x {TRAIN_LEN}, one AdamW step through tf32: loss "
                f"{m['loss']:.7f} vs fp64 {loss_err:.2e} (tol {bound['loss']:.2e}; unsharded "
                f"fp32 {kern_vs['loss']:.2e}), grad_norm {m['grad_norm']:.6e} vs fp64 "
                f"{norm_err:.2e} (tol {bound['norm']:.2e}; unsharded {kern_vs['norm']:.2e}); "
                f"clipped gradient leaves vs fp64 up to {max(leaf_err.values()):.2e} "
                f"({max(leaf_err, key=leaf_err.get)}; tol max({FP32_TOL}, the plain chunked "
                f"fp32 step's); unsharded up to {kern_vs['leaf_max']:.2e})"
                + (f", vs the auto run up to {max(leaf_vs_auto.values()):.2e}"
                   if leaf_vs_auto else "")
                + f"; leaves past max({FP32_TOL}, the floor of two fp32 paths) (reported): "
                f"{past_fixed or 'none'}"
                + f"; params max |diff| {worst:.3e}, within rtol {SYNC_STEP_TOL['rtol']} atol "
                f"{SYNC_STEP_TOL['atol']} + lr*|du| (excess {excess:.3e}); step {secs:.2f}s, "
                f"peak {peak / 2**30:.2f} GiB; launches {launches}; CommStats a rank "
                f"{json.dumps(stats)} (closed forms)")
        log(line + f" [{smi}]")
        for n in names:
            log(f"[tp-train] {tag} leaf {n:24s} clipped gradient vs fp64 rel_l2 "
                f"{leaf_err[n]:.2e} (tol {bound['leaves'][n]:.2e}: max({FP32_TOL}, the plain "
                f"chunked fp32 step's {vs64['chunked']['leaves'][n]:.2e}); reported: the floor "
                f"of two fp32 paths {floor['leaves'][n]:.2e}, plain dense fp32 "
                f"{plain_vs['leaves'][n]:.2e}, the unsharded tf32 step "
                f"{vs64['kernel']['leaves'][n]:.2e}"
                + (f"; vs auto (2, 8) {leaf_vs_auto[n]:.2e} (tol "
                   f"{bound_fp32['leaves'][n]:.2e})" if leaf_vs_auto else ""))
        if bad or excess > 0 or loss_err > bound["loss"] or norm_err > bound["norm"] \
                or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{line}: over the bound ({bad})")
        if new_auto:
            auto, new_auto = new_auto, None
        out["runs"][tag] = rec
    del auto, g64, p1_64, params
    torch.cuda.empty_cache()
    out["gate_s"] = time.perf_counter() - t_phase

    # -- llama3.2-3b whole on TP_TRAIN_FULL, the init and tokens of phase_train
    t0 = time.perf_counter()
    params = get_model(full).init_params(full, torch.Generator("cuda").manual_seed(0),
                                         dtype=torch.float32)
    mesh, _, blocks = _tp_shard(full, params, TP_TRAIN_FULL)
    del params  # the ranks' blocks alone stay on the card
    run = _tp_train_step(full, ocfg, mesh, blocks, batch, "auto")
    launches = _expect_launches("[tp-train] full depth", tf32=mesh.size * 2 * full.n_layers)
    want = _tp_train_closed_forms(full, TP_TRAIN_FULL, TRAIN_BATCH, TRAIN_LEN, "auto")
    stats = _tp_step_stats_check("tp-train full", mesh, want)
    m = run["metrics"]
    loss_err = abs(m["loss"] - train_loss["kernel"]) / abs(train_loss["kernel"])
    rec = {"loss": m["loss"], "phase_train_loss": train_loss["kernel"], "loss_rel": loss_err,
           "grad_norm": m["grad_norm"], "s": run["s"], "peak_bytes": run["peak"],
           "launches": launches, "stats": stats, "rank_param_bytes": want["rank_param_bytes"]}
    line = (f"[tp-train] {full.name} whole ({full.n_layers} layers), fp32, on (data, model) = "
            f"{TP_TRAIN_FULL}, batch {TRAIN_BATCH} x {TRAIN_LEN}, one AdamW step: {run['s']:.2f}s "
            f"(16 rank threads on one card: no speed claim), peak {run['peak'] / 2**30:.2f} GiB "
            f"({run['peak'] / 1e9:.2f} GB, max_memory_allocated); loss {m['loss']:.7f} against "
            f"phase_train's {train_loss['kernel']:.7f} (unsharded, tf32, the same init and "
            f"tokens): rel {loss_err:.2e} (tol {LOSS_RTOL}); grad_norm {m['grad_norm']:.6e}; "
            f"launches {launches}; CommStats a rank {json.dumps(stats)} (closed forms)")
    log(line + f" [{smi}]")
    del run
    torch.cuda.empty_cache()
    if loss_err > LOSS_RTOL or not math.isfinite(m["grad_norm"]):
        raise AssertionError(f"{line}: over the bound")
    out["runs"]["full_2x8"] = rec
    out["s"] = time.perf_counter() - t_phase
    log(f"[tp-train] phase {out['s']:.1f}s (the gate {out['gate_s']:.1f}s, full depth "
        f"{time.perf_counter() - t0:.1f}s)")
    return out


# ---------------------------------------------------------------------------
# the thirteenth slice: the sharded layout for the MoE, VLM and audio families
# ---------------------------------------------------------------------------

# moonshot's fp32 training gate depth: 4.96 GB of fp32 weights.  At 2 layers
# (7.25 GB) the ring run's blocks, whole over data, with their gradients,
# moments, the ring's flat buffers and 16 ranks' MoE temporaries ran out of the
# card's 79 GiB.  Its prefill gate runs deeper, so that layers past the first
# (the stacks' indexing, a layer's FSDP gathers, the experts' F-column blocks)
# are held to fp64 on the card: 11.8 GB of fp32 weights, 23.6 GB in fp64
FAM_MOE_LAYERS = 1
FAM_MOE_PREFILL_LAYERS = 4
FAM_MOE_PREFILL_SHAPES = ((1, 16), (2, 8))
FAM_VLM_BF16_LAYERS = 14  # its reported-only bf16 TP prefills: half of 28 (as moonshot's)
FAM_VLM_LAYERS = 4  # qwen2-vl-7b's: 8.1 GB (8 layers would hold 82 GB of fp64
#                     references on the 96 GiB host)
# (sync, (data, model)) of moonshot's fp32 gate: TP alone, with FSDP, and the ring
FAM_MOE_RUNS = (("auto", (1, 16)), ("auto", (2, 8)), ("ring", (2, 8)))
FAM_SHAPE = (1, 16)  # the bf16 serving mesh, and qwen2-vl-7b's fp32 gate's
FAM_AUDIO_SHAPE = (2, 8)
# moonshot's bf16 TP decode: teacher-forced, then greedy (2, 3 once: 7.35 s
# a step of 48 layers on 16 rank threads, measured on one H100)
FAM_PROMPT, FAM_DECODE = 1, 2
FAM_GATHER_BATCH = 2  # qwen2-vl-7b's gather-route prefill: 2 rows x 4 kv heads over 16
# whisper-tiny under both tp=False layouts: 16 rows (one a rank under layout="fsdp")
# of 512 tokens; at 2048 its fp64 reference's logits alone would be 13.6 GB
FAM_AUDIO_BATCH, FAM_AUDIO_LEN = 16, 512
FAM_PREFILL = (PREFILL_BATCH, PREFILL_LEN)
FAM_TRAIN = (TRAIN_BATCH, TRAIN_LEN)
# the dry-run's prediction of one rank's sharded MoE train step: moonshot at 1
# layer, B 1 x 256, on (1, 4) with rank 0 on the card and ranks 1-3 on the host
FAM_DRYRUN_SHAPE, FAM_DRYRUN_LAYERS, FAM_DRYRUN_LEN = (1, 4), 1, 256


def _fam_policy(cfg, layout: str):
    """``sh.Policy()`` (TP over model, FSDP over data) or ``default_policy``'s
    ``layout`` ("2d", "fsdp")."""
    from repro_torch.parallel import sharding as sh

    return sh.Policy() if layout == "tp" else sh.default_policy(cfg, layout=layout)


def _fam_closed_forms(cfg, policy, shape, batch: int, seq: int, kind: str, sync: str = "auto",
                      dtype=torch.float32, ce_chunk: int = 0) -> dict:
    """What one rank of a sharded prefill step, decode step (``kind`` "decode",
    ``seq`` 1), or train step (``make_tp_value_and_grad`` then AdamW), calls and
    moves, from the shapes and the specs: calls and input bytes by collective.  A
    train step runs each layer, the embed and the encoder's input twice (no-grad,
    then recomputed under the tape), the unembed once, and each cut's transpose
    once.  The hybrid's attention layers are one a block; its recurrent layers
    gather their conv output over ``model``.  The MoE by ``moe_mode`` (under a
    ``tp=True`` policy): "tp" and "gshard" sum y over ``model`` as a row sum, and
    pvary the buffer (gshard: the tokens) and the gates in training; "ep" moves
    its (E, C, D) slabs in two all-to-alls a pass (C: min(the rank's tokens, the
    whole batch's capacity)) and gathers its counts over the data axes a pass
    (the batch's one group), their transposes in training, and in decode takes
    gshard's rule."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import abstract_params
    from repro_torch.core.comm import TraceMesh
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh

    from repro_torch.parallel import tensor_parallel as tp_lib

    train = kind == "train"
    ep = cfg.family == "moe" and cfg.moe_mode == "ep" and kind != "decode"
    if train and sync != "auto":  # the data axes manual: blocks whole over them
        policy = dataclasses.replace(policy, fsdp=False)
    mesh = TraceMesh(shape, TP_AXES)
    dp, n = mesh.shape["data"], mesh.shape["model"] if policy.tp else 1
    nd = mesh.axis_size(policy.data_axes)
    elt = torch.tensor([], dtype=dtype).element_size()
    rows = batch // nd
    tok, n_l, hd = rows * seq, cfg.n_layers, cfg.kq_head_dim
    act = tok * cfg.d_model
    passes = 2 if train else 1
    # the layers with attention (the hybrid's: one a block) and the recurrent ones
    n_att = n_l // max(1, cfg.attention_period) if cfg.family == "hybrid" else n_l
    n_rec = n_l - n_att if cfg.family == "hybrid" else 0
    stacks = tp_lib.stacks(cfg)
    out = {k: {"calls": 0, "bytes": 0}
           for k in ("psum", "all_gather", "all_to_all", "reduce_scatter")}

    def add(k, calls, nbytes):
        out[k]["calls"] += calls
        out[k]["bytes"] += nbytes

    params = abstract_params(cfg)
    specs = sh.sanitize_specs(params, sh.param_specs(cfg, params, policy), mesh)
    groups, split, blocks = set(), {}, 0
    for (name, x), spec in zip(_named_leaves(params), tree_lib.leaves(specs)):
        block = math.prod(s.stop - s.start for s in sh.NamedSharding(mesh, spec).block(0, x.shape))
        blocks += block
        dims = [set(e if isinstance(e, tuple) else (e,)) if e else set() for e in spec]
        axes = {a for d in dims for a in d if mesh.shape[a] > 1}
        split[name] = [("model" in d) for d in dims]
        groups.add(frozenset(axes))
        # a decode step runs no encoder (the audio family's cross-attention cache)
        if "data" in axes and not (kind == "decode" and name.startswith("encoder.")):
            per = x.shape[0] if tp_lib._stacked(name, stacks) else 1
            times = 1 if name == "unembed" else passes
            lelt = 4 if x.dtype == torch.float32 else elt  # the MoE router: fp32 in any model
            add("all_gather", times * per, times * block * lelt)
            if train:  # the transposes: each layer's gradient, reduce-scattered
                add("reduce_scatter", per, dp * block * lelt)
        if train and sync == "auto" and any(
                mesh.shape[a] > 1 and a not in axes for a in policy.data_axes):
            add("psum", 1, block * elt)  # sum_over_data
    if policy.tp and cfg.family in ("ssm", "audio"):
        _fam17_closed_forms(add, cfg, split, n, rows, seq, kind, elt)
    elif policy.tp:
        h, kv = cfg.n_heads, cfg.n_kv_heads
        if split["embed"][0]:  # the vocab-parallel lookup's psum
            add("psum", passes, passes * act * elt)
        # the row sums (attention's, the MLP's or the experts' but EP's): a
        # reduce-scatter of the fp32 partial in n pieces, an all-gather of the sums
        piece = -(-act // n)
        sums = (1 if ep else 2) * n_l * passes
        add("reduce_scatter", sums, sums * piece * n * 4)
        add("all_gather", sums, sums * piece * elt)
        qkv, o = tok * (h + 2 * kv) * hd // n, tok * h * hd // n
        if sh.head_split(rows, kv, n) is None:  # the gather route
            add("all_gather", n_att * passes, n_att * passes * qkv * elt)
            if train:
                add("reduce_scatter", n_att, n_att * n * qkv * elt)
        else:  # q, k, v in, o back; in training recomputed, and their transposes
            k = 3 if train else 1
            add("all_to_all", 2 * n_att * k, n_att * k * (qkv + o) * elt)
        # a recurrent layer's conv output, all-gathered over model for w_a and w_i
        # (in training recomputed, and the reduce-scatter of its transpose)
        conv = tok * cfg.d_model // n
        add("all_gather", n_rec * passes, n_rec * passes * conv * elt)
        if train:
            add("reduce_scatter", n_rec, n_rec * n * conv * elt)
        if not train and (split["unembed"][1] if "unembed" in split else split["embed"][0]):
            add("all_gather", 1, rows * cfg.vocab // n * elt)  # the last logits' columns
        if train:
            # the loss: the row max (fp32), its exp-sums and the label's logit, the
            # hidden states' pvary; each layer's pvarys: attention's input, and the
            # MLP's input or the MoE's capacity buffer and gates
            # with ce_chunk: each chunk's max and two psums, in the forward and again
            # in its recompute (the psums' transposes pass the gradient)
            nc = -(-seq // ce_chunk) if ce_chunk else 0
            add("all_gather", 2 * nc or 1, (2 if nc else 1) * tok * 4)
            add("psum", 4 * nc + 1 if nc else 3, (4 if nc else 2) * tok * 4 + act * elt)
            add("psum", n_l, n_l * act * elt)
            # the recurrent layers' lambda_p (fp32), whole, read at the rank's channels
            add("psum", n_rec, n_rec * cfg.d_model * 4)
            if cfg.family == "moe" and cfg.moe_mode == "tp":
                group = min(moe.GROUP_TOKENS, seq)
                g = rows * -(-seq // group)
                cap = moe.capacity(group, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
                add("psum", 2 * n_l, n_l * (g * cfg.n_experts * cap * cfg.d_model * elt
                                            + tok * cfg.top_k * 4))
            elif cfg.family == "moe":  # the tokens and the gates
                add("psum", 2 * n_l, n_l * (act * elt + tok * cfg.top_k * 4))
            else:
                add("psum", n_l, n_l * act * elt)
    if ep:  # the slabs there and back; in training recomputed, and their transposes
        # the whole batch one group: the ranks along the data axes (none under a
        # sync mode, whose data axes are manual) gather their counts and router
        # sums (3E fp32) a pass, and in training reduce-scatter their gradient
        ng = nd if not train or sync == "auto" else 1
        cap = moe.capacity(tok * ng, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        slab = min(tok, cap) if ng > 1 else cap
        k = 3 if train else 1
        add("all_to_all", 2 * n_l * k, 2 * n_l * k * cfg.n_experts * slab * cfg.d_model * elt)
        if ng > 1:
            add("all_gather", n_l * passes, n_l * passes * 3 * cfg.n_experts * 4)
            if train:
                add("reduce_scatter", n_l, n_l * ng * 3 * cfg.n_experts * 4)
    if train:
        if sync == "auto" and nd > 1:  # the loss's (and the MoE aux's) mean over data
            add("psum", 1 + (cfg.family == "moe"), 4 + 4 * (cfg.family == "moe"))
        if sync != "auto":  # the loss and aux over data, after the ring
            add("psum", 2, 8)
        norm = sum(1 for a in groups if a)  # the gradient norm: a psum a split group
        add("psum", norm, 4 * norm)
    # the ring's ppermutes over data: the rank's whole fp32 gradient, in dp chunks
    ring = 2 * (dp - 1) * -(-blocks // dp) * 4 if train and sync != "auto" else 0
    return {**out, "ppermute_bytes": ring}


def _fam17_closed_forms(add, cfg, split, n: int, rows: int, seq: int, kind: str, elt: int):
    """``_fam_closed_forms``' part over ``model`` for the SSM and audio families under
    a ``tp=True`` policy (``add(collective, calls, bytes)``; ``split``: each leaf's
    dimensions split over ``model``).  Both: the vocab-parallel lookup's psum and
    the last logits' all-gather where the vocab is split, each row sum a
    reduce-scatter of the fp32 partial and an all-gather of the sums; in training
    each layer's pvarys' psums (the transposes) and the loss's collectives.

    * mamba2, a layer a pass: ``w_in`` read whole (all-gathered over ``model``
      where split, else a pvary), the conv output all-gathered where ``conv_w`` is
      split (else ``conv_w`` a pvary), ``w_out`` read whole the same way, one row
      sum; the normed input, ``A_log``, ``D`` and ``dt_bias`` (fp32) pvarys;
    * whisper, a decoder and (not in decode) an encoder layer a pass: the
      self-attention's route (pair: q, k, v in one all-to-all and o back; gather:
      q, k, v all-gathered) and two row sums; pvarys of the attention's and the
      MLP's inputs and of ``b_up``; in decode the cross-attention on the rank's
      block of its cache: a row sum where it holds kv heads, the fp32 scores psum'd
      and a row sum where it holds head_dim columns."""
    from repro_torch.models import mamba2
    from repro_torch.parallel import sharding as sh

    train = kind == "train"
    passes = 2 if train else 1
    tok, d, n_l = rows * seq, cfg.d_model, cfg.n_layers
    act = tok * d

    def row_sums(count, a):
        piece = -(-a // n)
        add("reduce_scatter", count, count * piece * n * 4)
        add("all_gather", count, count * piece * elt)

    def read(count, name, block):  # a leaf read whole: all-gathered, or a pvary
        if any(split[name]):
            add("all_gather", count * passes, count * passes * block * elt)
            if train:
                add("reduce_scatter", count, count * n * block * elt)
        elif train:
            add("psum", count, count * block * elt)

    vocab_split = split["unembed"][1] if "unembed" in split else split["embed"][0]
    if split["embed"][0]:
        add("psum", passes, passes * act * elt)
    if cfg.family == "ssm":
        di, h, _, ns = mamba2.dims(cfg)
        cols, conv = 2 * di + 2 * ns + h, di + 2 * ns
        read(n_l, "layers.w_in", d * cols // (n if split["layers.w_in"][2] else 1))
        read(n_l, "layers.w_out", di * d // (n if split["layers.w_out"][1] else 1))
        if split["layers.conv_w"][2]:
            add("all_gather", n_l * passes, n_l * passes * tok * conv // n * elt)
            if train:
                add("reduce_scatter", n_l, n_l * tok * conv * elt)
        elif train:
            add("psum", n_l, n_l * cfg.conv_width * conv * elt)
        row_sums(n_l * passes, act)
        if train:
            add("psum", n_l, n_l * act * elt)  # the normed input
            add("psum", 3 * n_l, 3 * n_l * h * 4)  # A_log, D, dt_bias
    else:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.kq_head_dim
        stacks = [(n_l, tok)] + ([(cfg.enc_layers, rows * cfg.enc_seq)] if kind != "decode"
                                 else [])
        for layers, t in stacks:
            row_sums(2 * layers * passes, t * d)
            qkv, o = t * (h + 2 * kv) * hd // n, t * h * hd // n
            if sh.head_split(rows, kv, n) is None:
                add("all_gather", layers * passes, layers * passes * qkv * elt)
                if train:
                    add("reduce_scatter", layers, layers * n * qkv * elt)
            else:
                k = 3 if train else 1
                add("all_to_all", 2 * layers * k, layers * k * (qkv + o) * elt)
            if train:  # the attention's and the MLP's inputs, b_up
                add("psum", 2 * layers, 2 * layers * t * d * elt)
                add("psum", layers, layers * cfg.d_ff * elt)
        if kind == "decode" and kv % n == 0:
            row_sums(n_l, act)
        elif kind == "decode" and hd % n == 0:
            add("psum", n_l, n_l * rows * h * cfg.enc_seq * 4)
            row_sums(n_l, act)
    if not train and vocab_split:
        add("all_gather", 1, rows * cfg.vocab // n * elt)  # the last logits' columns
    if train and vocab_split:  # the row max, the exp-sums and the label's logit, the
        add("all_gather", 1, tok * 4)  # hidden states' pvary
        add("psum", 3, 2 * tok * 4 + act * elt)


def _fam_train_gate(cfg, params, batch, runs, tag: str, smi) -> dict:
    """``phase_tp_train``'s gate for ``runs`` ((sync, shape, layout) each, and a
    dict of ``ce_chunk`` and ``moe_mode`` where a run takes them: a MoE mode of
    the same function on this batch as ``cfg``'s, whose fp64 run they share) of
    ``cfg``:
    one AdamW step from the init state on 16 rank threads, through the cut route
    (no collective under autograd) and the tf32 kernel, against the unsharded model
    in fp64 (plain attention): the loss, ``grad_norm`` and every leaf's clipped
    gradient within max(FP32_TOL, floor), the floor being the plain chunked fp32
    step's distance from fp64 (``_reference_runs``; for the SSM and hybrid
    families, which reach no kernel, twice the unsharded fp32 step's,
    ``_gate_bound``, its weights on the host while the fp64 run holds the card),
    and the updated parameters
    within SYNC_STEP_TOL plus lr·|u(g) - u(g64)|.  The MoE's runs replay the fp64
    run's routing (``_routing_log``): free, a (token, choice) pair near a top-k
    tie moves one token's output by O(1) between paths.  Launches and
    ``CommStats`` against their closed forms."""
    from repro_torch import tree as tree_lib
    from repro_torch.train import optimizer as opt

    ocfg = opt.AdamWConfig(**TP_TRAIN_OCFG, schedule=cfg.schedule)
    lr = float(opt.schedule_lr(ocfg, torch.tensor(1)))
    names = [n for n, _ in _named_leaves(params)]
    b, s = batch["tokens"].shape

    def first_update(g):  # u(g) of AdamW's first step
        return g / (g.abs() + ocfg.eps)

    moe_log = [] if cfg.family == "moe" else None
    recurrent = cfg.family in RECURRENT
    if recurrent:  # the fp64 run's weights, gradients and logits fill the card alone
        _to_host(params)
    p64 = tree_lib.tree_map(lambda t: t.to(TP_DEVICE, torch.float64), params)
    with (_routing_log() if moe_log is not None else contextlib.nullcontext()) as log_:
        ref = _loss_and_grads(cfg, p64, {k: (v.double() if v.is_floating_point() else v)
                                         for k, v in batch.items()}, use_kernel=False)
    del p64
    if moe_log is not None:
        moe_log.extend(log_)
    around = (lambda _name: _replayed_routing(moe_log)) if moe_log is not None else None
    g64 = dict(_named_leaves(ref.pop("grads")))
    norm64 = math.sqrt(sum(float((g ** 2).sum()) for g in g64.values()))
    scale64 = min(1.0, ocfg.clip_norm / norm64)
    for n in names:
        g64[n] = (g64[n] * scale64).cpu()
    torch.cuda.empty_cache()
    if recurrent:  # no kernel and no attention chunking to vary: the plain step's floor
        p32 = tree_lib.tree_map(lambda t: t.to(TP_DEVICE), params)
        plain = _loss_and_grads(cfg, p32, batch, use_kernel=False)
        del p32
        plain["norm"] = float(opt.global_norm(plain["grads"]))
        host = {"chunked": {n: g.cpu() for n, g in _named_leaves(plain.pop("grads"))}}
        refs = {"chunked": plain, "kernel": plain}
        torch.cuda.empty_cache()
    else:
        refs, host = _reference_runs(cfg, params, batch, around)
        host.pop("kernel"), host.pop("fp64")
        refs["plain"].pop("grads")
    _to_host(params)  # the blocks are cut from the host copy: the card holds the ranks' alone
    chunked = refs["chunked"]
    scale = min(1.0, ocfg.clip_norm / chunked["norm"])
    floor = {"loss": abs(chunked["loss"] - ref["loss"]) / abs(ref["loss"]),
             "norm": abs(chunked["norm"] - norm64) / norm64,
             "leaves": {n: rel_l2(g.to(TP_DEVICE).double() * scale, g64[n].to(TP_DEVICE))
                        for n, g in host.pop("chunked").items()}}
    bound = {k: _gate_bound(cfg, floor[k]) for k in ("loss", "norm")}
    bound["leaves"] = {n: _gate_bound(cfg, f) for n, f in floor["leaves"].items()}
    unsharded = "unsharded_plain" if recurrent else "unsharded_tf32"
    out = {"fp64": {"loss": ref["loss"], "grad_norm": norm64}, "floor": floor,
           unsharded: {k: refs["kernel"][k] for k in ("loss", "norm", "s", "peak_gib")},
           "runs": {}}
    log(f"[{tag}] {cfg.name} at {cfg.n_layers} layers, fp32, batch {b} x {s}, remat: fp64 "
        f"loss {ref['loss']:.7f}, grad norm {norm64:.6e}; the "
        f"{'unsharded plain' if recurrent else 'plain chunked'} fp32 step (the "
        f"floor) loss {floor['loss']:.2e}, norm {floor['norm']:.2e}, leaves up to "
        f"{max(floor['leaves'].values()):.2e} from it"
        + (" (every run replays the fp64 run's routing)" if moe_log is not None else "")
        + f" [{smi}]")
    chunked_runs = any(len(r) > 3 and "ce_chunk" in r[3] for r in runs)
    kept = {}  # with a ce_chunk run: every run's clipped gradient, on the host
    for sync, shape, layout, *opt in runs:
        opt = opt[0] if opt else {}
        ce_chunk, mode = opt.get("ce_chunk", 0), opt.get("moe_mode")
        run_cfg = dataclasses.replace(cfg, moe_mode=mode) if mode else cfg
        policy = _fam_policy(cfg, layout)
        label = (f"[{tag}] {cfg.name} {layout} {sync} on (data, model) = {shape}"
                 + (f", moe_mode {mode!r}" if mode else "")
                 + (f", ce_chunk {ce_chunk}" if ce_chunk else ""))
        grad_policy = policy if sync == "auto" else dataclasses.replace(policy, fsdp=False)
        mesh, specs, blocks = _tp_shard(run_cfg, params, shape, grad_policy)
        run = _tp_train_step(run_cfg, ocfg, mesh, blocks, batch, sync, policy, moe_log, ce_chunk)
        outs, m = run["outs"], run["metrics"]
        launches = _expect_launches(label, tf32=0 if recurrent else mesh.size * 2 * cfg.n_layers)
        stats = _tp_step_stats_check(label, mesh, _fam_closed_forms(
            run_cfg, policy, shape, b, s, "train", sync, ce_chunk=ce_chunk))
        key = (f"{layout}_{sync}_{shape[0]}x{shape[1]}" + (f"_{mode}" if mode else "")
               + (f"_ce{ce_chunk}" if ce_chunk else ""))
        kept[key] = {}
        spec_of = dict(zip(names, tree_lib.leaves(specs)))
        leaf_err, excess = {}, -1.0
        for i, (n, p0) in enumerate(_named_leaves(params)):
            gt = _tp_whole(mesh, spec_of[n], p0.shape, [tree_lib.leaves(o[1])[i] for o in outs])
            pt = _tp_whole(mesh, spec_of[n], p0.shape, [tree_lib.leaves(o[0])[i] for o in outs])
            gt /= 1 - ocfg.b1  # the clipped gradient the step applied
            if chunked_runs:
                kept[key][n] = gt.cpu()
            sq = sq_ref = 0.0
            for sl in _row_chunks(p0.shape):
                g, p = gt[sl].double(), pt[sl].double()
                g_ref, p_0 = g64[n][sl].to(TP_DEVICE), p0[sl].to(TP_DEVICE).double()
                p_ref = p_0 - lr * (first_update(g_ref) + ocfg.weight_decay * p_0)
                sq += float(((g - g_ref) ** 2).sum())
                sq_ref += float((g_ref ** 2).sum())
                d = (p - p_ref).abs() - SYNC_STEP_TOL["rtol"] * p_ref.abs() - SYNC_STEP_TOL[
                    "atol"] - lr * (first_update(g) - first_update(g_ref)).abs()
                excess = max(excess, float(d.max()))
                del g, p, g_ref, p_0, p_ref, d
            leaf_err[n] = math.sqrt(sq / sq_ref) if sq_ref else math.sqrt(sq)
            del gt, pt
        del outs, run["outs"]
        torch.cuda.empty_cache()
        loss_err = abs(m["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_err = abs(m["grad_norm"] - norm64) / norm64
        bad = [n for n, e in leaf_err.items() if e > bound["leaves"][n]]
        worst = max(leaf_err, key=leaf_err.get)
        line = (f"{label}, {b} x {s}, one AdamW step "
                f"{'(no kernel)' if recurrent else 'through tf32'}: loss {m['loss']:.7f} vs "
                f"fp64 {loss_err:.2e} (tol {bound['loss']:.2e}), grad_norm "
                f"{m['grad_norm']:.6e} vs fp64 {norm_err:.2e} (tol {bound['norm']:.2e}); "
                f"clipped gradient leaves vs fp64 up to {leaf_err[worst]:.2e} ({worst}; tol "
                f"max({FP32_TOL}, "
                f"{f'{REC_FLOOR_FACTOR} x the unsharded' if recurrent else 'the plain chunked'} "
                f"step's "
                f"{floor['leaves'][worst]:.2e})); "
                f"params within rtol {SYNC_STEP_TOL['rtol']} atol {SYNC_STEP_TOL['atol']} + "
                f"lr*|du| (excess {excess:.3e}); aux {m['aux']:.6f}; step {run['s']:.2f}s, "
                f"peak {run['peak'] / 2**30:.2f} GiB (to the gradient "
                f"{run['grad_peak'] / 2**30:.2f}); launches {launches}; CommStats a rank "
                f"{json.dumps(stats)} (closed forms)")
        log(line + f" [{smi}]")
        for n in names:
            log(f"[{tag}] {key} leaf {n:28s} clipped gradient "
                f"vs fp64 rel_l2 {leaf_err[n]:.2e} (tol {bound['leaves'][n]:.2e})")
        if bad or excess > 0 or loss_err > bound["loss"] or norm_err > bound["norm"] \
                or not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{line}: over the bound ({bad})")
        out["runs"][key] = {
            "loss": m["loss"], "aux": m["aux"], "grad_norm": m["grad_norm"],
            "loss_vs_fp64": loss_err, "norm_vs_fp64": norm_err, "leaf_vs_fp64": leaf_err,
            "param_excess": excess, "s": run["s"], "peak_bytes": run["peak"],
            "grad_peak_bytes": run["grad_peak"], "loss_peak_bytes": run["loss_peak"],
            "launches": launches, "stats": stats}
    for key in [k for k in kept if "_ce" in k]:  # the chunked loss against the unchunked
        base = key[:key.index("_ce")]
        got, ref_run = out["runs"][key], out["runs"][base]
        loss_d = abs(got["loss"] - ref_run["loss"]) / abs(ref_run["loss"])
        leaf_d = {n: rel_l2(kept[key][n].to(TP_DEVICE), kept[base][n].to(TP_DEVICE))
                  for n in names}
        worst = max(leaf_d, key=leaf_d.get)
        bad = [n for n, e in leaf_d.items() if e > bound["leaves"][n]]
        line = (f"[{tag}] {cfg.name} {key} against {base}: loss {loss_d:.2e} (tol "
                f"{bound['loss']:.2e}), clipped gradient leaves up to {leaf_d[worst]:.2e} "
                f"({worst}; tol {bound['leaves'][worst]:.2e}); the 16 ranks' loss, forward "
                f"and backward, peaked {got['loss_peak_bytes'] / 2**30:.3f} GiB above what "
                f"was live as it began, against {ref_run['loss_peak_bytes'] / 2**30:.3f} "
                f"(the step's peak to its gradient {got['grad_peak_bytes'] / 2**30:.2f} and "
                f"{ref_run['grad_peak_bytes'] / 2**30:.2f} GiB, the whole step's "
                f"{got['peak_bytes'] / 2**30:.2f} and {ref_run['peak_bytes'] / 2**30:.2f}: "
                "set by the layers' backward, not the loss)")
        log(line + f" [{smi}]")
        got.update({"loss_vs_unchunked": loss_d, "leaf_vs_unchunked": leaf_d})
        if bad or loss_d > bound["loss"] or not (
                got["loss_peak_bytes"] < ref_run["loss_peak_bytes"]):
            raise AssertionError(f"{line}: over the bound, or no lower peak ({bad})")
    return out


def _to_host(tree) -> None:
    """Every leaf of the nested dict ``tree`` replaced by its copy on the host."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_host(v)
        else:
            tree[k] = v.cpu()


def _to_device(tree) -> None:
    """Every leaf of the nested dict ``tree`` replaced by its copy on TP_DEVICE."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_device(v)
        else:
            tree[k] = v.to(TP_DEVICE)


def _fam_fp64_prefill(cfg, params, batch, moe_log=None) -> torch.Tensor:
    """The unsharded prefill's last logits in fp64 (plain attention), on ``params``
    cast to fp64; the MoE's routing logged into ``moe_log`` (a list)."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import get_model, layers
    from repro_torch.train.steps import model_extras

    T = get_model(cfg)
    p64 = tree_lib.tree_map(lambda t: t.to(TP_DEVICE, torch.float64), params)
    extras = {k: (v.double() if v.is_floating_point() else v)
              for k, v in model_extras(batch).items()}
    with torch.no_grad(), (_routing_log() if moe_log is not None
                           else contextlib.nullcontext()) as log_:
        hidden = T.forward(cfg, p64, batch["tokens"], return_hidden=True, **extras)[0]
        last = (hidden[:, -1:] @ layers.unembed(p64)).float()
    if moe_log is not None:
        moe_log.extend(log_)
    del p64, hidden
    return last


def _fam_prefill_gate(cfg, params, batch, shape, layout, tag: str, smi) -> dict:
    """The sharded fp32 prefill through tf32 on ``shape`` against the fp64 run of the
    same weights and batch, within max(FP32_TOL, floor), the floor the plain chunked
    fp32 prefill's own distance from it (the SSM and hybrid families, which reach
    no kernel: twice the unsharded fp32 prefill's own, ``_gate_bound``); launches
    and ``CommStats``
    against their closed forms.  The MoE's runs replay the fp64 run's routing."""
    policy = _fam_policy(cfg, layout)
    recurrent = cfg.family in RECURRENT
    moe_log = [] if cfg.family == "moe" else None
    ex = _fam_fp64_prefill(cfg, params, batch, moe_log)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    def replay():
        return _replayed_routing(moe_log) if moe_log is not None else contextlib.nullcontext()

    with replay():
        chunked, _ = _prefill(dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK), params,
                              batch["tokens"], False, extras=extras)
        chunked = chunked.clone()
    with replay():
        kernel, _ = _prefill(cfg, params, batch["tokens"], True, extras=extras)
        kernel = kernel.clone()
    floor = rel_l2(kernel if recurrent else chunked, ex)
    bound = _gate_bound(cfg, floor)
    mesh, _, blocks = _tp_shard(cfg, params, shape, policy)
    mesh.stats.reset()
    _reset_counts()
    logits, secs, spread = _tp_prefill(cfg, mesh, blocks, batch, policy=policy, replay=moe_log)
    b, s = batch["tokens"].shape
    launches = _expect_launches(f"[{tag}] fp32 prefill",
                                tf32=0 if recurrent else mesh.size * cfg.n_layers)
    stats = _tp_step_stats_check(f"{tag} fp32 prefill {shape}", mesh, _fam_closed_forms(
        cfg, policy, shape, b, s, "prefill"))
    err = rel_l2(logits, ex)
    route = _route_of(cfg, policy, shape, b)
    rec = {"vs_fp64": err, "floor": floor, "bound": bound, "unsharded_vs_fp64": rel_l2(kernel, ex),
           "s": secs, "launches": launches, "stats": stats, "rank_spread": spread,
           "route": route}
    line = (f"[{tag}] {cfg.name} at {cfg.n_layers} layers, {layout} on (data, model) = {shape}, "
            f"fp32 prefill {b} x {s} {'(no kernel)' if recurrent else 'through tf32'} ({route}): "
            f"last logits vs the fp64 run rel_l2 {err:.3e} (tol max({FP32_TOL}, "
            f"{f'{REC_FLOOR_FACTOR} x the unsharded' if recurrent else 'the plain chunked'} "
            f"prefill's {floor:.3e})); the "
            f"unsharded {'plain' if recurrent else 'tf32'} prefill's "
            f"{rec['unsharded_vs_fp64']:.3e}; ranks sharing rows within "
            f"{spread:.3e}; {secs:.3f}s; launches {launches}; CommStats a rank "
            f"{json.dumps(stats)} (closed forms)"
            + (" (the fp64 run's routing replayed)" if moe_log is not None else ""))
    log(line + f" [{smi}]")
    if not (err <= bound and torch.isfinite(logits).all()):
        raise AssertionError(f"{line}: over the bound")
    del blocks, mesh
    return rec


def _route_of(cfg, policy, shape, batch: int) -> str:
    """How a rank's attention takes its heads: "pair (rows x kv heads)", "gather",
    or "whole" (nothing split over model); the SSM's rank takes P / n channels of
    every head."""
    from repro_torch.parallel import sharding as sh

    if not policy.tp:
        return "whole"
    if cfg.family == "ssm":
        return f"P / {shape[1]} channels of every head"
    hs = sh.head_split(batch // shape[0], cfg.n_kv_heads, shape[1])
    return "gather" if hs is None else f"pair ({hs.rows} row x {hs.kv_heads} kv heads)"


def _fam_bf16_serve(cfg, params, batches, tag: str, smi, decode: bool, calls: int = 3,
                    shape=FAM_SHAPE, around=contextlib.nullcontext) -> dict:
    """bf16 on ``shape``: the unsharded prefill of each batch of ``batches`` (name ->
    batch), each in the context ``around()`` (EP's one group, ``_ep_whole``), then
    the weights cut into the ranks' blocks (the whole tree freed a leaf at a time)
    and the TP prefill of each through sm90 (the SSM and hybrid families: no
    kernel), one warm-up and ``calls - 1`` timed calls (one call: that one), the
    last logits against the unsharded ones (reported), launches and ``CommStats``
    against the closed forms; with ``decode`` the TP decode loop (FAM_PROMPT
    teacher-forced, FAM_DECODE greedy) after it."""
    policy = _fam_policy(cfg, "tp")
    ref = {}
    for name, batch in batches.items():  # the unsharded prefill, and two bf16 paths' floor
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        with around():
            logits, t = _prefill(cfg, params, batch["tokens"], True, extras=extras)
            logits = logits.clone()
            chunked, _ = _prefill(dataclasses.replace(cfg, attn_chunk=FLOOR_CHUNK), params,
                                  batch["tokens"], False, extras=extras)
        ref[name] = (logits, t, rel_l2(chunked.float(), logits.float()))
        del chunked
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh, _, blocks = _tp_shard(cfg, params, shape, policy, free=True)
    shard_s = time.perf_counter() - t0
    out = {"shard_s": shard_s}
    for name, batch in batches.items():
        b, s = batch["tokens"].shape
        secs = []
        for i in range(calls):
            mesh.stats.reset()
            _reset_counts()
            logits, t, spread = _tp_prefill(cfg, mesh, blocks, batch, policy=policy)
            launches = _expect_launches(
                f"[{tag}] bf16 TP prefill {name}",
                sm90=0 if cfg.family in RECURRENT else mesh.size * cfg.n_layers)
            if i == 0:
                stats = _tp_step_stats_check(f"{tag} bf16 {name}", mesh, _fam_closed_forms(
                    cfg, policy, shape, b, s, "prefill", dtype=torch.bfloat16))
            secs.append(t)
        if logits.shape != (b, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"[{tag}] bf16 TP logits {tuple(logits.shape)} not finite or "
                                 "misshapen")
        r, r_s, floor = ref[name]
        rec = {"s": statistics.median(secs[1:] or secs), "s_runs": secs, "unsharded_s": r_s,
               "rel_l2_vs_unsharded": rel_l2(logits.float(), r.float()), "bf16_floor": floor,
               "argmax_agree": float((logits.argmax(-1) == r.argmax(-1)).float().mean()),
               "launches": launches, "stats": stats, "rank_spread": spread,
               "route": _route_of(cfg, policy, shape, b)}
        mode = f" (moe_mode {cfg.moe_mode!r})" if cfg.family == "moe" else ""
        log(f"[{tag}] {cfg.name}{mode} bf16 at {cfg.n_layers} "
            f"layers, {name}: TP prefill {b} x {s} on (data, model) = {shape}, "
            f"{rec['route']}: {rec['s']:.3f}s "
            f"{f'median of {calls - 1} after a warm-up' if calls > 1 else 'one call'} "
            f"({', '.join(f'{t:.3f}' for t in secs)}"
            f" s; unsharded {r_s:.3f}s; no speed claim: 16 ranks share one card); vs the "
            f"unsharded prefill rel_l2 {rec['rel_l2_vs_unsharded']:.3e}, argmax agreement "
            f"{rec['argmax_agree']:.2f}, beside two unsharded bf16 paths' distance (the plain "
            f"chunked prefill from the kernel's) {floor:.3e} (bf16, reported); launches "
            f"{launches}; CommStats a rank {json.dumps(stats)} (closed forms) [{smi}]")
        out[name] = rec
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if decode:
        prompts = next(iter(batches.values()))["tokens"][:, :FAM_PROMPT].contiguous()
        _reset_counts()
        dl, toks, dsec = _tp_decode(cfg, mesh, blocks, prompts, FAM_DECODE, policy)
        _expect_launches(f"[{tag}] bf16 TP decode")
        if not (torch.isfinite(dl).all() and ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"[{tag}] the bf16 TP decode gave bad logits or tokens")
        out["decode_ms"] = dsec * 1e3
        log(f"[{tag}] {cfg.name} bf16 TP decode on {shape}, batch {prompts.shape[0]}: "
            f"{FAM_PROMPT} teacher-forced and {FAM_DECODE} greedy steps, {dsec * 1e3:.1f} ms a "
            f"step (16 ranks' host work under one GIL), tokens {toks[0].tolist()} [{smi}]")
    del blocks, mesh
    return out


def _fam_fp32_model(arch: str, layers: int):
    """``arch`` cut to ``layers`` layers at full width in fp32, each stack scaled to
    the full depth's init (``_rescale_stacks``)."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    params, _ = _load_model(cfg, "tp-families", torch.float32)
    _rescale_stacks(params["layers"], layers, full.n_layers)
    return cfg, params


def _fam_batch(cfg, b, s, positions=None) -> dict:
    from repro_torch.data.pipeline import make_batch

    batch = {k: torch.from_numpy(v).to(TP_DEVICE) for k, v in make_batch(cfg, s, b).items()}
    if positions is not None:
        batch["positions"] = positions
    return batch


def _fam_free() -> None:
    gc.collect()  # a model's tensors in a reference cycle wait for the cyclic collector
    torch.cuda.empty_cache()


# The fifteenth slice: moonshot's experts split over model (moe_mode "ep" and
# "gshard") and the chunked loss under TP, in phase_tp_families.  Bytes reckoned
# before the first run, in GB: the fp32 gates run on the tp-mode gates' weights
# (4 layers: 11.8, fp64 23.6; 1 layer: 4.96).  EP's prefill on (1, 16) routes
# the 4 rows x 2048 as one group: C = 960, a rank's slabs (64, 960, 2048) fp32
# 0.50 GB, each of slabs, received slabs, expert outputs and returned slabs alive
# at the exchanges: ~2 GB a rank, 32 over 16 ranks, beside 11.8 of blocks; on
# (2, 8) half.  gshard's dispatch and combine tensors (4, 12288, 4, 240) fp32,
# 0.19 GB each a rank, 6 over 16.  Training at 1 layer, B 2 x 2048: EP's slabs
# 0.25 GB a rank ((1, 16), C 480) alive in the recompute with their gradients,
# ~16 over 16 ranks, beside ~40 for the tp mode.  bf16 whole on (2, 8):
# 56.1 of blocks, EP's slabs (64, 480, 2048) 0.13 GB and its other exchange
# buffers ~0.6 a rank (~10), a layer's gathered experts 0.14 a rank (2.2):
# ~70, under the 79 GiB card.  With the whole batch one group, a rank's slabs
# on (2, 8) take min(its tokens, the batch's capacity) rows, the (1, 16) run's
# (C 480 in training, 960 in prefill), twice a data row's capacity: EP's (2, 8)
# training step ran out of the card's memory until the experts' SwiGLU kept
# two of its four (..., C, F) intermediates for the backward
# (``moe._SiluMul``), which brought it to ~74 GiB; bf16 on (2, 8) ~72.
FAM_MOE_MODES = ("gshard", "ep")
# the training gate's runs under gshard, which share the tp mode's fp64 run (the
# same function at B 2 x 2048: gshard's groups are the rows, as moe_apply's); EP,
# whose one group is the whole batch on either mesh, takes a gate of its own
FAM_MOE_MODE_RUNS = (("auto", (1, 16), "tp", {"moe_mode": "gshard"}),
                     ("auto", (2, 8), "tp", {"moe_mode": "gshard"}))
FAM_MOE_EP_SHAPES = ((1, 16), (2, 8))
FAM_MOE_MODE_BF16_SHAPE = (2, 8)
# the depth of moonshot's bf16 TP runs (every moe_mode), at the 48-layer init's
# scale: a quarter of its layers keeps these reported-only runs (whole until the
# SSM and audio families' sharded gates needed their ~60 s of the script's 1200)
FAM_MOE_BF16_LAYERS = 12
FAM_MOE_PROMPT, FAM_MOE_GREEDY = 4, 3  # the fp32 decode gates: teacher-forced, greedy
# llama3.2-3b's chunked loss under TP at TP_TRAIN_LAYERS, on (1, 16): its vocab
# split 16 ways, 8016 columns a rank; a rank's (2, 2048, 8016) fp32 logits 0.13 GB
# at once unchunked, a chunk's 32 MB at 512
FAM_CE_CHUNK = 512
FAM_CE_SHAPE = (1, 16)


def _fam_moe_decode_gate(cfg, params, prompts, shape, tag: str, smi) -> dict:
    """fp32: the sharded decode loop on ``shape`` under ``Policy()``
    (FAM_MOE_PROMPT teacher-forced steps, then FAM_MOE_GREEDY - 1 greedy ones; the
    MoE by ``_moe_view``'s decode rule, ``moe_apply``'s function: for experts split
    on E the gshard rule, each rank's experts and one sum over ``model``) against
    the unsharded decode loop of the weights in fp64, within max(FP32_TOL, the
    unsharded fp32 loop's own distance from it), every run replaying the fp64
    loop's routing (each rank its rows); launches (none: decode attends plainly)
    and ``CommStats`` against the closed forms, a step each."""
    from repro_torch import tree as tree_lib

    policy = _fam_policy(cfg, "tp")
    p64 = tree_lib.tree_map(lambda t: t.double(), params)
    with _routing_log() as log_:
        ex = _tp_decode(cfg, None, p64, prompts, FAM_MOE_GREEDY, policy)[0]
    moe_log = list(log_)
    del p64
    torch.cuda.empty_cache()
    plain = _tp_decode(cfg, None, params, prompts, FAM_MOE_GREEDY, policy, replay=moe_log)[0]
    floor = rel_l2(plain, ex)
    bound = max(FP32_TOL, floor)
    mesh, _, blocks = _tp_shard(cfg, params, shape, policy)
    mesh.stats.reset()
    _reset_counts()
    got, toks, sec = _tp_decode(cfg, mesh, blocks, prompts, FAM_MOE_GREEDY, policy,
                                replay=moe_log)
    label = f"[{tag}] {cfg.name} (moe_mode {cfg.moe_mode!r}) fp32 decode on (data, model) = {shape}"
    launches = _expect_launches(label)
    b, steps = prompts.shape[0], prompts.shape[1] + FAM_MOE_GREEDY - 1
    step = _fam_closed_forms(cfg, policy, shape, b, 1, "decode")
    want = {k: ({"calls": v["calls"] * steps, "bytes": v["bytes"] * steps}
                if isinstance(v, dict) else v) for k, v in step.items()}
    stats = _tp_step_stats_check(label, mesh, want)
    err = rel_l2(got, ex)
    route = _route_of(cfg, policy, shape, b)
    line = (f"{label} at {cfg.n_layers} layers, batch {b}: {prompts.shape[1]} teacher-forced "
            f"and {FAM_MOE_GREEDY - 1} greedy steps ({route}), {sec * 1e3:.1f} ms a step; the "
            f"prompt steps' logits vs the fp64 loop rel_l2 {err:.3e} (tol max({FP32_TOL}, the "
            f"unsharded fp32 loop's {floor:.3e})); tokens {toks[0].tolist()}; launches "
            f"{launches}; CommStats a rank {json.dumps(stats)} (closed forms, {steps} steps; "
            "the fp64 loop's routing replayed)")
    log(line + f" [{smi}]")
    if not (err <= bound and torch.isfinite(got).all()
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{line}: over the bound")
    del blocks, mesh
    return {"vs_fp64": err, "floor": floor, "bound": bound, "ms_step": sec * 1e3,
            "route": route, "launches": launches, "stats": stats}


def _ep_grouping(cfg):
    """The context of an unsharded reference run of ``cfg`` against the sharded path:
    EP's one group of the whole batch (``_ep_whole``), else none."""
    return _ep_whole() if cfg.moe_mode == "ep" else contextlib.nullcontext()


def _fam_moe_mode_gates(cfg, params, smi) -> dict:
    """moonshot at FAM_MOE_PREFILL_LAYERS layers in fp32 (the tp mode's gate
    weights) under each of FAM_MOE_MODES: the prefill gate (``_fam_prefill_gate``,
    64 tf32 launches a call) and the decode gate on each of FAM_MOE_PREFILL_SHAPES;
    EP's fp64 and unsharded runs route the whole batch as one group
    (``_ep_whole``), as its ranks do together."""
    out = {"prefill": {}, "decode": {}}
    batch = _fam_batch(cfg, *FAM_PREFILL)
    prompts = batch["tokens"][:, :FAM_MOE_PROMPT].contiguous()
    for mode in FAM_MOE_MODES:
        c = dataclasses.replace(cfg, moe_mode=mode)
        for shape in FAM_MOE_PREFILL_SHAPES:
            key = f"{mode}_{shape[0]}x{shape[1]}"
            with _ep_grouping(c):
                out["prefill"][key] = _fam_prefill_gate(c, params, batch, shape, "tp",
                                                        f"tp-moe-{mode}", smi)
            out["decode"][key] = _fam_moe_decode_gate(c, params, prompts, shape,
                                                      f"tp-moe-{mode}", smi)
            _fam_free()
    return out


def _fam_moe_mode_train(cfg, params, smi) -> dict:
    """The training gate (``_fam_train_gate``, the cut route) of moonshot at
    FAM_MOE_LAYERS in fp32 under ``moe_mode="ep"`` on each of FAM_MOE_EP_SHAPES:
    against one fp64 run that routes the whole batch as one group (``_ep_whole``),
    as EP's ranks do together on either mesh.  The gate leaves ``params`` on the
    host; it takes them back to the card."""
    from repro_torch import tree as tree_lib

    out = {}
    batch = _fam_batch(cfg, *FAM_TRAIN)
    c = dataclasses.replace(cfg, moe_mode="ep")
    params = tree_lib.tree_map(lambda t: t.to(TP_DEVICE), params)
    with _ep_grouping(c):
        gate = _fam_train_gate(c, params, batch, [("auto", shape, "tp")
                                                  for shape in FAM_MOE_EP_SHAPES],
                               "tp-moe-ep", smi)
    for key, run in gate.pop("runs").items():
        out[f"ep_{key}"] = {**run, **{f"gate_{k}": v for k, v in gate.items()
                                      if k != "floor"}}
    _fam_free()
    return out


def _fam_moe_mode_bf16(smi) -> dict:
    """moonshot bf16 at full width and FAM_MOE_BF16_LAYERS layers (the 48-layer
    init's scale) under each of FAM_MOE_MODES on FAM_MOE_MODE_BF16_SHAPE: the TP
    prefill (B 4 x 2048, 16 sm90 launches a layer) against the unsharded one of
    its grouping, reported, not gated (bf16 at depth is chaotic); the weights
    drawn anew for each (a mode's blocks are cut from the whole tree, which they
    free)."""
    from repro_torch.configs import get_config

    out = {}
    for mode in FAM_MOE_MODES:
        whole = get_config(MOE_ARCH)
        cfg = dataclasses.replace(whole, moe_mode=mode, n_layers=FAM_MOE_BF16_LAYERS)
        params, meta = _load_model(cfg, f"tp-moe-{mode}", torch.bfloat16)
        _rescale_stacks(params["layers"], cfg.n_layers, whole.n_layers)
        out[mode] = {**meta, **_fam_bf16_serve(
            cfg, params, {"text": _fam_batch(cfg, *FAM_PREFILL)}, f"tp-moe-{mode}", smi,
            decode=False, calls=1, shape=FAM_MOE_MODE_BF16_SHAPE,
            around=lambda c=cfg: _ep_grouping(c))}
        log(f"[tp-moe-{mode}] bf16 at {cfg.n_layers} layers on (data, model) = "
            f"{FAM_MOE_MODE_BF16_SHAPE}: peak {out[mode]['peak_gib']:.2f} GiB, from the "
            f"blocks' cut to the TP prefill's end [{smi}]")
        del params
        _fam_free()
    return out


def _fam_ce_chunk(smi) -> dict:
    """llama3.2-3b at TP_TRAIN_LAYERS in fp32 (the 28-layer init's scale) trained
    under ``Policy()`` on FAM_CE_SHAPE with ``ce_chunk`` FAM_CE_CHUNK and without
    (``_fam_train_gate``): each within max(FP32_TOL, floor) of the fp64 run, and
    the chunked step's loss and gradient leaves within the same bounds of the
    unchunked step's, and the 16 ranks' loss (forward and backward) at a lower
    peak above what was live as it began (``_tp_train_step``'s ``loss_peak``;
    the whole step's peak is set by the layers' backward, whatever the loss)."""
    cfg, params = _fam_fp32_model(TP_ARCH, TP_TRAIN_LAYERS)
    out = _fam_train_gate(cfg, params, _fam_batch(cfg, *FAM_TRAIN),
                          [("auto", FAM_CE_SHAPE, "tp"),
                           ("auto", FAM_CE_SHAPE, "tp", {"ce_chunk": FAM_CE_CHUNK})],
                          "tp-ce", smi)
    del params
    _fam_free()
    return out


def _fam_audio(smi) -> dict:
    """whisper-tiny whole in ``phase_tp_families``: the fp32 gates on the weights
    scaled to 1/sqrt(input width) under its ``default_policy``, ``layout="fsdp"``
    and ``Policy()``, then the bf16 TP prefill on the
    reference init (the phase's docstring)."""
    from repro_torch.configs import get_config

    out = {}
    cfg = get_config(AUDIO_ARCH)
    params, _ = _load_model(cfg, "tp-audio", torch.float32)
    _rescale_stacks(params["layers"], cfg.n_layers, None)
    _rescale_stacks(params["encoder"]["layers"], cfg.enc_layers, None)
    batch = _fam_batch(cfg, FAM_AUDIO_BATCH, FAM_AUDIO_LEN)
    out["audio_prefill"] = {layout: _fam_prefill_gate(cfg, params, {
        k: v for k, v in batch.items() if k != "labels"}, FAM_AUDIO_SHAPE, layout, "tp-audio",
        smi) for layout in ("2d", "fsdp")}
    # -- whisper-tiny under Policy(): the pair and gather routes, the decode on the
    # rank's block of the cross-attention cache
    out["audio_tp_prefill"] = {route: _fam_prefill_gate(cfg, params, {
        k: v for k, v in _fam_batch(cfg, b, s).items() if k != "labels"}, shape, "tp",
        "tp-audio", smi) for route, shape, b, s in AUDIO_TP_PREFILL}
    prompts = batch["tokens"][:, :REC_DECODE_PROMPT].contiguous()
    out["audio_tp_decode"] = _rec_decode_gate(cfg, params, prompts, FAM_SHAPE, "tp",
                                              "tp-audio", smi)
    out["audio_train"] = _fam_train_gate(cfg, params, batch,
                                         [("auto", FAM_AUDIO_SHAPE, layout)
                                          for layout in ("2d", "fsdp")], "tp-audio", smi)
    del batch
    _to_device(params)  # from the host copy the tp=False training gate left
    out["audio_tp_train"] = _fam_train_gate(cfg, params, _fam_batch(cfg, *FAM_TRAIN),
                                            [("auto", shape, "tp")
                                             for shape in AUDIO_TP_TRAIN_SHAPES],
                                            "tp-audio", smi)
    del params
    _fam_free()
    params, meta = _load_model(cfg, "tp-audio", torch.bfloat16)
    _, shape, b, s = AUDIO_TP_PREFILL[0]
    out["audio_tp_bf16"] = {**meta, **_fam_bf16_serve(cfg, params, {
        "pair": {k: v for k, v in _fam_batch(cfg, b, s).items() if k != "labels"}},
        "tp-audio", smi, decode=False, calls=2, shape=shape)}
    del params
    _fam_free()
    return out


def phase_tp_families(smi) -> dict:
    """The sharded layout of the MoE, VLM and audio families on 16 rank threads of
    the card (``parallel/tensor_parallel.py``), each rank computing from its blocks
    under ``sanitize_specs(param_specs(policy))``:

    * moonshot-v1-16b-a3b (64 experts top-6, split on d_ff over ``model``), TP in
      fp32 at the 48-layer init's scale: the prefill gate (B 4 x 2048) at
      FAM_MOE_PREFILL_LAYERS layers on (data, model) = (1, 16) and (2, 8), the
      training gate at FAM_MOE_LAYERS on (1, 16), (2, 8) and ring (2, 8) (B 2 x
      2048), every run replaying the fp64 run's routing; then bf16 at full width
      and FAM_MOE_BF16_LAYERS layers on (1, 16): the TP prefill (B 4 x 2048, 16
      sm90 launches a layer) and a few greedy decode steps;
    * qwen2-vl-7b (M-RoPE at an image grid): bf16 at FAM_VLM_BF16_LAYERS, the TP prefill at B 4 on
      (1, 16) (the pair route) and at B 2 (the gather route); fp32 at
      FAM_VLM_LAYERS layers, the prefill gate at B 4 and the training gate at B 2
      (the gather route) on (1, 16);
    * whisper-tiny whole, on weights scaled to 1/sqrt(input width) as
      ``phase_audio``'s gates: under its ``default_policy`` (``tp=False``) and
      ``layout="fsdp"`` on (2, 8), B 16 x 512, the fp32 prefill and training gates;
      and under ``Policy()``: the fp32 prefill gates on the
      pair and gather routes (AUDIO_TP_PREFILL, the flash kernel on the rank's
      heads), the decode gate on (1, 16) (the cross-attention on the rank's
      head_dim columns of its cache), the training gate at FAM_TRAIN on
      AUDIO_TP_TRAIN_SHAPES, and the bf16 whole prefill on the pair route
      (reported);
    * the fifteenth slice: moonshot with its experts split on E over ``model``
      (``moe_mode`` "gshard" and "ep"): the fp32 prefill and decode gates at
      FAM_MOE_PREFILL_LAYERS layers on (1, 16) and (2, 8) and the training gate
      at FAM_MOE_LAYERS on both, EP's references routing the whole batch as one
      group (``_ep_whole``: EP's own training gate on both meshes; gshard's runs
      share the tp mode's, FAM_MOE_MODE_RUNS); bf16 whole on
      FAM_MOE_MODE_BF16_SHAPE at FAM_MOE_BF16_LAYERS layers, reported;
      and llama3.2-3b at TP_TRAIN_LAYERS trained with ``ce_chunk`` FAM_CE_CHUNK
      against the same step without it (``_fam_ce_chunk``).

    Gates as ``phase_tp_train``'s; launches by variant and ``CommStats`` a rank
    against closed forms (``_fam_closed_forms``); the peak reported.  Forward and
    the cut route only: the ranks' backwards would share the card's one autograd
    thread."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = {}

    # -- moonshot-v1-16b-a3b: fp32 gates (moe_mode "tp", then "gshard" and "ep" on
    # the same weights), then bf16 at FAM_MOE_BF16_LAYERS
    cfg, params = _fam_fp32_model(MOE_ARCH, FAM_MOE_PREFILL_LAYERS)
    batch = _fam_batch(cfg, *FAM_PREFILL)
    out["moe_prefill"] = {f"{d}x{m}": _fam_prefill_gate(cfg, params, batch, (d, m), "tp",
                                                        "tp-moe", smi)
                          for d, m in FAM_MOE_PREFILL_SHAPES}
    del batch
    out["moe_modes"] = _fam_moe_mode_gates(cfg, params, smi)
    del params
    _fam_free()
    cfg, params = _fam_fp32_model(MOE_ARCH, FAM_MOE_LAYERS)
    out["moe_train"] = _fam_train_gate(cfg, params, _fam_batch(cfg, *FAM_TRAIN),
                                       [(sync, shape, "tp") for sync, shape in FAM_MOE_RUNS]
                                       + list(FAM_MOE_MODE_RUNS), "tp-moe", smi)
    out["moe_modes"]["train"] = _fam_moe_mode_train(cfg, params, smi)
    del params
    _fam_free()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=FAM_MOE_BF16_LAYERS)
    params, meta = _load_model(cfg, "tp-moe", torch.bfloat16)
    _rescale_stacks(params["layers"], cfg.n_layers, full.n_layers)
    out["moe_bf16"] = {**meta, **_fam_bf16_serve(cfg, params, {
        "text": _fam_batch(cfg, *FAM_PREFILL)}, "tp-moe", smi, decode=True, calls=2)}
    del params
    _fam_free()
    out["moe_modes"]["bf16"] = _fam_moe_mode_bf16(smi)

    # -- qwen2-vl-7b: bf16 at FAM_VLM_BF16_LAYERS at image positions (pair and
    # gather), fp32 gates
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=FAM_VLM_BF16_LAYERS)
    params, meta = _load_model(cfg, "tp-vlm", torch.bfloat16)
    _rescale_stacks(params["layers"], cfg.n_layers, full.n_layers)
    b, s = FAM_PREFILL
    out["vlm_bf16"] = {**meta, **_fam_bf16_serve(cfg, params, {
        "pair": _fam_batch(cfg, b, s, _image_positions(b, s)),
        "gather": _fam_batch(cfg, FAM_GATHER_BATCH, s, _image_positions(FAM_GATHER_BATCH, s))},
        "tp-vlm", smi, decode=False)}
    del params
    _fam_free()
    cfg, params = _fam_fp32_model(VLM_ARCH, FAM_VLM_LAYERS)
    out["vlm_prefill"] = _fam_prefill_gate(cfg, params,
                                           _fam_batch(cfg, b, s, _image_positions(b, s)),
                                           FAM_SHAPE, "tp", "tp-vlm", smi)
    tb, ts = FAM_TRAIN
    out["vlm_train"] = _fam_train_gate(cfg, params, _fam_batch(cfg, tb, ts,
                                                               _image_positions(tb, ts)),
                                       [("auto", FAM_SHAPE, "tp")], "tp-vlm", smi)
    del params
    _fam_free()

    # -- whisper-tiny whole under both tp=False layouts and under Policy()
    out.update(_fam_audio(smi))

    # -- llama3.2-3b: the chunked loss under TP
    out["ce_chunk"] = _fam_ce_chunk(smi)
    out["s"] = time.perf_counter() - t_phase
    log(f"[tp-families] phase {out['s']:.1f}s")
    return out


# The SSM and hybrid families' sharded layout (phase_tp_recurrent), on 16 rank
# threads of the card.  Neither family reaches a kernel, in JAX or here: every
# flash and RMSNorm count on these paths is 0.
RECURRENT = ("ssm", "hybrid")
# Their fp32 gates hold a sharded path within max(FP32_TOL, REC_FLOOR_FACTOR x the
# unsharded fp32 path's own distance from fp64), as phase_hybrid's accuracy gate
# holds the decode: an RG-LRU decay a near 1 scales its input's rounding by
# ~1/(1 - a) in sqrt(1 - a^2), so two fp32 summation orders (the sharded row sums,
# the unsharded matmuls) land ~1e-2 from fp64 at the hybrid's 5 layers, either
# one the nearer.
REC_FLOOR_FACTOR = 2


def _gate_bound(cfg, floor: float) -> float:
    """max(FP32_TOL, floor), the floor doubled for the SSM and hybrid families."""
    return max(FP32_TOL, (REC_FLOOR_FACTOR if cfg.family in RECURRENT else 1) * floor)
# recurrentgemma-9b's fp32 prefill gates at HYBRID_LAYERS (a block and the
# tail): (route, (data, model), B, S); 16 rows of 512 take the pair route on
# (1, 16) (1 row a rank with the lone kv head), 4 of 2048 the gather route on (2, 8)
REC_PREFILL = (("pair", (1, 16), 16, 512), ("gather", (2, 8), 4, 2048))
REC_DECODE_PROMPT, REC_DECODE_STEPS = 4, 3  # the fp32 decode gates: teacher-forced, greedy
# The training gate's depth: one (rec, rec, attn) block, the least that runs both
# layer kinds.  Reckoned before the first run, in GB: at HYBRID_LAYERS (3.22G
# params) the fp64 run holds 25.8 of weights, 25.8 of gradients and ~25 of
# logits, their fp32 copy and the loss's gradient (B 2 x 2048 x 256000), beside
# 12.9 of fp32 weights: over 80.  At 3 layers (2.75G) the weights move to the
# host first: 22 + 22 + ~25 = ~69 for the fp64 run; the 16 ranks' step then
# holds 11 of blocks, 22 of moments, 11 of gradients and the ranks'
# activations: reckoned ~8, measured 71.08 GiB on (1, 16) and 56.56 on (2, 8)
# (an H100 80GB HBM3 at 700 W): 2 rows do not tile 16 ranks, so each rank attends
# every head of its rows, (2, 16, 2048, 2048) fp32 scores kept for the backward.
REC_TRAIN_LAYERS = 3
# The hybrid's training runs: TP alone, and with FSDP.  The ring over data (blocks
# whole over data) is not run on one card: its 16 ranks hold two copies of the
# 2.75G parameters, with their moments and gradients, 32 B a parameter: 88 GB,
# and 67 GB for the embeddings alone at any depth (on an 80 GB H100: out of
# memory).  The CPU tests run it (tests/test_torch_tp_recurrent_train.py).
REC_TRAIN_RUNS = (("auto", (1, 16)), ("auto", (2, 8)))
REC_SSM_BATCH = (16, 512)  # mamba2-130m: one row a rank under layout="fsdp"
REC_DRYRUN_PEAK_RTOL = 0.01  # the dry-run's hybrid rank: its peak against the card's
# its tokens and mesh: the ranks past 0 train full-width blocks on the host (B 1 x 256
# on (1, 4): a 38.7 s step; x 64: 25.0 s, on an H100 80GB HBM3 at 700 W)
REC_DRYRUN_LEN, REC_DRYRUN_SHAPE = 64, (1, 2)
REC_SSM_SHAPE = (2, 8)
# mamba2-130m and whisper-tiny whole under Policy() (TP over model, FSDP over
# data).  mamba2's w_in (3352 = 2^3 x 419 columns) and vocab (50280) stay whole
# over 16 ranks and split over 8; its prefill and decode gates at REC_SSM_BATCH,
# training at FAM_TRAIN on both meshes.
SSM_TP_SHAPES = ((1, 16), (2, 8))
# whisper-tiny's prefill gates (route, (data, model), B, S): 16 rows x 6 kv heads
# over 16 ranks take the pair route (1 row a rank with its 6 heads), 2 rows a data
# rank x 6 over 8 do not tile (the gather route); training at FAM_TRAIN (2 rows x
# 6 over 16, 1 x 6 over 8: the gather route) on both meshes; the bf16 whole
# prefill on FAM_SHAPE at AUDIO_TP_PREFILL's pair batch, reported
AUDIO_TP_PREFILL = (("pair", (1, 16), 16, 512), ("gather", (2, 8), 4, 512))
AUDIO_TP_TRAIN_SHAPES = ((1, 16), (2, 8))
# The collectives GSPMD puts in the JAX package's jitted prefill for one
# (rec, rec, attn) block of recurrentgemma-9b on (data, model) = (1, 16) host
# devices, B 4 x 2048, from ``PYTHONPATH=src python
# benchmarks/gspmd_tp_collectives.py --arch recurrentgemma-9b --layers 3`` (jax
# 0.9.0 on the CPU, whose backend upcasts bf16 dots: the f32 is not evidence
# about a TPU).
GSPMD_HYBRID_BLOCK = (
    "each recurrent layer: 1 all-gather f32[4,2048,4096] (the conv output, whole "
    "over model for w_a and w_i), 2 all-reduce f32[4,2048,4096] (w_out, w_down); the "
    "attention layer: all-gathers f32[4,2048,1,256] of k and of v (the lone kv head "
    "split on head_dim), 4 collective-permutes and 3 all-to-alls re-laying out the "
    "heads, 2 all-reduces; decode all-gathers the whole f32[4,2048,1,256] window of "
    "k and of v in each attention layer")


def _rec_decode_gate(cfg, params, prompts, shape, layout, tag: str, smi) -> dict:
    """fp32: the sharded decode loop (REC_DECODE_PROMPT teacher-forced steps, then
    REC_DECODE_STEPS - 1 greedy ones) on ``shape`` under ``layout``: each prompt
    step's logits against the unsharded prefill of the prompt up to that step on
    the weights in fp64 (the SSM's decode state stays fp32 by design; the audio
    family's decode reads its zero cross-attention cache, not the encoder, so
    against the unsharded decode loop on the weights in fp64, as
    ``phase_audio``'s), within ``_gate_bound``'s bound on the unsharded fp32
    decode's own distance from it; launches (none: decode attends without the
    kernel) and ``CommStats`` against the closed forms (a decode step's, a
    step)."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import get_model, layers

    policy = _fam_policy(cfg, layout)
    p64 = tree_lib.tree_map(lambda t: t.to(TP_DEVICE, torch.float64), params)
    with torch.no_grad():
        if cfg.family == "audio":
            ex = _tp_decode(cfg, None, p64, prompts, 1, policy)[0]
        else:
            ex = torch.cat([(get_model(cfg).forward(cfg, p64, prompts[:, :t],
                                                    return_hidden=True)[0]
                             [:, -1:] @ layers.unembed(p64)).float()
                            for t in range(1, prompts.shape[1] + 1)], 1)
    del p64
    torch.cuda.empty_cache()
    plain = _tp_decode(cfg, None, params, prompts, 1, policy)[0]
    floor = rel_l2(plain, ex)
    bound = _gate_bound(cfg, floor)
    mesh, _, blocks = _tp_shard(cfg, params, shape, policy)
    mesh.stats.reset()
    _reset_counts()
    got, toks, sec = _tp_decode(cfg, mesh, blocks, prompts, REC_DECODE_STEPS, policy)
    label = f"[{tag}] {cfg.name} {layout} fp32 decode on (data, model) = {shape}"
    launches = _expect_launches(label)
    b, steps = prompts.shape[0], prompts.shape[1] + REC_DECODE_STEPS - 1
    step = _fam_closed_forms(cfg, policy, shape, b, 1, "decode")
    want = {k: ({"calls": v["calls"] * steps, "bytes": v["bytes"] * steps}
                if isinstance(v, dict) else v) for k, v in step.items()}
    stats = _tp_step_stats_check(label, mesh, want)
    err = rel_l2(got, ex)
    route = _route_of(cfg, policy, shape, b)
    line = (f"{label}, batch {b}: {prompts.shape[1]} teacher-forced and "
            f"{REC_DECODE_STEPS - 1} greedy steps ({route}), {sec * 1e3:.1f} ms a step; the "
            f"prompt steps' logits vs the fp64 "
            f"{'decode loop' if cfg.family == 'audio' else 'prefills'} rel_l2 {err:.3e} (tol "
            f"max({FP32_TOL}, {REC_FLOOR_FACTOR if cfg.family in RECURRENT else 1} x the "
            f"unsharded fp32 decode's {floor:.3e})); tokens "
            f"{toks[0].tolist()}; launches "
            f"{launches}; CommStats a rank {json.dumps(stats)} (closed forms, {steps} steps)")
    log(line + f" [{smi}]")
    if not (err <= bound and torch.isfinite(got).all()
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{line}: over the bound")
    del blocks, mesh
    return {"vs_fp64": err, "floor": floor, "bound": bound, "ms_step": sec * 1e3,
            "route": route, "launches": launches, "stats": stats}


def _block_collectives(cfg, shape, batch: int, seq: int, dtype) -> str:
    """One (rec, rec, attn) block's collectives a rank of the TP prefill, from the
    closed forms (``_fam_closed_forms`` of two blocks less one's)."""
    period = max(1, cfg.attention_period)
    a, b = (_fam_closed_forms(dataclasses.replace(cfg, n_layers=k * period),
                              _fam_policy(cfg, "tp"), shape, batch, seq, "prefill", dtype=dtype)
            for k in (2, 1))
    return ", ".join(f"{k} {a[k]['calls'] - b[k]['calls']} calls "
                     f"{a[k]['bytes'] - b[k]['bytes']} B"
                     for k in ("psum", "all_gather", "all_to_all", "reduce_scatter"))


def _rec_ssm(smi) -> dict:
    """mamba2-130m whole in ``phase_tp_recurrent``: the fp32 gates under its
    ``default_policy``, ``layout="fsdp"`` and ``Policy()``
    (the phase's docstring)."""
    from repro_torch.configs import get_config

    out = {}
    cfg = get_config(SSM_ARCH)
    params, _ = _load_model(cfg, "tp-ssm", torch.float32)
    batch = _fam_batch(cfg, *REC_SSM_BATCH)
    out["ssm_prefill"] = {layout: _fam_prefill_gate(cfg, params, {
        k: v for k, v in batch.items() if k != "labels"}, REC_SSM_SHAPE, layout, "tp-ssm", smi)
        for layout in ("2d", "fsdp")}
    prompts = batch["tokens"][:, :REC_DECODE_PROMPT].contiguous()
    out["ssm_decode"] = {layout: _rec_decode_gate(cfg, params, prompts, REC_SSM_SHAPE, layout,
                                                  "tp-ssm", smi) for layout in ("2d", "fsdp")}
    # -- mamba2-130m under Policy(): w_in and the vocab whole over model on (1, 16)
    # and split on (2, 8)
    out["ssm_tp_prefill"] = {f"{d}x{m}": _fam_prefill_gate(cfg, params, {
        k: v for k, v in batch.items() if k != "labels"}, (d, m), "tp", "tp-ssm", smi)
        for d, m in SSM_TP_SHAPES}
    out["ssm_tp_decode"] = _rec_decode_gate(cfg, params, prompts, SSM_TP_SHAPES[0], "tp",
                                            "tp-ssm", smi)
    out["ssm_train"] = _fam_train_gate(cfg, params, batch,
                                       [("auto", REC_SSM_SHAPE, layout)
                                        for layout in ("2d", "fsdp")], "tp-ssm", smi)
    del batch
    _fam_free()
    out["ssm_tp_train"] = _fam_train_gate(cfg, params, _fam_batch(cfg, *FAM_TRAIN),
                                          [("auto", shape, "tp") for shape in SSM_TP_SHAPES],
                                          "tp-ssm", smi)
    del params
    _fam_free()
    return out


def phase_tp_recurrent(smi) -> dict:
    """The sharded layout of the SSM and hybrid families on 16 rank threads of the
    card (``parallel/tensor_parallel.py``), each rank computing from its blocks
    under ``sanitize_specs(param_specs(policy))``:

    * recurrentgemma-9b TP over ``model`` (the recurrent layers on Dr / 16 channels,
      the conv output all-gathered for ``w_a`` and ``w_i``; MQA on whole heads) and
      FSDP over ``data``, in fp32 at the 38-layer init's scale: the prefill gate
      at HYBRID_LAYERS (a block and the tail) on the pair route ((1, 16), 16 x
      512) and the gather route ((2, 8), 4 x 2048), the decode gate on (1, 16);
      the training gate at REC_TRAIN_LAYERS (2 x 2048; (1, 16), (2, 8); the ring
      does not fit one card, REC_TRAIN_RUNS), ``lambda_p``'s gradient among the
      leaves; then bf16 whole: the TP
      prefill (4 x 2048) and a few decode steps against the unsharded run
      (reported: bf16 at depth is chaotic);
    * mamba2-130m whole under its ``default_policy`` (``tp=False``) and
      ``layout="fsdp"`` on (2, 8), 16 x 512: the prefill, decode and training
      gates;
    * mamba2-130m whole under ``Policy()`` (each rank on
      P / n channels of every head, ``w_in`` and the vocab whole over 16 ranks and
      split over 8): the prefill gates at 16 x 512 on SSM_TP_SHAPES, the decode
      gate on (1, 16), the training gate at FAM_TRAIN on both meshes.

    Gates as ``phase_tp_families``'; no launch on any path; ``CommStats`` a rank
    against the closed forms (``_fam_closed_forms``), GSPMD's collectives for the
    hybrid's block beside the port's."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = {"parts_s": {}}

    def part(name):  # the seconds since the last part ended
        now = time.perf_counter()
        out["parts_s"][name] = now - sum(out["parts_s"].values()) - t_phase

    # -- recurrentgemma-9b: fp32 gates, then bf16 whole
    full, cfg, params = _hybrid_fp32_model()
    out["hybrid_prefill"] = {}
    for route, shape, b, s in REC_PREFILL:
        batch = {k: v for k, v in _fam_batch(cfg, b, s).items() if k != "labels"}
        out["hybrid_prefill"][route] = _fam_prefill_gate(cfg, params, batch, shape, "tp",
                                                         "tp-hybrid", smi)
    prompts = _fam_batch(cfg, 16, REC_DECODE_PROMPT)["tokens"]
    part("hybrid_prefill")
    out["hybrid_decode"] = _rec_decode_gate(cfg, params, prompts, (1, 16), "tp", "tp-hybrid",
                                            smi)
    part("hybrid_decode")
    cfg = dataclasses.replace(cfg, n_layers=REC_TRAIN_LAYERS)
    params.pop("tail")  # one block: blocks.rec (2) and blocks.attn (1)
    _fam_free()
    out["hybrid_train"] = _fam_train_gate(cfg, params, _fam_batch(cfg, *FAM_TRAIN),
                                          [(sync, shape, "tp") for sync, shape in REC_TRAIN_RUNS],
                                          "tp-hybrid", smi)
    del params
    _fam_free()
    part("hybrid_train")
    params, meta = _load_model(full, "tp-hybrid", torch.bfloat16, _hybrid_desc(full))
    b, s = FAM_PREFILL
    out["hybrid_bf16"] = {**meta, **_fam_bf16_serve(full, params, {
        "gather": _fam_batch(full, b, s)}, "tp-hybrid", smi, decode=True, calls=2)}
    del params
    _fam_free()
    port = _block_collectives(full, FAM_SHAPE, b, s, torch.bfloat16)
    log(f"[tp-hybrid] one (rec, rec, attn) block of the bf16 TP prefill, B {b} x {s} on "
        f"(data, model) = {FAM_SHAPE}, a rank (CommStats' closed forms, held above): {port}; "
        f"GSPMD's for the same block (jax 0.9.0 on the CPU): {GSPMD_HYBRID_BLOCK}")
    out["hybrid_block_collectives"] = {"port": port, "gspmd": GSPMD_HYBRID_BLOCK}
    part("hybrid_bf16")

    # -- mamba2-130m whole under both tp=False layouts and under Policy()
    out.update(_rec_ssm(smi))
    part("ssm")
    out["s"] = time.perf_counter() - t_phase
    log(f"[tp-recurrent] phase {out['s']:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in out["parts_s"].items()))
    return out


def _timed(phase, *args):
    """``phase(*args)``, its seconds logged (the script's time by phase)."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t_start = time.perf_counter()
    smi = _timed(phase_device)
    _timed(phase_build)
    sass = _timed(phase_sass)
    flash = _timed(phase_kernel_checks)
    rms_kernel = _timed(phase_rmsnorm_checks)

    cfg = get_config("llama3.2-3b")
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0))
    prefill = _timed(phase_prefill, cfg, params, smi)
    params32 = _timed(phase_e2e_fp32, cfg)
    _timed(phase_serve, cfg, params, params32, smi)
    del params, params32  # 7.2 + 14.4 GB, before training takes the card
    torch.cuda.empty_cache()
    train, train_loss = _timed(phase_train, cfg, smi)
    driver = _timed(phase_train_driver)
    pipeline = _timed(phase_pipeline, smi)
    sharding = _timed(phase_sharding, smi)
    sync = _timed(phase_sync_collectives, smi)
    sync_train = _timed(phase_sync_train, smi)
    torchrun = _timed(phase_torchrun, smi)
    moe_serve, moe_bf16 = _timed(phase_moe_serve, smi)
    moe_ep_prefill = _timed(phase_moe_ep_prefill, moe_bf16, smi)
    del moe_bf16
    moe_cfg, moe_params, moe_fp32 = _timed(phase_moe_fp32, smi)
    moe_ep_gate = _timed(phase_moe_ep_gate, moe_cfg, moe_params, smi)
    moe_train = _timed(phase_moe_train, moe_cfg, moe_params, smi)
    del moe_params
    moe_ep = _timed(phase_moe_ep, smi)
    ssm = _timed(phase_ssm, smi)
    hybrid = _timed(phase_hybrid, smi)
    vlm = _timed(phase_vlm, smi)
    audio = _timed(phase_audio, smi)
    dryrun = _timed(phase_dryrun, smi)
    flowsim = _timed(phase_flowsim, smi)
    tp = _timed(phase_tp_serve, smi)
    tp_train = _timed(phase_tp_train, smi, train_loss)
    tp_fam = _timed(phase_tp_families, smi)
    tp_rec = _timed(phase_tp_recurrent, smi)

    paths = {"prefill": prefill, "train_steps": train, "train_driver": driver,
             "train_sync": sync_train["launches"], "prefill_moe": moe_serve["launches"],
             "train_moe": moe_train["launches"], "train_pipeline": pipeline["launches"],
             "prefill_moe_ep": moe_ep_prefill["launches"], "prefill_tp": tp["launches"],
             **{f"prefill_tp_fp32_{k}": tp["fp32"][k]["launches"] for k in ("1x16", "2x8")},
             **{f"train_tp_{k}": run["launches"] for k, run in tp_train["runs"].items()},
             "prefill_tp_moe": tp_fam["moe_bf16"]["text"]["launches"],
             **{f"prefill_tp_moe_fp32_{k}": r["launches"]
                for k, r in tp_fam["moe_prefill"].items()},
             **{f"train_tp_moe_{k}": r["launches"]
                for k, r in tp_fam["moe_train"]["runs"].items()},
             **{f"prefill_tp_moe_{k}_fp32": r["launches"]
                for k, r in tp_fam["moe_modes"]["prefill"].items()},
             **{f"decode_tp_moe_{k}_fp32": r["launches"]
                for k, r in tp_fam["moe_modes"]["decode"].items()},
             **{f"train_tp_moe_{k}": r["launches"]
                for k, r in tp_fam["moe_modes"]["train"].items()},
             **{f"prefill_tp_moe_{k}": r["text"]["launches"]
                for k, r in tp_fam["moe_modes"]["bf16"].items()},
             **{f"train_tp_ce_{k}": r["launches"]
                for k, r in tp_fam["ce_chunk"]["runs"].items()},
             **{f"prefill_tp_vlm_{k}": tp_fam["vlm_bf16"][k]["launches"]
                for k in ("pair", "gather")},
             "prefill_tp_vlm_fp32": tp_fam["vlm_prefill"]["launches"],
             **{f"train_tp_vlm_{k}": r["launches"]
                for k, r in tp_fam["vlm_train"]["runs"].items()},
             **{f"prefill_fsdp_audio_{k}": r["launches"]
                for k, r in tp_fam["audio_prefill"].items()},
             **{f"train_fsdp_audio_{k}": r["launches"]
                for k, r in tp_fam["audio_train"]["runs"].items()},
             **{f"prefill_tp_hybrid_fp32_{k}": r["launches"]
                for k, r in tp_rec["hybrid_prefill"].items()},
             "decode_tp_hybrid_fp32": tp_rec["hybrid_decode"]["launches"],
             **{f"train_tp_hybrid_{k}": r["launches"]
                for k, r in tp_rec["hybrid_train"]["runs"].items()},
             "prefill_tp_hybrid": tp_rec["hybrid_bf16"]["gather"]["launches"],
             **{f"prefill_fsdp_ssm_{k}": r["launches"] for k, r in tp_rec["ssm_prefill"].items()},
             **{f"decode_fsdp_ssm_{k}": r["launches"] for k, r in tp_rec["ssm_decode"].items()},
             **{f"train_fsdp_ssm_{k}": r["launches"]
                for k, r in tp_rec["ssm_train"]["runs"].items()},
             **{f"prefill_tp_audio_fp32_{k}": r["launches"]
                for k, r in tp_fam["audio_tp_prefill"].items()},
             "decode_tp_audio_fp32": tp_fam["audio_tp_decode"]["launches"],
             **{f"train_tp_audio_{k}": r["launches"]
                for k, r in tp_fam["audio_tp_train"]["runs"].items()},
             "prefill_tp_audio": tp_fam["audio_tp_bf16"]["pair"]["launches"],
             **{f"prefill_tp_ssm_fp32_{k}": r["launches"]
                for k, r in tp_rec["ssm_tp_prefill"].items()},
             "decode_tp_ssm_fp32": tp_rec["ssm_tp_decode"]["launches"],
             **{f"train_tp_ssm_{k}": r["launches"]
                for k, r in tp_rec["ssm_tp_train"]["runs"].items()}}
    for tag, fam in (("ssm", ssm), ("hybrid", hybrid), ("vlm", vlm), ("audio", audio)):
        paths.update({f"prefill_{tag}": fam["launches"], f"serve_{tag}": fam["serve"]["launches"],
                      f"train_{tag}": fam["train"]["launches"]})

    def by_path(key):
        return {path: counts[key] for path, counts in paths.items()}

    # each kernel's numbers at the shape of its main path: sm90 at the bf16
    # prefill, tf32 at the fp32 training step (simt, on no main path now, there
    # too); the other shapes beside them
    tf32, sm90, simt = flash["tf32"], flash["sm90"], flash["simt"]
    line = {"kernels": [{
        "name": "flash_attention_fwd_tf32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90_tf32.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "variant": "tf32",
        "launches": train["flash_attention_fwd_tf32"],
        "launches_by_path": by_path("flash_attention_fwd_tf32"),
        "checked": True,
        **tf32["train_fp32"],
        **tf32,
        "sass": sass["tf32"],
    }, {
        "name": "flash_attention_fwd_sm90",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "variant": "sm90",
        "launches": prefill["flash_attention_fwd_sm90"],
        "launches_by_path": by_path("flash_attention_fwd_sm90"),
        "checked": True,
        **sm90["prefill_d128_bf16"],
        **sm90,
        "sass": sass["sm90"],
    }, {
        "name": "flash_attention_fwd_simt",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "variant": "simt",
        "launches": train["flash_attention_fwd_simt"],
        "launches_by_path": by_path("flash_attention_fwd_simt"),
        "checked": True,
        **simt["train_fp32"],
        **simt,
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:18",
        "launches": train["rmsnorm"],
        "launches_by_path": by_path("rmsnorm"),
        "checked": True,
        **rms_kernel,
    }]}
    log(json.dumps(line))
    log(json.dumps({"sync": {"device": smi, **sync, "train": sync_train}}))
    log(json.dumps({"moe": {"device": smi, "arch": MOE_ARCH, "serve": moe_serve,
                            "fp32": moe_fp32, "train": moe_train, "ep": moe_ep}}))
    log(json.dumps({"ssm": {"device": smi, "arch": SSM_ARCH, **ssm}}))
    log(json.dumps({"hybrid": {"device": smi, "arch": HYBRID_ARCH, **hybrid}}))
    log(json.dumps({"vlm": {"device": smi, "arch": VLM_ARCH, **vlm}}))
    log(json.dumps({"audio": {"device": smi, "arch": AUDIO_ARCH, **audio}}))
    log(json.dumps({"pipeline": {"device": smi, "arch": PIPE_ARCH, **pipeline}}))
    log(json.dumps({"moe_ep_model": {"device": smi, "arch": MOE_ARCH, "gate": moe_ep_gate,
                                     "prefill": moe_ep_prefill}}))
    log(json.dumps({"sharding": {"device": smi, "arch": PIPE_ARCH, **sharding}}))
    log(json.dumps({"torchrun": {"device": smi, **torchrun}}))
    log(json.dumps({"dryrun": {"device": smi, **dryrun}}))
    log(json.dumps({"flowsim": {"device": smi, **flowsim}}))
    log(json.dumps({"tp_serve": {"device": smi, "arch": TP_ARCH, **tp}}))
    log(json.dumps({"tp_train": {"device": smi, "arch": TP_ARCH, **tp_train}}))
    log(json.dumps({"tp_families": {"device": smi, **tp_fam}}))
    log(json.dumps({"tp_recurrent": {"device": smi, **tp_rec}}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
