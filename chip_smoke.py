#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch/``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build the CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per
     source, started together) and hold fused SGD (K1) bit for bit
     (``torch.equal``) against its plain PyTorch version on the card, at
     n = 1, 255, 65,539 and the whole model;
  Q. hold quantize (K2) and dequantize (K3) bit for bit against their
     plain versions on the card: every MobileNetV2 stage-boundary shape
     at levels 255 with and without a residual (K2 with z written and
     without), odd shapes at levels 4, constant and all-zero channels
     (exact round trip), the error-feedback invariant
     ``res' == z - dequantize(q)``, non-finite inputs (``ok`` False,
     ``z == x + res``), an x one element past a 16-byte boundary, a
     shape whose z does not fit on chip ([1,048,576, 32]: K2 reads x and
     res again after its grid barrier; both branches must run), and K3 on
     the code view ``StageExecutor`` builds (byte offset 8C of one
     buffer; not 16-byte aligned for odd C) at C = 7, 33 and 32, and
     [129, 9001] (more channels than K2 keeps keys for on chip);
  2. hold the port against itself across devices: the MobileNetV2 chain's
     loss and input gradient on the card against the CPU, and three
     ``StageExecutor`` steps through the kernel against the plain path;
  3. the main path: ``run_live_training`` trains the full-width
     MobileNetV2-CIFAR chain (32x32, batch 64, 19 layers) with 3 workers,
     a worker killed at batch 12, §III-D re-partition and §III-F
     recovery, on the default data plane (device tensors handed between
     the workers) and the run's own measured profile;
  F. the same run twice more on one shared measured profile with
     deterministic cuDNN, every payload through the wire codec: on the
     exact tier (``off``), then on the int8-fused tier, where every act
     and grad leaves its stage through K2 and is dequantized by K3 on the
     receiving side. The two take the same partitions and resume at the
     same batch (where the kill's detection timing moved the restart,
     the fused run, or every third time the off run, is run again, up to
     7 times); the fused run's per-batch losses stay within 0.05 of the
     exact run's up to the kill, its last-5 mean loss within 0.05, its
     act+grad bytes under 0.6x. A third, exact run on cuDNN's default
     algorithms prints how far rounding alone moves the losses. Before
     each run the kernels' launch counts are reset, and they are read
     just after;
  P. the main path over TCP: ``Run(RunConfig(transport="tcp"))`` with
     phase F's int8-fused settings (workload, profile, spec capacities,
     cadences, deterministic cuDNN) runs the coordinator and worker 0
     here and workers 1, 2 as spawned OS processes on the card, each
     with its own CUDA context; worker 1 SIGKILLs itself at batch 12.
     Exit codes {1: -9, 2: 0}, every batch committed, losses finite and
     falling, one recovery of worker 1, a re-partition, phase F's
     partitions and recovery partition, and in this process (worker 0,
     stage 0) K1, K2 and K3 each at least once a committed batch. Then a
     failure-free TCP run against a queue run of the same config:
     per-batch losses within rtol 1e-5. Prints a ``{"tcp": ...}`` line:
     wall s, batches/s beside phase F's, start-up s (spawn to the last
     worker heard), recovery s (kill to the resumed batch's commit), the
     bytes by kind the coordinator's process received, exit codes;
  L. the entry point as a user starts it, ``python -m
     repro_torch.launch.live_train --chain mobilenet --workers 3
     --batches 20 --kill 1@8 --transport tcp`` (a subprocess, 300 s at
     most): exit 0, worker exit codes {1: -9, 2: 0}, one recovery;
  A. hold flash attention (K4) against its plain version on the card at
     qwen2-1.5b's heads (H=12, Hkv=2, dh=128), B=4: S=2048 causal,
     S=1000 ragged causal, S=2048 with a 256 window, S=1000 non-causal,
     a 512-row chunk at q_offset 1536 over 2048 keys, and at zamba2-7b's
     heads (H=Hkv=32, dh=112) B=4, S=2048 causal and B=1, S=32 causal
     (fewer rows than a block), at olmoe-1b-7b's (H=Hkv=16, dh=128) B=4,
     S=2048 causal and at whisper-base's encoder (H=Hkv=8, dh=64) B=4,
     1,500 frames non-causal, and at phase E's microbatches of one row
     (qwen2's heads at S=1024, 256 and 2048 causal, Whisper's encoder),
     each in f32, bf16 and bf16 q over f32
     k/v; and dh=32, 64 at small sizes in those and f32 q over bf16 k/v;
     then on the strided views the model passes: q, k, v as ``[B, S,
     heads, dh].transpose(1, 2)`` (qwen2's and zamba2's S=2048 causal,
     phase E's training microbatch),
     the 512-row chunk at q_offset 1536 over a slice of a ``[B, 2056,
     Hkv, dh]`` cache, and zamba2's 32 rows at q_offset 8 over a 40-row
     slice of a 48-row cache, in bf16, f32 (and bf16 q over the f32
     cache), and a bf16 and an f32 q whose base TMA cannot take (copied
     by the wrapper). Each case is held to its route (1, bf16 wgmma, for
     bf16 q over bf16 k/v; 2, 3xTF32 wgmma, otherwise; both fed by TMA)
     by the wrapper's per-route counts. Limits are the JAX package's own,
     5e-5 max abs in f32 and 2e-2 in bf16, and in bf16 also 1e-2
     relative L2 over the whole output;
  S. hold the SSD scan (K5) against its plain version on the card at
     zamba2-7b's H=112, P=64, N=64: B=4 and B=1 at S=2048, a ragged
     S=1000, a 512-step chunk continuing from a carried state (y and
     ``h_final``), and bf16 xh at S=2048, each with the JAX test's draw
     and with zamba2's decay and step ranges: f32 within 1e-4 max abs
     (tests/test_kernels.py:73); bf16 within 1e-2 relative L2, and each
     output its f32 plain value correctly rounded (the 5e-2 of the JAX
     test below |y| = 16, see ``ssd_phase``); plus the model's own dt
     draw, whose y reaches ~10^2, within 1e-5 relative L2;
  C. hold the expert combine (``kernels/moe_combine``: ``moe_combine_fwd``;
     the backward's memset, ``moe_combine_bwd_owner`` and
     ``moe_combine_bwd``) against its plain version (``ref.py``: the
     ``cat``, ``yf[slot]``, product and top-k sum it replaced) on the card
     at olmoe-1b-7b's shapes (``COMBINE_SHAPES``): (i) a training
     microbatch (T 4,096, top-8 of 64 experts at capacity 640: 40,960
     rows of d 2,048, bf16) with none, ~69% and all of the routes
     dropped, phase M's f32 prefill (T 8,192, capacity 1,280) and a
     4-token f32 decode step at capacity factor 8: the output and both
     gradients through autograd, dy bit for bit the plain one's and
     exactly 0 in every row no route owns, out and dw within one
     rounding of the exact (f64) value (plus the f32 sums' own error)
     and within the plain version's roundings of the kernels', dw 0 at
     the trash row, two backwards bit for bit, one launch of each counter
     a call; (ii) at the three training draws, each pass's device time
     beside its bound (the bytes it must move) and the plain version's,
     for the kernels line; (iii) the benchmark's main path: two bf16 train steps of the
     engine at olmoe-1b-7b's widths cut to ``COMBINE_TRAIN``'s 4 layers
     (B=4, S=1,024, M=4, remat, Adam, stash 2, the blend at step 2 held
     by ``checked_blends``), both counters set to 0 before each step and
     read after it: 2 x layers x M forwards (a microbatch's forward and
     its remat replay) and layers x M backwards;
  T. the dense transformer serving path at the full width of qwen2-1.5b
     (28 layers, d=1536, GQA 12:2, dh=128, vocab 151,936; random weights
     from seed 0, prompts from ``SyntheticLM``): (i) prefill through
     ``sequential_lm_forward`` at B=4, S=2048 with K4 against the same
     call on the plain attention path, in f32 (max abs logit difference
     <= 1e-3) and in bf16 (relative L2 <= 2e-2), 28 K4 launches a
     forward (in bf16 all 28 on route 1, in f32 none); (ii) 4 chunks
     of 512 through every slot's ``prefill_chunk`` into a KV cache (112
     K4 launches), then 8 ``sequential_decode_step``s (no K4), each held
     against a flash forward over the same tokens (<= 1e-3); (iii)
     ``ServingEngine``
     (4 slots, cache 128) answers 8 greedy requests, each step's logits
     within 1e-4 of a standalone decode of the same tokens, and its
     tokens the standalone's wherever the top-2 logit gap exceeds 1e-3;
     prefill and decode tokens/s printed;
  Z. the hybrid Mamba2 serving path at the full width of zamba2-7b (81
     layers in 16 stages of a hybrid and 5 mamba slots, d=3584, 32 heads
     of dh=112, d_ff 14,336, vocab 32,000, state 64; 11.0 B parameters,
     random from seed 0; prompts from ``SyntheticLM``): (i) prefill at
     B=4, S=2048 with K4 and K5 against the plain attention and the plain
     scan (swapped in here by ``plain_ssd_scan``), f32 <= 1e-3 max abs
     logit difference, bf16 relative L2 <= 2e-2, 16 K4 (in bf16 all on
     route 1) and 96 K5 launches a forward; (ii) 4 chunks of 512
     through every slot's ``prefill_chunk`` (64 K4, 384 K5 launches),
     then 8 decode steps (no kernel), each within 1e-3 of a kernel
     forward; (iii) B=1, 32 tokens:
     the kernel prefill against 32 decode steps from an empty cache,
     within 1e-3; (iv) ``ServingEngine`` (4 slots, cache 64) answers 6
     greedy requests of 8 new tokens, held as in T (iii), no kernel;
  M. the MoE serving path at the full width of olmoe-1b-7b (16 layers,
     d=2048, 16 heads of 128, 64 experts of d_ff 1024, top-8, capacity
     factor 1.25, vocab 50,304; 6.92 B parameters, random from seed 0):
     (i) prefill at B=4, S=2048 with K4 against the plain attention, in
     f32 and bf16, 16 K4 launches a forward (route 2 in f32, route 1 in
     bf16). The router runs on what K4 touched, so a near-tied token can
     take other experts in the two runs: the routes that differ are
     counted. With none, the logits are held as in T; with some, slot by
     slot (each slot's kernel and plain versions on the same input): the
     router probabilities over every token within ``MOE_PROB_TOL``, and
     the other tokens' updates within 1e-3 max abs (f32) or 2e-2 rel L2
     (bf16), the bf16 forward no farther from plain than from f32, as in
     Z; aux finite; (ii) at capacity factor 8 (nothing dropped) 4 chunks
     of 512 (64 K4 launches) + 8 decode steps within 1e-3 of a kernel
     forward; (iii) ``ServingEngine`` (4 slots, cache 128) answers 8
     requests of 16, held as in T (iii); in each run the expert
     combine's forwards are counted (16 a forward, a chunk, a decode
     step) and no backward;
  X. the xLSTM serving path at the full width of xlstm-125m (12 layers,
     4 stages of (mLSTM, sLSTM, mLSTM), d=768, 4 heads, expand 2): (i)
     prefill at B=4, S=2048 in f32 and bf16, no K4 launch, the sLSTM
     layers' share of a synchronised bf16 forward printed; (ii) 4 chunks
     of 512 + 8 decode steps, each slot's chunk and step outputs within
     1e-3 of its parallel form on the same input, the logits within 1e-2
     of the f32 forward (``XLSTM_WHOLE_MODEL_TOL`` says why); (iii)
     ``ServingEngine`` (4 slots, cache 64) answers 6 requests of 8, held
     as in T (iii) against a standalone decode at batch 4, and the two
     requests admitted into reused slots give a fresh engine's tokens;
  W. the Whisper path at the full width of whisper-base (6 encoder and 6
     decoder layers, d=512, 8 heads of 64, d_ff 2048, vocab 51,865):
     frames [4, 1500, 512] from numpy (seed 0), the decoder over 448
     tokens; (i) ``sequential_encdec_forward`` with K4 against the plain
     attention, f32 <= 1e-3, bf16 rel L2 <= 2e-2, 12 K4 launches a
     forward (6 non-causal over the 1,500 frames, 6 causal over 448;
     cross-attention takes the plain path, as in the JAX package); (ii)
     16 decode steps with ``kv_source`` within 1e-3 of the f32 forward;
  E. the pipeline engine (``repro_torch.pipeline``) on a (data, stage,
     tensor) = (1, 4, 1) ``LocalMesh`` folded onto the card, qwen2-1.5b
     at full width (random weights, seed 0; tokens from ``SyntheticLM``):
     (i) an f32 parity step, B=2, S=256, 2 microbatches, remat: the loss
     within 1e-4 abs and every gradient leaf within 1e-4 relative L2 of
     the sequential forward + cross-entropy, 112 K4 launches on route 2;
     (ii) six bf16 train steps, B=4, S=1,024, 4 microbatches, remat,
     Adam at ``ENGINE_TRAIN_LR`` on one repeated batch, stash depth 2,
     blend every 2: losses finite, the mean of the last two below the
     first, the stash after step 1 the initial params bit for bit, at
     steps 2, 4, 6 the blend's last stage the new params and its earlier
     stages an independent 0.5 blend bit for bit (``checked_blends``),
     224 K4 launches a step, all on route 1; step ms, tokens/s and peak
     memory printed; (iii) pipelined prefill, 4 microbatches, bf16 at
     B=4, S=2048 (the last position's logits within 2e-2 rel L2 of the
     sequential kernel forward, 112 K4 launches on route 1) and f32 at
     S=512 (1e-3); (iv) chunked prefill in 4 chunks into f32 caches and
     8 serve steps, each within 1e-3 of the sequential forward /
     ``sequential_decode_step`` on the same caches (112 K4 launches, then
     none); (vi) a re-pack of the stacked slots at 10 slots a stage,
     [7, 7, 7, 7] -> [8, 8, 6, 6] -> stage 2 lost, the logits within
     2e-5 (measured 0) and the redistribution bytes printed; (v)
     whisper-base at full width on (1, 2, 1), 3 f32 train steps, B=2, 2
     microbatches, the first loss within 1e-4 of
     ``sequential_encdec_forward``'s, 48 K4 launches a step, then 8 serve
     steps with ``kv_source`` within 1e-3 of ``sequential_decode_step``;
     (vii) ``python -m repro_torch.launch.train --debug-mesh 1,2,1
     --steps 50 --lr 0.005 --ckpt-dir DIR`` (exit 0, "improved", a
     checkpoint ``CheckpointStore.restore_latest`` reads back) and
     ``python -m repro_torch.launch.serve`` (exit 0), as subprocesses
     with a bounded wait;
  D. the launch tooling (``compat``, ``launch/{analysis,cost_model,
     specs,dryrun}.py``) on phase E's model and steps: (i) phase E's bf16
     train step (B=4, S=1,024, M=4, remat, Adam) run once under
     ``compat.cost_analysis`` on the card (K4 counted as its plain
     version) and the same step traced on meta through ``dryrun``'s
     ``trace_step``: the two FLOP counts equal, and per device (over the
     4 folded stages) within 35% of ``cost_model.flops_per_device`` with
     D=1, B_loc=4, M=4, mb=1, S=4, Tp=1, ticks=M; the same for phase E's
     pipelined bf16 prefill (B=4, S=2,048, M=4); (ii) a ``{"roofline":
     ...}`` line: the card's name and power limit, phase E's median step
     and prefill ms, the counted FLOPs, ``model_flops``, the cost model's
     terms on the H100 constants (the card does all 4 devices' work),
     ``mfu`` = model FLOPs / (step s x 989.4e12), the counted FLOPs'
     share of that peak, and the roofline bound over the measured step;
     (iii) ``python -m repro_torch.launch.dryrun --arch qwen2-1.5b
     --shape train_4k`` and ``--arch zamba2-7b --shape prefill_32k --set
     use_flash_attention=1`` as subprocesses with a bounded wait: exit 0,
     a report with the JAX report's keys, a per-device argument byte
     count, and the traced FLOPs per device within 35% of the analytic
     count at ticks = M;
  R. the pipeline engine over real ranks (``pipeline/ranks.RankPool``:
     one spawned process a mesh position, a ``FileStore`` rendezvous,
     bounded waits) at qwen2-1.5b's full width, ``RANK_LAYERS`` of its 28
     layers (the depth cut so that phase G fits the time limit): (i) one
     rank over NCCL, 2 bf16 Adam steps (B=4, S=1,024, M=4, remat, stash
     2, blend every 2) of the rank engine, then of the folded engine on
     the same config, draw and batch in that process (the parent holds
     no model): the same losses and every state leaf equal bit for bit,
     2 x layers x M K4 launches a step on route 1; (ii) two ranks sharing the card over gloo (NCCL
     puts no two ranks on one GPU), on (1, 1, 2) (a real tensor axis: K4
     at H=6, Hkv=1) and (1, 2, 1) (the stage hand-off between
     processes): the bf16 pipelined prefill (B=4, S=2,048, M=4) against
     the folded engine within phase E's 2e-2 rel (L2), the train
     batch's f32 loss and every f32 gradient leaf (each rank's shards
     handed over the pool's pipe and put together) within phase E (i)'s
     1e-4 (abs; rel L2), its bf16 loss within 2e-2 and every bf16
     gradient leaf no farther from the f32 one than twice the folded
     engine's bf16 leaf, 3 timed bf16 Adam steps (stash 2, the blend
     at step 2) whose losses are within 2e-2 of the folded engine's and
     whose final state, put together from the ranks' shards, is the
     folded engine's (params and stash element by element within the
     drift two Adam runs allow, ``ADAM_STEP_MAX``; the moments' largest
     error, over the largest value, within twice the bf16 gradients'
     (v four times); the counts equal), every rank's K4
     launches exact (n_local x M prefill, 2 n_local x M a step, route 1
     in bf16, route 2 in f32), the
     send/recv bytes staged through the host printed (none on (1, 1, 2)),
     each rank's peak; (iii) ``torchrun --nproc-per-node 1 -m
     repro_torch.launch.train --debug-mesh 1,1,1 --steps 20`` (exit 0,
     an NCCL rank, "improved"); a ``{"slice_ranks": ...}`` line;
  G. the thirteen examples of ``examples_torch/`` as a user starts them,
     with no flags (train_e2e at its default width with ``--steps 100``,
     its first checkpoint, which ``CheckpointStore.restore_latest`` reads
     back: step 100, finite, trained), each within ``EXAMPLE_TIMEOUT``:
     the simulator demos, the LM examples and the two queue demos through
     their ``main`` in this process, where every kernel's launches are
     counted around the call; the TCP, compressed-wire, rejoin,
     coordinator-failover and fleet demos as subprocesses (they start
     processes of their own), which print their own process's K1-K3
     launches. Each returns 0, ends with its own verdict line, and
     launches each kernel within ``G_LAUNCHES`` (worked out from the code
     before the first run; K4 and K5 none). An ``{"examples": ...}`` line:
     each example's wall s, return code, launches and headline figures
     (bytes ratios, recovery s, first and last loss, tokens/s, parameter
     count);
  4. K1 again at every stage-slice size the run used, then each kernel's
     time beside its bound, its plain version's and, where one PyTorch
     call computes the same function, that call's (K1:
     ``torch.optim.SGD(fused=True)``; K4:
     ``F.scaled_dot_product_attention``, given the window's and the
     query offset's boolean mask where it has them, and held against the
     plain version first; K3: ``torch.addcmul(lo, scale, q)``, held
     within 2 spacings of ``max(|out|, |lo|)`` of the plain version first,
     as it may contract into an FMA; yardsticks the port never calls; no
     single PyTorch call computes K2 or K5), and for K2 and K3 the
     wrapper's host time a call (1,000 calls, no sync). K4 is timed in bf16 (route 1)
     at every phase-A shape, and in f32 (route 2) at the nine shapes the
     serving paths and the engine launch it at (qwen2's top shape and its
     512-row chunk at q_offset 1536, zamba2's top shape, its last 512-row
     chunk over the 2,056-row cache, its B=1, S=32 prefill, olmoe's
     prefill, Whisper's encoder, and phase E's one-row parity and
     Whisper encoder microbatches) beside the library call
     in f32 with TF32 off, each beside its f32 (CUDA-core) and 3xTF32
     (tensor-core) bound.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit (``nvidia-smi``), and
``{"ok": true, "device": {...}}``. Needs one CUDA GPU and ``nvcc``; exits
non-zero without them, or when ``src/repro_torch`` is not beside it.
"""
import concurrent.futures
import contextlib
import ctypes
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM, bf16 on the tensor cores, dense
TF32_FLOPS_PER_S = 495e12     # H100 SXM, tf32 on the tensor cores, dense
FLASH_TOL = {"float32": 5e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:31
# bf16 over the whole output as well: at S=2048 a causal row's values are
# ~0.03-0.05, so 2e-2 max abs alone would let a fault in long rows pass
FLASH_BF16_REL_L2 = 1e-2
# K5: tests/test_kernels.py:73 (1e-4 f32, 5e-2 bf16, which phase S holds
# as "correctly rounded", see ssd_phase), and phase A's bf16 relative L2
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SSD_BF16_REL_L2 = 1e-2
# the "model" draw of phase S (y up to ~10^2): relative L2 only
SSD_MODEL_REL_L2 = 1e-5
ZAMBA2_PARAMETERS = 11_003_722_752     # jax.eval_shape of the JAX init
OLMOE_PARAMETERS = 6_919_096_320       # the same, at tensor_parallel=1
XLSTM_PARAMETERS = 183_635_744
WHISPER_PARAMETERS = 97_287_168
# phase M: the largest |router probability difference| between the kernel
# and the plain slot on the same input (f32: the attention's rounding,
# ~1e-8; bf16: one bf16 spacing of the router's input moves a logit by
# ~1e-2 at most)
MOE_PROB_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
WHISPER_DECODE_STEPS = 16
# phase X. At random weights an mLSTM slot amplifies rounding ~500x (its
# group norm rescales rows whose spread differs 8,000x;
# tests/test_torch_xlstm.py), so two computations of the same logits in
# another order (a batch of 1 and of 4, the chunk and the parallel form)
# land up to ~2e-3 apart over 12 layers, by an amount that varies from
# one run to the next (0.76-0.91e-3 and 0.86-2.06e-3 measured). So the
# engine is held against a standalone decode at its own batch shape
# (every xLSTM operation is row-independent), and chunked prefill +
# decode slot by slot on the same input (``slot_chunk_updates``), each
# within the other phases' limits; the whole model within 1e-2, a
# fault's size (a lost carry moves it by O(0.1))
XLSTM_WHOLE_MODEL_TOL = 1e-2
PREFILL_B, PREFILL_S, CHUNK, DECODE_STEPS = 4, 2048, 512, 8
LR, MOMENTUM, WEIGHT_DECAY = 0.005, 0.9, 4e-5
NUM_BATCHES, KILL = 30, (1, 12)
FUSED_LOSS_TOL, FUSED_BYTES_RATIO = 0.05, 0.6
HISTORY_ATTEMPTS = 8          # phase F: runs to find one shared history


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def free_card(torch):
    """Release a finished phase's tensors: objects in reference cycles
    (a phase's closures and engine subclass) wait for the cycle collector,
    which may not have run when the next phase allocates its model."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sgd_inputs(n, seed, torch):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, generator=gen, device="cuda") for _ in range(3)]


def kernel_vs_plain(n, seed, torch, ops, ref):
    """Max |kernel - plain| over p' and m' (0.0 when bit-identical)."""
    p, g, m = sgd_inputs(n, seed, torch)
    kw = dict(lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)
    po, mo = ops.fused_sgd(p, g, m, **kw)
    pr, mr = ref.sgd_reference(p, g, m, **kw)
    torch.cuda.synchronize()
    same = torch.equal(po, pr) and torch.equal(mo, mr)
    diff = max((po - pr).abs().max().item(), (mo - mr).abs().max().item())
    check(same, f"fused_sgd differs from its plain version at n={n} "
                f"(max abs diff {diff})")
    return diff


def time_ms(fn, torch, reps=30, clean=False):
    """Median device time of one call, with the L2 cache flushed before
    each (a stage's update finds its buffers cold after fwd/bwd): a 256 MB
    buffer is written, which leaves the L2 full of dirty lines that the
    call's own traffic then writes back. ``clean``: the buffer is read
    instead, which leaves the L2 clean, so the call moves its own bytes
    only. Either flush runs three times (~0.3 ms of device work) so that
    the host has enqueued the call's launches before the device reaches
    the first event: the time is the device's, not the wrapper's (a
    wrapper's host time a call is ``host_ms``)."""
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        for _ in range(3):
            if clean:
                flush.sum()
            else:
                flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timings(n, torch, ops, ref):
    p, g, m = sgd_inputs(n, 7, torch)
    kw = dict(lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)
    out = {"n": n,
           "ms": time_ms(lambda: ops.fused_sgd(p, g, m, **kw), torch),
           "plain_ms": time_ms(lambda: ref.sgd_reference(p, g, m, **kw),
                               torch)}
    # bytes: p, g, m read once, p', m' written once; 6 flops per element
    out["bound_ms"] = 1e3 * max(20 * n / HBM_BYTES_PER_S,
                                6 * n / F32_FLOPS_PER_S)
    out["bound_by"] = ("bytes" if 20 * n / HBM_BYTES_PER_S
                       >= 6 * n / F32_FLOPS_PER_S else "operations")
    try:
        w = torch.nn.Parameter(p.clone())
        w.grad = g.clone()
        opt = torch.optim.SGD([w], lr=LR, momentum=MOMENTUM,
                              weight_decay=WEIGHT_DECAY, fused=True)
        opt.step()                     # creates the momentum buffer
        out["library_ms"] = time_ms(opt.step, torch)
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"library yardstick unavailable: {e}")
        out["library_ms"] = None
    return out


# ------------------------------ quant (K2, K3) ---------------------------

def same(a, b, torch):
    """Equal values (``torch.equal``, for which -0.0 == +0.0) and NaN at
    the same places (``torch.equal`` alone finds NaN unequal to itself,
    and the card's NaN payload may differ from the CPU's)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def abs_err(a, b):
    d = (a.double() - b.double()).abs()
    d = d[~d.isnan()]
    return d.max().item() if d.numel() else 0.0


def quant_inputs(rows, C, seed, with_res, torch):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 3.0 * torch.randn(rows, C, generator=gen, device="cuda")
    res = (0.01 * torch.randn(rows, C, generator=gen, device="cuda")
           if with_res else None)
    return x, res


def quant_vs_plain(x, res, levels, what, torch, qops, qref):
    """K2 (with z written, and without, as the live runtime calls it) and
    K3 against their plain versions on the same inputs; checks the EF
    invariant on the card. Returns (max |kernel - plain|, ok)."""
    got = qops.quantize_ef(x, res, levels=levels)
    lean = qops.quantize_ef(x, res, levels=levels, with_z=False)
    want = qref.quantize_ef_reference(x, res, levels=levels)
    torch.cuda.synchronize()
    names = ("q", "lo", "scale", "res'", "ok", "z")
    ok = bool(want[4])
    check(bool(got[4]) == ok and bool(lean[4]) == ok and lean[5] is None,
          f"quantize_ef ok differs at {what}")
    # codes of a non-finite tensor are never shipped: compare ok and z
    pairs = (list(zip(names, got, want)) + list(zip(names[:4], lean, want))
             if ok else [("z", got[5], want[5])])
    err = 0.0
    for name, a, b in pairs:
        check(same(a, b, torch), f"quantize_ef {name} differs from its "
                                 f"plain version at {what}")
        err = max(err, abs_err(a, b))
    if ok:
        q, lo, scale, res2, _, z = got
        dq = qops.dequantize(q, lo, scale)
        dq_plain = qref.dequantize_reference(q, lo, scale)
        torch.cuda.synchronize()
        check(same(dq, dq_plain, torch),
              f"dequantize differs from its plain version at {what}")
        check(torch.equal(res2, z - dq),
              f"EF invariant res' == z - dequantize(q) broken at {what}")
        err = max(err, abs_err(dq, dq_plain))
    return err, ok


def boundary_shapes(chain, batch, torch):
    """[rows, C] of every stage boundary a partition can cut (the output
    of each layer but the last), at the run's batch size."""
    shapes, x = [], chain.input_of(batch)
    with torch.no_grad():
        for j in range(chain.num_layers - 1):
            x = chain.apply_layer(j, chain.params[j], x)
            shapes.append((math.prod(x.shape[:-1]), x.shape[-1]))
    return sorted(set(shapes), reverse=True)


def quant_phase(shapes, torch, qops, qref):
    """Returns the max |kernel - plain| over every case checked."""
    cases = [(rows, C, 255, with_res) for rows, C in shapes
             for with_res in (False, True)]
    cases += [(rows, C, 4, with_res) for rows, C in ((1, 1), (7, 33))
              for with_res in (False, True)]
    # more channels than K2 keeps keys for on chip (one block, keys in
    # device memory), odd, so every pointer has a head and a tail
    cases += [(129, 9001, 255, True)]
    err, branches = 0.0, set()
    for rows, C, levels, with_res in cases:
        x, res = quant_inputs(rows, C, rows + C, with_res, torch)
        branches.add(qops.quantize_plan(x, res).z_on_chip)
        e, ok = quant_vs_plain(x, res, levels, f"[{rows}, {C}] levels="
                               f"{levels} res={with_res}", torch, qops, qref)
        check(ok, f"finite input [{rows}, {C}] reported not ok")
        err = max(err, e)
    # constant and all-zero channels round-trip exactly
    x, _ = quant_inputs(4096, 24, 9, False, torch)
    x[:, 0::3] = 0.0
    x[:, 1::3] = -1.75
    err = max(err, quant_vs_plain(x, None, 255, "constant channels", torch,
                                  qops, qref)[0])
    q, lo, scale, res2, _, _ = qops.quantize_ef(x)
    dq = qops.dequantize(q, lo, scale)
    flat = torch.zeros(24, dtype=torch.bool, device="cuda")
    flat[0::3] = flat[1::3] = True
    check(torch.all(scale[flat] == 0) and torch.equal(dq[:, flat], x[:, flat])
          and torch.all(res2[:, flat] == 0),
          "constant channels do not round-trip exactly")
    # non-finite values in x or in res force the exact fallback
    for where, bad in (("x", float("nan")), ("x", float("inf")),
                       ("res", float("inf")), ("res", float("nan"))):
        x, res = quant_inputs(1024, 160, 11, True, torch)
        (x if where == "x" else res)[17, 5] = bad
        e, ok = quant_vs_plain(x, res, 255, f"{bad} in {where}", torch,
                               qops, qref)
        check(not ok, f"quantize_ef ok with {bad} in {where}")
        err = max(err, e)
    # x one element past a 16-byte boundary (res aligned, so read 4 bytes
    # at a time), with and without a residual
    for (rows, C), with_res in ((shapes[0], True), (shapes[-1], False)):
        x, res = quant_inputs(rows, C, 12, with_res, torch)
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, C)
        check(x.data_ptr() % 16 == 4, "the shifted x is not 4 bytes past "
                                      "a 16-byte boundary")
        err = max(err, quant_vs_plain(x, res, 255, f"x at +4 bytes [{rows}, "
                                      f"{C}] res={with_res}", torch, qops,
                                      qref)[0])
    # a shape whose z does not fit on chip: x and res read again
    x, res = quant_inputs(1_048_576, 32, 13, True, torch)
    plan = qops.quantize_plan(x, res)
    branches.add(plan.z_on_chip)
    check(not plan.z_on_chip, "[1048576, 32] planned with z on chip")
    err = max(err, quant_vs_plain(x, res, 255, "[1048576, 32] (z re-read)",
                                  torch, qops, qref)[0])
    check(branches == {True, False}, f"phase Q ran the z-on-chip branches "
                                     f"{branches} only")
    del x, res
    # K3 on the code view the receiving stage builds (one host->device
    # copy of lo | scale | codes; codes at byte offset 8C)
    from repro_torch.runtime.qtensor import DeviceQuantized
    from repro_torch.runtime.stage_executor import StageExecutor
    heads = {}
    for C in (7, 33, 32):
        x, _ = quant_inputs(4099, C, 14 + C, False, torch)
        q, lo, scale, *_ = qops.quantize_ef(x)
        wire = DeviceQuantized.from_arrays(q, lo, scale)
        dq_q, dq_lo, dq_scale = StageExecutor._device_triple(
            types.SimpleNamespace(device=torch.device("cuda")), wire)
        heads[C] = qops.dequantize_plan(dq_q).head
        got = qops.dequantize(dq_q, dq_lo, dq_scale)
        want = qref.dequantize_reference(dq_q, dq_lo, dq_scale)
        torch.cuda.synchronize()
        check(same(got, want, torch), f"dequantize differs from its plain "
                                      f"version on the code view, C={C}")
        check(torch.equal(got, qops.dequantize(q, lo, scale)),
              f"the code view decodes differently, C={C}")
    check(heads == {7: 8, 33: 8, 32: 0}, f"code-view heads {heads}")
    log(f"quantize_ef and dequantize bit-identical to plain over "
        f"{len(cases) + 11} cases (boundaries {shapes}; z kept on chip and "
        f"re-read; x at +4 bytes; K3 on the code view, heads {heads}); EF "
        f"invariant exact")
    return err


def quant_timings(rows, C, torch, qops, qref):
    """K2 (with a carried residual and without z, as on the main path
    after its first batch) and K3 at one boundary shape: device times
    beside the bound."""
    x, res = quant_inputs(rows, C, 7, True, torch)
    q, lo, scale, *_ = qops.quantize_ef(x, res)
    n = rows * C

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    # K2 reads x, res; writes q (1 byte), res' and lo, scale; about 12
    # f32 operations an element (add, min, max, sub, div, rint, 2 clamps,
    # mul, add, sub, finite test)
    k2_ms, k2_by = bound(13 * n + 8 * C, 12 * n)
    # K3 reads q, lo, scale; writes the f32 tensor; 3 operations (cvt,
    # mul, add)
    k3_ms, k3_by = bound(5 * n + 8 * C, 3 * n)
    # the yardstick computes K3's function, rounding once where it fuses
    lib = torch.addcmul(lo, scale, q)
    plain = qref.dequantize_reference(q, lo, scale)
    torch.cuda.synchronize()
    tol = 2 * torch.maximum(plain.abs(), lo.abs()).nextafter(
        torch.tensor(float("inf"), device="cuda")).sub(
        torch.maximum(plain.abs(), lo.abs()))
    check(bool(((lib - plain).abs() <= tol).all()),
          f"torch.addcmul(lo, scale, q) is not K3's function at "
          f"[{rows}, {C}]")
    k2 = lambda: qops.quantize_ef(x, res, with_z=False)      # noqa: E731
    k3 = lambda: qops.dequantize(q, lo, scale)                # noqa: E731
    return (
        {"rows": rows, "C": C, "ms": time_ms(k2, torch),
         "plain_ms": time_ms(lambda: qref.quantize_ef_reference(x, res),
                             torch),
         "bound_ms": k2_ms, "bound_by": k2_by, "host_ms": host_ms(k2, torch),
         "z_on_chip": qops.quantize_plan(x, res).z_on_chip},
        {"rows": rows, "C": C, "ms": time_ms(k3, torch),
         "plain_ms": time_ms(lambda: qref.dequantize_reference(q, lo, scale),
                             torch),
         "library_ms": time_ms(lambda: torch.addcmul(lo, scale, q), torch),
         "bound_ms": k3_ms, "bound_by": k3_by, "host_ms": host_ms(k3, torch)})


def host_ms(fn, torch, calls=1000):
    """Host wall time of one call: ``calls`` calls with no sync between
    them, over ``calls`` (the device keeps up, so this is the wrapper's
    own time to launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def ptxas_lines(lib):
    """(kernel, what ptxas says) for each entry of a built library."""
    name, out = "?", []
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def stage_sizes(layout, points):
    sizes, a = [], 0
    for e in points:
        sizes.append(sum(layout.layer_size(j) for j in range(a, int(e) + 1)))
        a = int(e) + 1
    return sizes


def cross_device_checks(torch):
    """The port on the card against the port on the CPU (f32, no TF32)."""
    from repro_torch.runtime import stage_executor as se
    from repro_torch.runtime.workload import WorkloadSpec
    spec = WorkloadSpec(kind="mobilenet", image_hw=32, batch_size=4, seed=1)
    gpu_chain, gpu_batches = spec.build(device="cuda")
    cpu_chain, cpu_batches = spec.build(device="cpu")

    def loss_and_dx(chain, batch):
        x = batch["x"].clone().requires_grad_(True)
        loss = chain.loss_fn(chain.params, {"x": x,
                                            "labels": batch["labels"]})
        (dx,) = torch.autograd.grad(loss, x)
        return loss.item(), dx.cpu()

    lg, dg = loss_and_dx(gpu_chain, gpu_batches[0])
    lc, dc = loss_and_dx(cpu_chain, cpu_batches[0])
    rel = ((dg - dc).norm() / dc.norm()).item()
    log(f"chain loss cuda {lg:.6f} cpu {lc:.6f}; input-grad rel L2 {rel:.2e}")
    # rtol 1e-4 on the loss; rel L2 3e-2 on the 19-layer input gradient,
    # which is ill-conditioned in f32 at init (tests/test_torch_mobilenet)
    check(abs(lg - lc) <= 1e-4 * abs(lc), "chain loss cuda vs cpu")
    check(rel < 3e-2, "chain input gradient cuda vs cpu")

    sl, buf = gpu_chain.flat_slice(2, 4)
    ex = {c: se.StageExecutor(gpu_chain, sl, last=False, lr=LR,
                              momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                              compiled=c, device="cuda") for c in (True, False)}
    x = gpu_batches[1]["x"]
    x = gpu_chain.apply_layer(1, gpu_chain.params[1],
                              gpu_chain.apply_layer(0, gpu_chain.params[0], x))
    st = {c: (buf, sl.zeros()) for c in ex}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(3):
        y = ex[True].forward(st[True][0], x)
        ct = torch.randn(y.shape, generator=gen, device="cuda") / y.numel()
        for c in ex:
            _, p, m = ex[c].step(st[c][0], st[c][0], st[c][1], x, ct)
            st[c] = (p, m)
    torch.cuda.synchronize()
    dp = (st[True][0] - st[False][0]).abs().max().item()
    dm = (st[True][1] - st[False][1]).abs().max().item()
    log(f"StageExecutor kernel vs plain path, 3 steps: max |dp| {dp:.2e} "
        f"max |dm| {dm:.2e}")
    # same device, same autograd; the paths differ only in how the
    # gradient is gathered (flat buffer vs per leaf): f32 rounding
    check(dp <= 1e-4 and dm <= 1e-4, "StageExecutor kernel vs plain path")


def implied_launches(res, per_batch):
    """Launches the committed batches imply: each ran the partition in
    force at it (``partitions`` is in order of from-batch), which takes
    ``per_batch(stages)`` launches; batches re-run after the recovery
    add more."""
    return sum(per_batch(len([pts for b0, pts in res.partitions
                              if b0 <= b][-1])) for b in range(NUM_BATCHES))


def live_spec():
    """The main path's workload: MobileNetV2-CIFAR, 32x32, batch 64."""
    from repro_torch.runtime.workload import WorkloadSpec
    return WorkloadSpec(kind="mobilenet", image_hw=32, batch_size=64, seed=0)


def live_config(tier=None, profile=None, kill=KILL):
    """The main path's ``LiveConfig``: 3 workers with spec capacities (1, 1,
    4), ``kill``; with ``tier`` None the default data plane and the run's
    own measured profile, else every payload through the wire codec on
    ``tier`` and the partitions from ``profile``."""
    from repro_torch.runtime.devices import DeviceSpec, uniform_bandwidth
    from repro_torch.runtime.live import LiveConfig
    from repro_torch.runtime.protocol import ProtocolConfig
    wire = ({} if tier is None else
            dict(profile=profile, wire_codec=True, wire_compress=tier,
                 wire_compress_replica="off"))
    return LiveConfig(
        num_workers=3, num_batches=NUM_BATCHES,
        protocol=ProtocolConfig(chain_every=10, global_every=20,
                                repartition_first_at=5, repartition_every=15,
                                detect_timeout=3.0),
        lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
        device_specs=[DeviceSpec("central", 1.0), DeviceSpec("peer", 1.0),
                      DeviceSpec("slow", 4.0)],
        bandwidth=uniform_bandwidth(3, 1e9), capacity_source="spec",
        kill=kill, segment_timeout=120.0, device="cuda", **wire)


def live_run(torch, counters, tier=None, profile=None):
    """``run_live_training`` of MobileNetV2-CIFAR on the card. With
    ``tier`` None, on the default data plane (device tensors handed
    between the workers, no codec) and the run's own measured profile;
    else every payload goes through the wire codec on ``tier``, and the
    partitions come from the given layer ``profile``. The launch counts in
    ``counters`` are set to 0 just before the run and read just after."""
    from repro_torch.runtime.live import run_live_training
    chain, batches = live_spec().build(device="cuda")
    cfg = live_config(tier, profile)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_live_training(chain, batches, cfg)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for t, text in res.events:
        log(f"  event {t:8.3f}s {text}")
    losses = [float(v) for v in res.losses]

    first5 = statistics.mean(losses[:5])
    last5 = statistics.mean(losses[-5:])
    repartitions = sum("re-partition" in text for _, text in res.events)
    kb = res.transport_stats["kind_bytes"]
    summary = {
        "workload": "mobilenetv2-cifar 32x32 batch 64, 19 layers, 3 workers",
        "wire": "default (no codec)" if tier is None else f"codec {tier}",
        "batches": NUM_BATCHES, "wall_s": wall,
        "batches_per_s": NUM_BATCHES / wall,
        "committed": sorted(res.commit_times) == list(range(NUM_BATCHES)),
        "all_finite": all(v == v and abs(v) != float("inf") for v in losses),
        "loss_first5": first5, "loss_last5": last5,
        "recoveries": len(res.recoveries), "repartitions": repartitions,
        "partitions": [[int(b), [int(p) for p in pts]]
                       for b, pts in res.partitions],
        "act_bytes": kb["act"], "grad_bytes": kb["grad"],
        "restart": [int(r["restart"]) for r in res.recoveries],
        "losses": losses,
        "launches": launches,
        "backwards_lower_bound": implied_launches(res, lambda s: s),
    }
    print(json.dumps({"slice": summary}), flush=True)
    check(summary["committed"], "not every batch committed")
    check(summary["all_finite"], "non-finite loss")
    check(last5 < first5, f"loss did not decrease ({first5} -> {last5})")
    check(len(res.recoveries) == 1, f"{len(res.recoveries)} recoveries")
    check(repartitions >= 1, "no re-partition")
    backwards = summary["backwards_lower_bound"]
    check(launches["fused_sgd"] >= backwards,
          f"fused_sgd launched {launches['fused_sgd']} times for >= "
          f"{backwards} backwards")
    return res, summary


def fused_phase(torch, counters, probe, probe_batch):
    """Phase F: the exact and the int8-fused tier through the codec, on
    one measured profile and with deterministic convolution backwards
    (cuDNN's default algorithms make two runs' losses differ by
    rounding), so that the two runs differ only by their wire tier. A
    third run, exact again but on cuDNN's default algorithms, shows how
    far rounding alone moves the losses. Returns the results of the runs
    and the fused run's summary."""
    probe.measure_profile(probe_batch, repeats=2)            # warm-up
    profile = probe.measure_profile(probe_batch, repeats=2)
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        off_res, off = live_run(torch, counters, "off", profile)
        check(off["launches"]["quantize_ef"] == off["launches"]["dequantize"]
              == 0, "the off tier launched a quant kernel")
        res, fused = live_run(torch, counters, "int8-fused", profile)
        # where the kill's detection lands sets the restart batch (the last
        # committed + 1), so two runs can take two histories. The fused run
        # (and every third time the off run) is run again until the two
        # share one; the comparison below fails if the last two do not
        for attempt in range(2, HISTORY_ATTEMPTS + 1):
            if all(fused[k] == off[k] for k in ("partitions", "restart")):
                break
            log(f"attempt {attempt - 1}: the int8-fused and off runs took "
                f"different histories ({fused['partitions']} restart "
                f"{fused['restart']} vs {off['partitions']} restart "
                f"{off['restart']}); running the "
                + ("off run" if attempt % 3 == 0 else "int8-fused run")
                + " again")
            if attempt % 3 == 0:
                off_res, off = live_run(torch, counters, "off", profile)
                check(off["launches"]["quantize_ef"]
                      == off["launches"]["dequantize"] == 0,
                      "the off tier launched a quant kernel")
            else:
                res, fused = live_run(torch, counters, "int8-fused", profile)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    noisy_res, noisy = live_run(torch, counters, "off", profile)
    launches = fused["launches"]
    # after the kill, losses are comparable only along the same history:
    # the same partitions, resumed at the same batch
    for key in ("partitions", "restart"):
        check(fused[key] == off[key],
              f"the int8-fused and off runs differ in {key} ({fused[key]} "
              f"vs {off[key]}): their losses after the kill are not "
              f"comparable")
    diffs = [abs(a - b) for a, b in zip(fused["losses"], off["losses"])]
    # Per batch, the limit holds up to the kill: a failure-free run, the
    # setting of the JAX package's own check of this tier. Over the whole
    # run the two trajectories drift apart like any two nearby ones (see
    # the witness below), so there the training outcome is compared: the
    # mean loss of the last 5 batches.
    pre_kill = max(diffs[:KILL[1]])
    last5 = abs(fused["loss_last5"] - off["loss_last5"])
    ratio = ((fused["act_bytes"] + fused["grad_bytes"])
             / (off["act_bytes"] + off["grad_bytes"]))
    log(f"int8-fused vs off: max |loss diff| {pre_kill:.3g} before the "
        f"kill, {max(diffs):.3g} over the run; last-5 mean diff "
        f"{last5:.3g}; act+grad bytes ratio {ratio:.4f}; launches "
        f"{launches}")
    # witness of how far two exact runs drift apart from rounding alone
    # (where they took the same history)
    same = all(noisy[k] == off[k] for k in ("partitions", "restart"))
    witness = (max(abs(a - b) for a, b in zip(noisy["losses"], off["losses"]))
               if same else None)
    log("off on cuDNN's default algorithms vs off deterministic: "
        + (f"same history, max |loss diff| {witness:.3g}" if same else
           f"different histories ({noisy['partitions']} restart "
           f"{noisy['restart']}), no witness"))
    check(pre_kill <= FUSED_LOSS_TOL,
          f"int8-fused losses {pre_kill} from the off tier's before the "
          f"kill (> {FUSED_LOSS_TOL})")
    check(last5 <= FUSED_LOSS_TOL,
          f"int8-fused last-5 mean loss {last5} from the off tier's (> "
          f"{FUSED_LOSS_TOL})")
    check(ratio < FUSED_BYTES_RATIO,
          f"int8-fused act+grad bytes {ratio:.3f}x the off tier's")
    # per committed batch and stage boundary: K2 twice (act out, grad
    # out), K3 three times (act in, its recompute in the backward, grad in)
    for name, k in (("quantize_ef", 2), ("dequantize", 3)):
        need = implied_launches(res, lambda s: k * (s - 1))
        check(launches[name] > 0 and launches[name] >= need,
              f"{name} launched {launches[name]} times on the main path, "
              f"for >= {need} implied by its partitions")
    fused.update(max_loss_diff_vs_off_before_kill=pre_kill,
                 max_loss_diff_vs_off=max(diffs),
                 last5_loss_diff_vs_off=last5, act_grad_bytes_ratio=ratio,
                 max_loss_diff_off_nondeterministic_vs_off=witness)
    print(json.dumps({"fused_vs_off": {
        k: fused[k] for k in ("max_loss_diff_vs_off_before_kill",
                              "max_loss_diff_vs_off",
                              "last5_loss_diff_vs_off",
                              "act_grad_bytes_ratio",
                              "max_loss_diff_off_nondeterministic_vs_off")}}),
          flush=True)
    return (off_res, res, noisy_res), fused, profile


# ---------------------- the live runtime over TCP (P, L) -------------------

def tcp_config(profile, transport, kill):
    """Phase F's int8-fused run as a ``RunConfig``: its workload, profile,
    spec capacities, cadences and wire tier, on ``transport``."""
    from repro_torch.run import RunConfig
    return RunConfig(workload=live_spec(),
                     live=live_config("int8-fused", profile, kill),
                     transport=transport)


def run_facade(cfg, counters=None):
    """``Run(cfg)`` to its end (bounded), with the launch counts in
    ``counters`` set to 0 just before and read just after. Returns
    (result, wall s, launches)."""
    from repro_torch.run import Run
    for fn in (counters or {}).values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = Run(cfg).start().wait(timeout=900)
    wall = time.perf_counter() - t0
    return res, wall, {n: fn.launches for n, fn in (counters or {}).items()}


def points(res):
    return [[int(p) for p in pts] for _, pts in res.partitions]


def tcp_phase(torch, counters, profile, fused_res, fused):
    """Phase P: the main path over TCP through the ``Run`` facade, on phase
    F's int8-fused settings and deterministic cuDNN (the worker processes
    get these settings from ``run_tcp_training``). Worker 1 SIGKILLs
    itself at batch 12; then a failure-free TCP run is held against a
    queue run of the same config."""
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        res, wall, launches = run_facade(tcp_config(profile, "tcp", KILL),
                                         counters)
        for t, text in res.events:
            log(f"  event {t:8.3f}s {text}")
        losses = [float(v) for v in res.losses]
        check(res.worker_exitcodes == {1: -9, 2: 0},
              f"tcp worker exit codes {res.worker_exitcodes}, want "
              f"{{1: -9, 2: 0}}")
        check(sorted(res.commit_times) == list(range(NUM_BATCHES)),
              "tcp: not every batch committed")
        check(all(math.isfinite(v) for v in losses), "tcp: non-finite loss")
        first5, last5 = statistics.mean(losses[:5]), statistics.mean(
            losses[-5:])
        check(last5 < first5, f"tcp: loss did not decrease ({first5} -> "
                              f"{last5})")
        check(len(res.recoveries) == 1
              and res.recoveries[0]["failed"] == [KILL[0]],
              f"tcp: recoveries {res.recoveries}")
        repartitions = sum("re-partition" in text for _, text in res.events)
        check(repartitions >= 1, "tcp: no re-partition")
        check(points(res) == points(fused_res),
              f"tcp partitions {points(res)} differ from phase F's "
              f"int8-fused run's {points(fused_res)}")
        check([int(p) for p in res.recoveries[0]["partition"]]
              == [int(p) for p in fused_res.recoveries[0]["partition"]],
              "tcp recovery partition differs from phase F's")
        # worker 0 (stage 0) runs in this process: one K1 (its backward),
        # one K2 (its act out) and one K3 (the grad in) a batch at least
        for name, n in launches.items():
            check(n >= NUM_BATCHES,
                  f"tcp: {name} launched {n} times in the coordinator "
                  f"process for {NUM_BATCHES} committed batches")
        kill_t = [t for t, text in res.events
                  if text.startswith(f"KILL worker dev{KILL[0]}")]
        restart = int(res.recoveries[0]["restart"])
        check(kill_t and restart in res.commit_times,
              "tcp: no kill event or no commit of the resumed batch")
        recovery_s = res.commit_times[restart] - kill_t[0]
        check(res.startup_s is not None, "tcp: no start-up time")

        free_tcp, free_tcp_wall, _ = run_facade(
            tcp_config(profile, "tcp", None))
        free_q, free_q_wall, _ = run_facade(
            tcp_config(profile, "queue", None))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    check(free_tcp.worker_exitcodes == {1: 0, 2: 0} and not
          free_tcp.recoveries and not free_q.recoveries,
          f"failure-free runs: exit codes {free_tcp.worker_exitcodes}, "
          f"recoveries {free_tcp.recoveries} / {free_q.recoveries}")
    a = [float(v) for v in free_tcp.losses]
    b = [float(v) for v in free_q.losses]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    log(f"failure-free tcp vs queue: max |loss diff| "
        f"{max(abs(x - y) for x, y in zip(a, b)):.3g}, max rel {rel:.3g}")
    check(all(math.isfinite(x) for x in a) and rel <= 1e-5,
          f"failure-free tcp losses {rel:.3g} (rel) from the queue run's "
          f"(> 1e-5)")
    kb = res.transport_stats["kind_bytes"]

    def steady(r):
        """Batches/s from the first commit to the last (start-up out)."""
        ct = r.commit_times
        return (NUM_BATCHES - 1) / (ct[NUM_BATCHES - 1] - ct[0])

    out = {"wire": "tcp, codec int8-fused", "batches": NUM_BATCHES,
           "wall_s": wall, "batches_per_s": NUM_BATCHES / wall,
           "queue_batches_per_s_phase_F": fused["batches_per_s"],
           "startup_s": res.startup_s, "recovery_wall_s": recovery_s,
           "restart": restart, "partitions": points(res),
           "received_by_coordinator_bytes": {
               "act": kb["act"], "grad": kb["grad"],
               "replica": kb["replica"] + kb["replica_ov"],
               "control": kb["control"]},
           "sent_by_coordinator_bytes": res.transport_stats["tx_bytes"],
           "worker_exitcodes": res.worker_exitcodes,
           "launches_coordinator_process": launches,
           "steady_batches_per_s": steady(res),
           "failure_free": {"tcp_wall_s": free_tcp_wall,
                            "tcp_startup_s": free_tcp.startup_s,
                            "tcp_steady_batches_per_s": steady(free_tcp),
                            "queue_wall_s": free_q_wall,
                            "queue_steady_batches_per_s": steady(free_q),
                            "max_rel_loss_diff": rel},
           "loss_first5": first5, "loss_last5": last5}
    print(json.dumps({"tcp": out}), flush=True)
    return out


def run_entry_point(args, phase, timeout=300):
    """``python -m <args>`` as a user starts it, in its own process group,
    with a bounded wait (the whole group is killed on timeout, so no
    process outlives the smoke). Fails unless it exits 0. Returns (its
    standard output, wall s)."""
    return run_python(["-m", *args], phase, timeout)


def run_python(args, phase, timeout=300):
    """``python <args>`` (a script or ``-m`` a module), as
    ``run_entry_point`` runs it."""
    import signal
    cmd = [sys.executable, *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = args[1:] if args[0] == "-m" else args
    log(f"phase {phase}: " + " ".join(args))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"phase {phase}: {args[0]} did not finish in "
                           f"{timeout} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  | {line}")
    check(proc.returncode == 0,
          f"phase {phase}: {args[0]} exit code {proc.returncode}; stderr "
          f"tail: {err[-2000:]}")
    return out, wall


def entry_point_phase():
    """Phase L: the README's entry point as a user starts it."""
    args = ["repro_torch.launch.live_train", "--chain", "mobilenet",
            "--workers", "3", "--batches", "20", "--kill", "1@8",
            "--transport", "tcp"]
    out, wall = run_entry_point(args, "L")
    check("worker exit codes: {1: -9, 2: 0}" in out,
          "phase L: the entry point did not report worker exit codes "
          "{1: -9, 2: 0}")
    check("recovered: 2 workers" in out, "phase L: no recovery reported")
    out_line = {"command": " ".join(args), "wall_s": wall, "exit_code": 0}
    print(json.dumps({"entry_point": out_line}), flush=True)
    return out_line


# ------------------------- flash attention (K4) --------------------------

def flash_shapes():
    """(B, H, Hkv, Sq, Skv, dh, causal, window, q_offset) of phase A: the
    dense slice's shapes at qwen2-1.5b's heads, the hybrid slice's at
    zamba2-7b's (H = Hkv = 32, dh = 112), olmoe-1b-7b's prefill (H = Hkv =
    16, dh = 128) and whisper-base's encoder (H = Hkv = 8, dh = 64, 1,500
    frames, non-causal: a ragged key count without a causal mask), the
    engine's one-row microbatches (phase E's, and phase R's on a tensor
    rank: H = 6, Hkv = 1), then the smaller head dims."""
    H, Hkv, dh = 12, 2, 128
    big = [(4, H, Hkv, 2048, 2048, dh, True, 0, 0),
           (4, H, Hkv, 1000, 1000, dh, True, 0, 0),
           (4, H, Hkv, 2048, 2048, dh, True, 256, 0),
           (4, H, Hkv, 1000, 1000, dh, False, 0, 0),
           (4, H, Hkv, 512, 2048, dh, True, 0, 1536),
           (4, 32, 32, 2048, 2048, 112, True, 0, 0),   # zamba2-7b's
           OLMOE_PREFILL, WHISPER_ENCODER, *ENGINE_MICROBATCHES,
           RANK_TRAIN_MB, RANK_PREFILL_MB]
    small = [(2, 4, 2, 200, 200, d, True, 64, 0) for d in (32, 64)]
    small += [(2, 4, 2, 130, 130, d, False, 0, 0) for d in (32, 64)]
    return big, small


# zamba2-7b's B=1, 32-token prefill (phase Z (iii)): fewer rows than a block
ZAMBA2_SHORT = (1, 32, 32, 32, 32, 112, True, 0, 0)
# phase M's and phase W's encoder shapes
OLMOE_PREFILL = (4, 16, 16, 2048, 2048, 128, True, 0, 0)
WHISPER_ENCODER = (4, 8, 8, 1500, 1500, 64, False, 0, 0)
# phase E's microbatches of one row (the engine's B_l / M): qwen2-1.5b's
# heads at the bf16 training length, at the f32 parity step's and at the
# pipelined prefill's, and whisper-base's encoder
ENGINE_TRAIN_MB = (1, 12, 2, 1024, 1024, 128, True, 0, 0)
ENGINE_PARITY_MB = (1, 12, 2, 256, 256, 128, True, 0, 0)
ENGINE_PREFILL_MB = (1, 12, 2, 2048, 2048, 128, True, 0, 0)
WHISPER_ENCODER_MB = (1, 8, 8, 1500, 1500, 64, False, 0, 0)
ENGINE_MICROBATCHES = (ENGINE_TRAIN_MB, ENGINE_PARITY_MB, ENGINE_PREFILL_MB,
                       WHISPER_ENCODER_MB)
# phase R's microbatches on a tensor rank of (1, 1, 2): qwen2-1.5b's 12
# heads and 2 kv heads split two ways, a GQA group of 6 (H=6, Hkv=1), at
# the training length and the pipelined prefill's
RANK_TRAIN_MB = (1, 6, 1, 1024, 1024, 128, True, 0, 0)
RANK_PREFILL_MB = (1, 6, 1, 2048, 2048, 128, True, 0, 0)


def route2_shapes():
    """The shapes the serving paths launch route 2 (f32) at: qwen2's
    prefill and its last 512-row chunk (q_offset 1536, over 2048 keys),
    zamba2's prefill, its last chunk (over the 2,056-row cache that
    ``chunk_attention`` hands the kernel whole), its B=1, S=32 prefill,
    olmoe's prefill and Whisper's encoder; then the engine's f32
    microbatches (phase E): the parity step's and Whisper's encoder's."""
    big = flash_shapes()[0]
    return [big[0], big[4], big[5],
            (4, 32, 32, 512, PREFILL_S + DECODE_STEPS, 112, True, 0, 1536),
            ZAMBA2_SHORT, OLMOE_PREFILL, WHISPER_ENCODER, ENGINE_PARITY_MB,
            WHISPER_ENCODER_MB]


def describe(shape):
    B, H, Hkv, Sq, Skv, dh, causal, window, off = shape
    return (f"B={B} H={H} Hkv={Hkv} Sq={Sq} Skv={Skv} dh={dh} "
            f"causal={causal} window={window} q_offset={off}")


def flash_inputs(shape, dq, dkv, seed, torch, view="contiguous"):
    """q, k, v of ``shape``: contiguous ``[B, heads, S, dh]``; or, with
    ``view="model"``, ``[B, S, heads, dh].transpose(1, 2)`` as
    ``attention()`` passes them; or with ``view="cache"``, k and v as a
    slice of a ``[B, Skv + 8, Hkv, dh]`` cache, as ``chunk_attention()``
    passes them; or with ``view="unaligned"``, q contiguous one element
    past a 16-byte boundary (the wrapper copies it first: TMA needs a
    16-byte aligned base)."""
    B, H, Hkv, Sq, Skv, dh = shape[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size, dtype):
        return torch.randn(*size, generator=gen, device="cuda").to(dtype)

    if view in ("contiguous", "unaligned"):
        q = (randn(B, H, Sq, dh, dtype=dq) if view == "contiguous" else
             randn(1 + B * H * Sq * dh, dtype=dq)[1:].view(B, H, Sq, dh))
        return (q, randn(B, Hkv, Skv, dh, dtype=dkv),
                randn(B, Hkv, Skv, dh, dtype=dkv))
    q = randn(B, Sq, H, dh, dtype=dq).transpose(1, 2)
    if view == "model":
        return (q, randn(B, Skv, Hkv, dh, dtype=dkv).transpose(1, 2),
                randn(B, Skv, Hkv, dh, dtype=dkv).transpose(1, 2))
    cache = randn(2, B, Skv + 8, Hkv, dh, dtype=dkv)
    return q, cache[0, :, :Skv].transpose(1, 2), cache[1, :, :Skv].transpose(
        1, 2)


def reset_k4(K):
    """Set K4's launch counts, in all and by route, to 0."""
    K.launches = K.launches_route1 = K.launches_route2 = 0


def k4_route(dq, dkv, torch):
    """The route the wrapper must take for q's and k/v's dtypes."""
    return 1 if dq == dkv == torch.bfloat16 else 2


def flash_phase(torch, fops, fref):
    """Phase A. Returns the max |kernel - plain| and the largest relative
    L2 error, each by q's dtype."""
    f32, bf16 = torch.float32, torch.bfloat16
    types = {"f32": (f32, f32), "bf16": (bf16, bf16),
             "bf16 q over f32 kv": (bf16, f32),
             "f32 q over bf16 kv": (f32, bf16)}
    served = ("f32", "bf16", "bf16 q over f32 kv")    # the serving paths'
    big, small = flash_shapes()
    cases = [(sh, t, "contiguous") for sh in big + [ZAMBA2_SHORT]
             for t in served]
    cases += [(sh, t, "contiguous") for sh in small for t in types]
    cases += [(sh, t, "model") for sh in (big[0], big[5], ENGINE_TRAIN_MB,
                                          RANK_TRAIN_MB)
              for t in ("bf16", "f32")]
    # the q_offset chunk over a slice of the cache: qwen2's 512 rows over
    # 2048 of 2056, zamba2's 32 rows at q_offset 8 over 40 of 48
    cases += [(sh, t, "cache") for sh in
              (big[4], (1, 32, 32, 32, 40, 112, True, 0, 8)) for t in served]
    cases += [(big[0], t, "unaligned") for t in ("bf16", "f32")]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rels = dict(errs)
    K = fops.flash_attention_kernel
    for i, (shape, name, view) in enumerate(cases):
        dq, dkv = types[name]
        q, k, v = flash_inputs(shape, dq, dkv, i, torch, view)
        B, H, Hkv, Sq, Skv, dh, causal, window, off = shape
        reset_k4(K)
        got = K(q, k, v, off, causal=causal, window=window)
        route = k4_route(dq, dkv, torch)
        check((K.launches, K.launches_route1, K.launches_route2)
              == (1, int(route == 1), int(route == 2)),
              f"flash_attention at {describe(shape)} {name} ({view}) took "
              f"not route {route} alone: {K.launches_route1} launches on "
              f"route 1, {K.launches_route2} on route 2")
        want = fref.attention_reference(q, k, v, causal=causal,
                                        window=window, q_offset=off)
        torch.cuda.synchronize()
        key = str(dq).removeprefix("torch.")
        name = f"{name}, {view}, route {route}"
        check(got.dtype == dq and got.shape == want.shape
              and bool(torch.isfinite(got).all()),
              f"flash_attention output at {describe(shape)} {name}")
        err = abs_err(got, want)
        rel = ((got.double() - want.double()).norm()
               / want.double().norm()).item()
        log(f"  K4 {describe(shape)} {name}: max abs err {err:.3g} "
            f"(limit {FLASH_TOL[key]}), rel L2 {rel:.3g}")
        check(err <= FLASH_TOL[key], f"flash_attention differs from its "
              f"plain version by {err} at {describe(shape)} {name}")
        check(key == "float32" or rel <= FLASH_BF16_REL_L2,
              f"flash_attention's bf16 output is {rel} from its plain "
              f"version in rel L2 (> {FLASH_BF16_REL_L2}) at "
              f"{describe(shape)} {name}")
        errs[key] = max(errs[key], err)
        rels[key] = max(rels[key], rel)
    log(f"flash_attention within the limits over {len(cases)} cases; "
        f"largest rel L2 {rels}")
    return errs, rels


def visited_pairs(Sq, Skv, off, causal, window):
    """(query, key) pairs the masks keep: the work these inputs need."""
    import numpy as np
    pos = off + np.arange(Sq)
    hi = np.minimum(Skv - 1, pos) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(Sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_timings(shape, torch, fops, fref, dtype="bfloat16"):
    """K4 at one shape, in bf16 (route 1) or f32 (route 2): device time
    beside its bound (in f32 the CUDA cores' and, as ``bound_ms_3xtf32``,
    the tensor cores' for three tf32 products), the plain version's and
    ``scaled_dot_product_attention``'s (``is_causal`` where the causal
    mask is its top-left one; else the boolean mask of the window and the
    query offset, built before the timing; in f32 with TF32 off, as
    ``main`` sets it)."""
    import torch.nn.functional as F
    B, H, Hkv, Sq, Skv, dh, causal, window, off = shape
    dt = getattr(torch, dtype)
    q, k, v = flash_inputs(shape, dt, dt, 99, torch)
    # 2 flops a multiply-add; q.k and p.v each dh of them for every pair:
    # on the tensor cores in bf16, on the CUDA cores in f32
    flops = 4 * B * H * dh * visited_pairs(Sq, Skv, off, causal, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    # route 2 as it runs: three tf32 products for each f32 one
    t_tf32 = 3 * flops / TF32_FLOPS_PER_S
    if window or off or Sq != Skv:
        qpos = off + torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Skv, device="cuda")[None, :]
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        kw = dict(attn_mask=mask)
    else:
        kw = dict(is_causal=causal)
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw))
    except TypeError:                      # no enable_gqa: expand first
        ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        lib = (lambda: F.scaled_dot_product_attention(q, ke, ve, **kw))
    # the yardstick must compute the same function as the plain version
    want = fref.attention_reference(q, k, v, causal=causal, window=window,
                                    q_offset=off)
    got = lib()
    lib_err = abs_err(got, want)
    check(bool(torch.isfinite(got).all()) and lib_err <= FLASH_TOL[dtype],
          f"scaled_dot_product_attention differs from the plain version "
          f"by {lib_err} at {describe(shape)} {dtype}")
    return {"B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Skv": Skv, "dh": dh,
            "causal": causal, "window": window, "q_offset": off,
            "dtype": dtype, "route": k4_route(dt, dt, torch),
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "ms": time_ms(lambda: fops.flash_attention_kernel(
                q, k, v, off, causal=causal, window=window), torch),
            "plain_ms": time_ms(lambda: fref.attention_reference(
                q, k, v, causal=causal, window=window, q_offset=off), torch),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            **({} if dtype == "bfloat16" else {
                "bound_ms_3xtf32": 1e3 * max(t_tf32, t_bytes),
                "bound_by_3xtf32": ("operations" if t_tf32 >= t_bytes
                                    else "bytes")}),
            "library_ms": time_ms(lib, torch),
            "library_max_abs_err": lib_err}


# --------------------- the dense transformer slice (T) -------------------

def prefill_chunks(params, cfg, tokens, caches, chunk):
    """Chunked prefill on one device: each chunk of ``tokens`` runs
    through every slot's ``prefill_chunk`` (K4 with a ``q_offset``),
    appending its kv to ``caches`` (written in place). Returns the last
    position's logits."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.models import modules
    from repro_torch.models.blocks import BLOCKS, BlockCtx
    dtype = modules.dtype_of(cfg.dtype)
    pm = M.pad_mask(cfg, device=tokens.device)
    for start in range(0, tokens.shape[1], chunk):
        x = params["embed"]["table"].to(dtype)[tokens[:, start:start + chunk]]
        for s in range(cfg.pipeline_stages):
            for j, t in enumerate(cfg.slot_layout):
                ctx = BlockCtx(cfg=cfg, pos=start, dtype=dtype,
                               active=pm[s, j], window=cfg.sliding_window)
                x, c_out = BLOCKS[t].prefill_chunk(
                    M._slot_params(params["blocks"][j], s), x,
                    tree.map(lambda a: a[s], caches[j]), ctx)
                for full, upd in zip(tree.leaves(caches[j]),
                                     tree.leaves(c_out)):
                    full[s] = upd
    return M.head(params, cfg, x)[:, -1]


def serve_and_check(params, cfg, prompts, new_tokens, cache_len,
                    counters, torch, standalone_batch=1):
    """``ServingEngine`` with 4 slots answers ``prompts`` greedily, f32.
    Each engine step's logits row of a request is held within 1e-4 of a
    standalone ``sequential_decode_step`` fed the same tokens (at batch
    ``standalone_batch``, the tokens in every row; row 0 is compared),
    and the engine's token must be the standalone's argmax wherever the
    top-2 logit gap exceeds 1e-3 (below that, rounding may flip a
    near-tie). The launch counts in ``counters`` are set to 0 just before
    the engine runs and read just after. Returns the figures."""
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine

    class Recording(ServingEngine):
        """Keeps each request's logits row of every engine step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows = {}

        def _decode_step(self, params_, caches_, tokens_, pos_):
            logits, new = super()._decode_step(params_, caches_, tokens_,
                                               pos_)
            for i, r in enumerate(self._slots):
                if r is not None:
                    self.rows.setdefault(r.uid, []).append(logits[i].clone())
            return logits, new

    eng = Recording(cfg, params, max_slots=4, cache_len=cache_len,
                    device="cuda")
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(all(len(out[u]) == new_tokens for u in uids),
          "a request was cut short")
    worst, min_gap, n_checked = 0.0, float("inf"), 0
    with torch.no_grad():
        for p, u in zip(prompts, uids):
            caches = M.init_caches(cfg, batch=standalone_batch,
                                   cache_len=cache_len,
                                   dtype=torch.float32, device="cuda")
            fed = p + out[u][:-1]
            rows = eng.rows[u]
            check(len(rows) == len(fed), f"request {u}: {len(rows)} steps "
                  f"for {len(fed)} tokens")
            for pos, tok in enumerate(fed):
                lg, caches = M.sequential_decode_step(
                    params, cfg, [[tok]] * standalone_batch, caches, pos)
                row = lg[0, 0]
                worst = max(worst, (row - rows[pos]).abs().max().item())
                k = pos - (len(p) - 1)
                if k >= 0:
                    top2 = torch.topk(row, 2).values
                    gap = (top2[0] - top2[1]).item()
                    min_gap = min(min_gap, gap)
                    if gap > 1e-3:
                        n_checked += 1
                        check(int(row.argmax()) == out[u][k],
                              f"request {u} token {k}: engine "
                              f"{out[u][k]}, standalone "
                              f"{int(row.argmax())} (gap {gap:.3g})")
    check(worst <= 1e-4, f"serving logits {worst} from standalone (> 1e-4)")
    generated = new_tokens * len(prompts)
    fed_total = sum(len(p) + new_tokens - 1 for p in prompts)
    return {"s": serve_s, "generated_per_s": generated / serve_s,
            "fed_per_s": fed_total / serve_s, "worst": worst,
            "min_gap": min_gap, "checked": n_checked,
            "launches": launches, "tokens": [out[u] for u in uids]}


def transformer_phase(torch, fops):
    """Phase T: prefill, chunked prefill + decode, and serving, at the
    full width of qwen2-1.5b on the card. Returns its summary."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b").with_overrides(tensor_parallel=1,
                                                  use_flash_attention=1)
    check(cfg.num_layers == 28 and cfg.d_model == 1536
          and cfg.num_heads == 12 and cfg.num_kv_heads == 2
          and cfg.head_dim == 128 and cfg.vocab_size == 151_936,
          f"qwen2-1.5b at its published widths: {cfg}")
    cfg32 = cfg.with_overrides(dtype="float32")
    n_slots = cfg.pipeline_stages * cfg.layers_per_stage
    check(n_slots == cfg.num_layers, f"{n_slots} slots for "
          f"{cfg.num_layers} layers")

    params = M.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=0)
    toks, _ = lm.sample(np.random.default_rng(0), PREFILL_B,
                        PREFILL_S + DECODE_STEPS)
    tokens = torch.as_tensor(toks, device="cuda")
    prompt = tokens[:, :PREFILL_S]
    log(f"{cfg.name}: {n_params:,} parameters (f32), {n_slots} slots; "
        f"prompts [{PREFILL_B}, {PREFILL_S}] from SyntheticLM")
    summary = {"config": f"{cfg.name} tensor_parallel=1 "
                         f"use_flash_attention=1", "parameters": n_params}

    def forward(c, toks_):
        """Logits of one sequential_lm_forward, the K4 launches it made and
        those of them on route 1 (the counts are set to 0 just before,
        read just after)."""
        reset_k4(K)
        logits = M.sequential_lm_forward(params, c, toks_)[0]
        torch.cuda.synchronize()
        return logits, K.launches, K.launches_route1

    with torch.no_grad():
        # ---- (i) prefill: K4 against the plain attention path ----------
        t0 = time.perf_counter()
        flash, n, r1_f32 = forward(cfg32, prompt)
        prefill32_s = time.perf_counter() - t0
        plain, n0, _ = forward(cfg32.with_overrides(use_flash_attention=0),
                               prompt)
        check(n == n_slots and n0 == 0 and r1_f32 == 0,
              f"f32 prefill: {n} K4 launches with flash ({r1_f32} on route "
              f"1), {n0} without")
        err = (flash - plain).abs().max().item()
        log(f"(i) f32 prefill B={PREFILL_B} S={PREFILL_S}: max |logit "
            f"flash - plain| {err:.3g}; K4 launches {n}; "
            f"{prefill32_s * 1e3:.1f} ms (the phase's first forward)")
        check(bool(torch.isfinite(flash).all()), "non-finite f32 logits")
        check(err <= 1e-3, f"f32 prefill logits differ by {err} (> 1e-3)")
        del flash, plain
        forward(cfg, prompt)                               # warm-up
        t0 = time.perf_counter()
        flash, n16, r1_bf16 = forward(cfg, prompt)
        prefill_s = time.perf_counter() - t0
        plain, n0, _ = forward(cfg.with_overrides(use_flash_attention=0),
                               prompt)
        check(n16 == r1_bf16 == n_slots and n0 == 0,
              f"bf16 prefill: {n16} K4 launches with flash ({r1_bf16} on "
              f"route 1), {n0} without")
        rel = ((flash - plain).norm() / plain.norm()).item()
        top1 = (flash.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"(i) bf16 prefill: rel L2 {rel:.3g}, top-1 agreement "
            f"{top1:.4f}; {PREFILL_B * PREFILL_S / prefill_s:,.0f} tokens/s "
            f"({prefill_s * 1e3:.1f} ms)")
        check(bool(torch.isfinite(flash).all()), "non-finite bf16 logits")
        check(rel <= 2e-2, f"bf16 prefill rel L2 {rel} (> 2e-2)")
        summary.update(prefill_f32_max_abs_diff=err,
                       prefill_f32_ms=prefill32_s * 1e3,
                       k4_launches_prefill_f32=n, prefill_bf16_rel_l2=rel,
                       prefill_bf16_top1_agreement=top1,
                       prefill_bf16_ms=prefill_s * 1e3,
                       prefill_tokens_per_s=PREFILL_B * PREFILL_S
                       / prefill_s, k4_launches_prefill_bf16=n16)
        del flash, plain

        # ---- (ii) chunked prefill into the cache, then decode ----------
        caches = M.init_caches(cfg32, batch=PREFILL_B,
                               cache_len=PREFILL_S + DECODE_STEPS,
                               dtype=torch.float32, device="cuda")
        reset_k4(K)
        last = prefill_chunks(params, cfg32, prompt, caches, CHUNK)
        torch.cuda.synchronize()
        n_chunks, r1_chunks = K.launches, K.launches_route1
        reset_k4(K)
        steps = []
        for t in range(DECODE_STEPS):
            lg, caches = M.sequential_decode_step(
                params, cfg32, tokens[:, PREFILL_S + t:PREFILL_S + t + 1],
                caches, PREFILL_S + t)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        n_decode = K.launches
        ref = M.sequential_lm_forward(params, cfg32, tokens)[0][
            :, PREFILL_S - 1:]
        err_last = (last - ref[:, 0]).abs().max().item()
        err_dec = max((lg - ref[:, 1 + t]).abs().max().item()
                      for t, lg in enumerate(steps))
        log(f"(ii) {PREFILL_S // CHUNK} chunks of {CHUNK}: last logits "
            f"{err_last:.3g} from a flash forward, K4 launches {n_chunks}; "
            f"{DECODE_STEPS} decode steps: {err_dec:.3g}, K4 launches "
            f"{n_decode}")
        check(n_chunks == n_slots * PREFILL_S // CHUNK,
              f"{n_chunks} K4 launches in the chunked prefill")
        check(n_decode == 0, f"decode launched K4 {n_decode} times")
        check(err_last <= 1e-3 and err_dec <= 1e-3,
              f"chunked prefill / decode logits off by {err_last}, "
              f"{err_dec} (> 1e-3)")
        summary.update(chunked_prefill_max_abs_diff=err_last,
                       decode_max_abs_diff=err_dec,
                       k4_launches_chunked_prefill=n_chunks,
                       k4_launches_decode=n_decode,
                       # on route 1; decode and serving launch no K4
                       k4_route1={"prefill_f32": r1_f32,
                                  "prefill_bf16": r1_bf16,
                                  "chunked_prefill": r1_chunks})
        del caches, ref, steps, last

    # ---- (iii) serving: continuous batching against standalone decode ---
    rng = np.random.default_rng(1)
    prompts = [lm.sample(rng, 1, int(n))[0][0].tolist()
               for n in rng.integers(8, 65, 8)]
    sv = serve_and_check(params, cfg32, prompts, 16, 128, {"K4": K}, torch)
    check(sv["launches"]["K4"] == 0,
          f"serving launched K4 {sv['launches']['K4']} times")
    log(f"(iii) ServingEngine: 8 requests (prompts "
        f"{[len(p) for p in prompts]}), 16 new tokens each, in "
        f"{sv['s']:.2f}s: {sv['generated_per_s']:.1f} generated tokens/s, "
        f"{sv['fed_per_s']:.1f} tokens fed/s; logits within "
        f"{sv['worst']:.3g} of standalone decode; {sv['checked']}/128 "
        f"tokens with a top-2 gap > 1e-3 all equal; smallest gap "
        f"{sv['min_gap']:.3g}")
    summary.update(serving_logits_max_abs_diff=sv["worst"],
                   serving_min_top2_gap=sv["min_gap"],
                   serving_tokens_checked=sv["checked"],
                   serving_s=sv["s"],
                   decode_tokens_per_s=sv["generated_per_s"],
                   decode_tokens_fed_per_s=sv["fed_per_s"],
                   k4_launches_serving=sv["launches"]["K4"],
                   wall_s=time.perf_counter() - t_phase)
    print(json.dumps({"slice_transformer": summary}), flush=True)
    return summary


# ---------------------------- SSD scan (K5) ------------------------------

# (B, S, x dtype, with h0) of phase S, all at zamba2-7b's H=112, P=64,
# N=64: the prefill shapes, a ragged S, a 512-step chunk continuing from a
# carried state, and bf16 xh
SSD_SHAPES = [(4, 2048, "float32", False), (1, 2048, "float32", False),
              (4, 1000, "float32", False), (4, 512, "float32", True),
              (4, 2048, "bfloat16", False)]
SSD_H, SSD_P, SSD_N = 112, 64, 64


def ssd_inputs(B, S, draw, xdtype, seed, torch):
    """xh, dt, A, Bm, Cm, D for K5 from a seed. ``draw`` "jax" is
    tests/test_kernels.py:65-71's (dt = softplus(n)*0.1, A = -exp(0.3n));
    "zamba2" is zamba2-7b's ranges: A = -linspace(1, 16, H) (its A_log
    init) and dt in its dt_bias range, log-uniform in [0.001, 0.1]
    (``init_mamba2``), so a chunk's cumulative decay reaches -200;
    "model" is what the mixer hands K5 at random weights, dt =
    softplus(n + dt_bias), under which y reaches ~10^2."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    H = SSD_H
    xh = n(B, S, H, SSD_P).to(getattr(torch, xdtype))
    Bm, Cm = n(B, S, SSD_N), n(B, S, SSD_N)
    if draw == "jax":
        dt = F.softplus(n(B, S, H)) * 0.1
        A = -torch.exp(0.3 * n(H))
    else:
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        lo, hi = math.log(0.001), math.log(0.1)
        if draw == "zamba2":
            u = torch.rand(B, S, H, generator=gen, device="cuda")
            dt = torch.exp(u * (hi - lo) + lo)
        else:
            u = torch.rand(H, generator=gen, device="cuda")
            dt_bias = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
            dt = F.softplus(n(B, S, H) + dt_bias)
    return xh, dt, A, Bm, Cm, torch.ones(H, device="cuda")


def ssd_work(B, S, xdtype, with_h0):
    """(flop, bytes) one K5 call needs. For each (b, h) and chunk of L real
    steps: the triangular M.x, L(L+1)/2 pairs x P multiply-adds; C.h^T and
    the state injection, L*N*P each; C.B^T once per (b, chunk), L(L+1)/2
    pairs x N. Bytes: xh read and y written in xh's type, dt, Bm, Cm, A, D
    in f32, h0 and h_final when carried."""
    H, P, N, Q = SSD_H, SSD_P, SSD_N, 128
    Ls = [min(Q, S - c) for c in range(0, S, Q)]
    pairs = sum(L * (L + 1) // 2 for L in Ls)
    flop = 2 * (B * H * (pairs * P + 2 * S * N * P) + B * pairs * N)
    xb = 2 if xdtype == "bfloat16" else 4
    nbytes = (2 * xb * B * S * H * P + 4 * B * S * (H + 2 * N) + 8 * H
              + (2 * 4 * B * H * P * N if with_h0 else 0))
    return flop, nbytes


def ssd_phase(torch, sops, sref):
    """Phase S. Returns the max |kernel - plain| and the largest relative
    L2 error, each by xh's dtype, over the "jax" and "zamba2" draws, and
    the "model" draw's figures. Its y reaches ~10^2, where f32 rounding in
    any order is of the order of 1e-4, so that draw is held by relative
    L2 (SSD_MODEL_REL_L2) and its max abs error is reported."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rels = dict(errs)
    cases = [(i, shape, draw) for i, shape in enumerate(SSD_SHAPES)
             for draw in ("jax", "zamba2")]
    cases.append((len(SSD_SHAPES), SSD_SHAPES[0], "model"))
    model = {}
    for i, (B, S, xdtype, with_h0), draw in cases:
        what = f"B={B} S={S} xh {xdtype} h0={with_h0} draw {draw}"
        ins = ssd_inputs(B, 2 * S if with_h0 else S, draw, xdtype,
                         100 + i, torch)
        if with_h0:
            # the state a previous chunk leaves, from the kernel, and
            # the kernel's and the plain version's of the next chunk
            first = [t[:, :S] if t.dim() > 1 else t for t in ins]
            _, h0 = sops.ssd_scan_kernel(*first, return_state=True)
            _, h0_plain = sref.ssd_scan_reference(*first,
                                                  return_state=True)
            ins = [t[:, S:] if t.dim() > 1 else t for t in ins]
            got, h_got = sops.ssd_scan_kernel(*ins, h0=h0)
            want, h_want = sref.ssd_scan_reference(*ins, h0=h0)
        else:
            got = sops.ssd_scan_kernel(*ins)
            want = sref.ssd_scan_reference(*ins)
        excess = None
        if xdtype == "bfloat16":
            # y reaches ~30 here, where bf16's spacing is 0.125: rounding
            # alone moves an output up to 0.0625 from its f32 value, and
            # two f32 sums a few ulp apart round to neighbours wherever
            # they straddle a midpoint. So each bf16 output is held to be
            # the plain version's f32 result on the same values (xh.float()
            # is exact) correctly rounded: within half a bf16 spacing plus
            # the f32 limit. Below |y| = 16 that bound is under 5e-2.
            rounded = abs_err(got, want)
            want = sref.ssd_scan_reference(ins[0].float(), *ins[1:])
            half = torch.ldexp(torch.ones_like(want),
                               torch.frexp(want).exponent - 9)
            excess = ((got.float() - want).abs() - half
                      - SSD_TOL["float32"]).max().item()
        torch.cuda.synchronize()
        check(got.dtype == ins[0].dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()),
              f"ssd_scan output at {what}")
        err = abs_err(got, want)
        rel = ((got.double() - want.double()).norm()
               / want.double().norm()).item()
        if with_h0:
            err = max(err, abs_err(h0, h0_plain),
                      abs_err(h_got, h_want))
        if draw == "model":
            model = {"max_abs_err": err, "rel_l2": rel,
                     "max_abs_y": want.abs().max().item()}
            log(f"  K5 {what}: max abs err {err:.3g} at max |y| "
                f"{model['max_abs_y']:.3g}, rel L2 {rel:.3g} (limit "
                f"{SSD_MODEL_REL_L2})")
            check(rel <= SSD_MODEL_REL_L2, f"ssd_scan's output is {rel} "
                  f"from its plain version in rel L2 at {what}")
            continue
        if excess is not None:
            log(f"  K5 {what}: max abs err {err:.3g} from the f32 plain "
                f"result at max |y| {want.abs().max().item():.3g} (bf16 "
                f"vs bf16 {rounded:.3g}); largest excess over half a bf16 "
                f"spacing + {SSD_TOL['float32']}: {excess:.3g} (limit 0); "
                f"rel L2 {rel:.3g}")
            check(excess <= 0, f"ssd_scan's bf16 output is not its f32 "
                  f"value rounded, by {excess}, at {what}")
        else:
            log(f"  K5 {what}: max abs err {err:.3g} (limit "
                f"{SSD_TOL[xdtype]}), rel L2 {rel:.3g}, max |y| "
                f"{want.abs().max().item():.3g}")
            check(err <= SSD_TOL[xdtype], f"ssd_scan differs from its "
                  f"plain version by {err} at {what}")
        check(xdtype == "float32" or rel <= SSD_BF16_REL_L2,
              f"ssd_scan's bf16 output is {rel} from its plain version "
              f"in rel L2 (> {SSD_BF16_REL_L2}) at {what}")
        errs[xdtype] = max(errs[xdtype], err)
        rels[xdtype] = max(rels[xdtype], rel)
        del ins, got, want
    log(f"ssd_scan within the limits over {len(cases)} cases; largest "
        f"rel L2 {rels}")
    return errs, rels, model


# small shapes beside phase S's: the other N and P the wrapper takes, each
# pair of input types, h0 with h_final, a random D, the mixer's views (one
# conv output split, no copy) and a base TMA cannot take (copied first):
# (B, S, H, P, N, x dtype, dt/B/C dtype, with h0, view)
SSD_COVERAGE = [
    (2, 300, 5, 32, 16, "float32", "float32", True, "contiguous"),
    (1, 200, 3, 96, 32, "bfloat16", "float32", False, "contiguous"),
    (2, 260, 4, 64, 128, "float32", "bfloat16", True, "contiguous"),
    (1, 130, 2, 128, 64, "bfloat16", "bfloat16", False, "contiguous"),
    (2, 384, 6, 64, 64, "float32", "float32", True, "mixer"),
    (1, 100, 3, 64, 64, "float32", "float32", False, "unaligned")]


def ssd_coverage(torch, sops, sref):
    """K5 against its plain version at ``SSD_COVERAGE``, at phase S's
    limits (f32 1e-4 max abs for y and h_final; bf16 y its f32 plain value
    correctly rounded), each case held to its copy plan. Returns the
    largest f32 error."""
    import torch.nn.functional as F
    worst = 0.0
    for i, (B, S, H, P, N, xd, sd, with_h0, view) in enumerate(
            SSD_COVERAGE):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)

        def n(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        if view == "mixer":            # as mamba2._ssm_inputs splits it
            xi, Bm, Cm = torch.split(n(B, S, H * P + 2 * N),
                                     [H * P, N, N], dim=-1)
            xh = xi.reshape(B, S, H, P)
        elif view == "unaligned":      # 4 bytes past a 16-byte boundary
            xh = n(1 + B * S * H * P)[1:].view(B, S, H, P)
            Bm, Cm = n(B, S, N), n(B, S, N)
        else:
            xh, Bm, Cm = n(B, S, H, P), n(B, S, N), n(B, S, N)
        xt, st = getattr(torch, xd), getattr(torch, sd)
        if xt != torch.float32:
            xh = xh.to(xt)
        if st != torch.float32:
            Bm, Cm = Bm.to(st), Cm.to(st)
        dt = (F.softplus(n(B, S, H)) * 0.1).to(st)
        A, D = -torch.exp(0.3 * n(H)), n(H)
        h0 = 0.5 * n(B, H, P, N) if with_h0 else None
        what = (f"B={B} S={S} H={H} P={P} N={N} xh {xd} dt/B/C {sd} "
                f"h0={with_h0} {view}")
        plan = sops.launch_plan(xh, Bm, Cm, with_h0)
        check(plan.copy == (view == "unaligned", False, False),
              f"ssd_scan's plan copies {plan.copy} at {what}")
        got = sops.ssd_scan_kernel(xh, dt, A, Bm, Cm, D, h0=h0)
        want = sref.ssd_scan_reference(xh.float(), dt, A, Bm, Cm, D, h0=h0)
        herr = 0.0
        if with_h0:
            (got, h_got), (want, h_want) = got, want
            herr = abs_err(h_got, h_want)
        torch.cuda.synchronize()
        check(got.dtype == xh.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()),
              f"ssd_scan output at {what}")
        err = abs_err(got, want)
        if xt == torch.float32:
            log(f"  K5 {what}: max abs err {err:.3g}, h_final {herr:.3g} "
                f"(limit {SSD_TOL['float32']})")
            check(max(err, herr) <= SSD_TOL["float32"],
                  f"ssd_scan differs from its plain version by "
                  f"{max(err, herr)} at {what}")
            worst = max(worst, err, herr)
        else:
            half = torch.ldexp(torch.ones_like(want),
                               torch.frexp(want).exponent - 9)
            excess = ((got.float() - want).abs() - half
                      - SSD_TOL["float32"]).max().item()
            log(f"  K5 {what}: max abs err {err:.3g} from the f32 plain "
                f"result; excess over half a bf16 spacing + "
                f"{SSD_TOL['float32']}: {excess:.3g} (limit 0)")
            check(excess <= 0, f"ssd_scan's bf16 output is not its f32 "
                  f"value rounded, by {excess}, at {what}")
    log(f"ssd_scan within the limits at {len(SSD_COVERAGE)} coverage "
        f"cases")
    return worst


def ssd_timings(shape, torch, sops, sref):
    """K5 at one phase-S shape, zamba2's draw: device time beside its
    bound and the plain version's. No single PyTorch call computes the
    SSD scan, so there is no library time."""
    B, S, xdtype, with_h0 = shape
    ins = ssd_inputs(B, S, "zamba2", xdtype, 7, torch)
    h0 = (torch.zeros(B, SSD_H, SSD_P, SSD_N, device="cuda")
          if with_h0 else None)
    flop, nbytes = ssd_work(B, S, xdtype, with_h0)
    t_ops, t_bytes = flop / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    # the same work as three tf32 products on the tensor cores (3xTF32)
    t_tc = 3 * flop / TF32_FLOPS_PER_S
    return {"B": B, "S": S, "H": SSD_H, "P": SSD_P, "N": SSD_N,
            "xh_dtype": xdtype, "h0": with_h0, "gflop": flop / 1e9,
            "mbytes": nbytes / 1e6,
            "ms": time_ms(lambda: sops.ssd_scan_kernel(*ins, h0=h0), torch),
            "plain_ms": time_ms(lambda: sref.ssd_scan_reference(
                *ins, h0=h0), torch),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_3xtf32": 1e3 * max(t_tc, t_bytes),
            "bound_by_3xtf32": "operations" if t_tc >= t_bytes else "bytes",
            "library_ms": None}


def ssd_pass_times(shape, torch, sops, calls=5):
    """Device time of each of K5's three kernels at one phase-S shape, in
    ms a call, from ``torch.profiler``'s ``key_averages()`` over ``calls``
    calls; None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    B, S, xdtype, with_h0 = shape
    ins = ssd_inputs(B, S, "zamba2", xdtype, 7, torch)
    h0 = (torch.zeros(B, SSD_H, SSD_P, SSD_N, device="cuda")
          if with_h0 else None)
    sops.ssd_scan_kernel(*ins, h0=h0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sops.ssd_scan_kernel(*ins, h0=h0)
        torch.cuda.synchronize()
    out = {}
    for name in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"):
        us = sum(getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) or 0
                 for e in prof.key_averages() if name in e.key)
        out[name] = us / 1e3 / calls if us else None
    return out


@contextlib.contextmanager
def plain_ssd_scan():
    """The Mamba2 mixers' scan swapped for K5's plain version, here in the
    smoke: the package reads no switch for it."""
    from repro_torch.kernels.ssm_scan import ref
    from repro_torch.models import mamba2
    kernel = mamba2.ssd_scan
    mamba2.ssd_scan = ref.ssd_scan_reference
    try:
        yield
    finally:
        mamba2.ssd_scan = kernel


def bf16_slot_updates(params, cfg, tokens):
    """The bf16 forward slot by slot: each slot's update (output - input)
    with K4 and K5 against the plain slot's (``use_flash_attention=0`` and
    the plain scan) on the same input, the kernel slot's output feeding
    the next. Returns the largest relative L2 difference over the active
    slots. Launches here are comparisons, not counted."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.blocks import BLOCKS, BlockCtx
    dtype = torch.bfloat16
    x, positions, _ = M.embed(params, cfg, tokens, dtype=dtype)
    pm = M.pad_mask(cfg, device=x.device)
    plain_cfg = cfg.with_overrides(use_flash_attention=0)
    worst = 0.0
    for s in range(cfg.pipeline_stages):
        for j, t in enumerate(cfg.slot_layout):
            p = M._slot_params(params["blocks"][j], s)
            ctx = BlockCtx(cfg=cfg, positions=positions, dtype=dtype,
                           active=pm[s, j])
            y, _ = BLOCKS[t].apply(p, x, ctx)
            if pm[s, j] > 0:
                with plain_ssd_scan():
                    yp, _ = BLOCKS[t].apply(p, x, BlockCtx(
                        cfg=plain_cfg, positions=positions, dtype=dtype,
                        active=pm[s, j]))
                du, dp = y.float() - x.float(), yp.float() - x.float()
                worst = max(worst, ((du - dp).norm() / dp.norm()).item())
            x = y
    return worst


# ------------------------ the hybrid Mamba2 slice (Z) ---------------------

def hybrid_phase(torch, fops, sops):
    """Phase Z: prefill, chunked prefill + decode, a check by decode, and
    serving, at the full width of zamba2-7b on the card. Returns its
    summary."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    K4, K5 = fops.flash_attention_kernel, sops.ssd_scan_kernel
    counters = {"K4": K4, "K5": K5}
    t_phase = time.perf_counter()
    cfg = get_config("zamba2-7b").with_overrides(use_flash_attention=1)
    check(cfg.num_layers == 81 and cfg.d_model == 3584
          and cfg.num_heads == cfg.num_kv_heads == 32 and cfg.head_dim == 112
          and cfg.d_ff == 14_336 and cfg.vocab_size == 32_000
          and cfg.ssm_state == 64 and cfg.pipeline_stages == 16
          and cfg.slot_layout == ("hybrid",) + ("mamba",) * 5
          and cfg.tensor_parallel == 1,
          f"zamba2-7b at its published widths: {cfg}")
    cfg32 = cfg.with_overrides(dtype="float32")
    n_slots = cfg.pipeline_stages * cfg.layers_per_stage
    n_hybrid = cfg.pipeline_stages

    params = M.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == ZAMBA2_PARAMETERS, f"{n_params:,} parameters, not "
          f"{ZAMBA2_PARAMETERS:,}")
    lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=0)
    toks, _ = lm.sample(np.random.default_rng(0), PREFILL_B,
                        PREFILL_S + DECODE_STEPS)
    tokens = torch.as_tensor(toks, device="cuda")
    prompt = tokens[:, :PREFILL_S]
    log(f"{cfg.name}: {n_params:,} parameters (f32), {n_slots} slots "
        f"({n_hybrid} hybrid), assignment {M.default_assignment(cfg)}; "
        f"prompts [{PREFILL_B}, {PREFILL_S}] from SyntheticLM")
    summary = {"config": f"{cfg.name} use_flash_attention=1",
               "parameters": n_params}

    route1 = {}

    def counted(fn):
        """fn()'s result and the K4, K5 launches it made (the counts are
        set to 0 just before, read just after); K4's launches on route 1
        are left in ``route1["last"]``."""
        reset_k4(K4)
        K5.launches = 0
        out = fn()
        torch.cuda.synchronize()
        route1["last"] = K4.launches_route1
        return out, K4.launches, K5.launches

    def forward(c, toks_):
        return counted(lambda: M.sequential_lm_forward(params, c, toks_)[0])

    def plain_forward(c, toks_):
        with plain_ssd_scan():
            return forward(c.with_overrides(use_flash_attention=0), toks_)

    with torch.no_grad():
        # ---- (i) prefill: K4 and K5 against their plain versions --------
        t0 = time.perf_counter()
        kern, n4, n5 = forward(cfg32, prompt)
        prefill32_s = time.perf_counter() - t0
        r1_f32 = route1["last"]
        plain, p4, p5 = plain_forward(cfg32, prompt)
        check((n4, n5, p4, p5, r1_f32) == (n_hybrid, n_slots, 0, 0, 0),
              f"f32 prefill: K4, K5 launched {n4}, {n5} times with the "
              f"kernels (K4 {r1_f32} on route 1), {p4}, {p5} without")
        err = (kern - plain).abs().max().item()
        log(f"(i) f32 prefill B={PREFILL_B} S={PREFILL_S}: max |logit "
            f"kernels - plain| {err:.3g}; K4, K5 launches {n4}, {n5}; "
            f"{prefill32_s * 1e3:.1f} ms (the phase's first forward)")
        check(bool(torch.isfinite(kern).all()), "non-finite f32 logits")
        check(err <= 1e-3, f"f32 prefill logits differ by {err} (> 1e-3)")
        kern32 = kern
        del plain
        forward(cfg, prompt)                               # warm-up
        t0 = time.perf_counter()
        kern, b4, b5 = forward(cfg, prompt)
        prefill_s = time.perf_counter() - t0
        r1_bf16 = route1["last"]
        plain, p4, p5 = plain_forward(cfg, prompt)
        check((b4, b5, p4, p5, r1_bf16) == (n_hybrid, n_slots, 0, 0,
                                            n_hybrid),
              f"bf16 prefill: K4, K5 launched {b4}, {b5} times with the "
              f"kernels (K4 {r1_bf16} on route 1), {p4}, {p5} without")

        def rel_l2(a, b):
            return ((a.float() - b.float()).norm() / b.float().norm()).item()

        rel = rel_l2(kern, plain)
        top1 = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        # how far rounding alone moves these logits: the same kernel
        # forward in f32, and a bf16 forward that swaps only the SSD scan,
        # whose f32 output is ~1e-6 from K5's (phase S)
        rel_f32 = rel_l2(kern, kern32)
        with plain_ssd_scan():
            k5_only, _, _ = forward(cfg, prompt)
        rel_k5 = rel_l2(kern, k5_only)
        del kern32, k5_only
        slot_rel = bf16_slot_updates(params, cfg, prompt)
        log(f"(i) bf16 prefill: rel L2 {rel:.3g} from the plain forward, "
            f"top-1 agreement {top1:.4f}; against the rounding: the f32 "
            f"forward {rel_f32:.3g} away, the plain scan alone {rel_k5:.3g}; "
            f"slot by slot, each update within {slot_rel:.3g} (rel L2) of "
            f"the plain slot's on the same input; "
            f"{PREFILL_B * PREFILL_S / prefill_s:,.0f} tokens/s "
            f"({prefill_s * 1e3:.1f} ms)")
        check(bool(torch.isfinite(kern).all()), "non-finite bf16 logits")
        # 2e-2 is phase T's whole-forward limit. Here it is held slot by
        # slot: through 81 layers in bf16 at random weights any rounding
        # difference grows to ~5% of the logits (rel_k5), so the whole
        # forward is held to the distance bf16 itself puts it from f32
        check(slot_rel <= 2e-2, f"a bf16 slot's update is {slot_rel} from "
              f"the plain slot's (rel L2 > 2e-2)")
        check(rel <= rel_f32, f"bf16 prefill rel L2 {rel} from the plain "
              f"forward, above the f32 forward's {rel_f32}")
        summary.update(prefill_f32_max_abs_diff=err,
                       prefill_f32_ms=prefill32_s * 1e3,
                       prefill_bf16_rel_l2=rel,
                       prefill_bf16_top1_agreement=top1,
                       prefill_bf16_rel_l2_vs_f32=rel_f32,
                       prefill_bf16_rel_l2_plain_scan_only=rel_k5,
                       prefill_bf16_slot_update_max_rel_l2=slot_rel,
                       prefill_bf16_ms=prefill_s * 1e3,
                       prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s,
                       launches_prefill_f32={"K4": n4, "K5": n5},
                       launches_prefill_bf16={"K4": b4, "K5": b5})
        del kern, plain

        # ---- (ii) chunked prefill into the caches, then decode ----------
        caches = M.init_caches(cfg32, batch=PREFILL_B,
                               cache_len=PREFILL_S + DECODE_STEPS,
                               dtype=torch.float32, device="cuda")
        last, c4, c5 = counted(lambda: prefill_chunks(
            params, cfg32, prompt, caches, CHUNK))
        r1_chunks = route1["last"]
        steps = []

        def decode():
            nonlocal caches
            for t in range(DECODE_STEPS):
                lg, caches = M.sequential_decode_step(
                    params, cfg32,
                    tokens[:, PREFILL_S + t:PREFILL_S + t + 1], caches,
                    PREFILL_S + t)
                steps.append(lg[:, 0])

        _, d4, d5 = counted(decode)
        ref = M.sequential_lm_forward(params, cfg32, tokens)[0][
            :, PREFILL_S - 1:]
        err_last = (last - ref[:, 0]).abs().max().item()
        err_dec = max((lg - ref[:, 1 + t]).abs().max().item()
                      for t, lg in enumerate(steps))
        n_chunks = PREFILL_S // CHUNK
        log(f"(ii) {n_chunks} chunks of {CHUNK}: last logits {err_last:.3g} "
            f"from a kernel forward, K4, K5 launches {c4}, {c5}; "
            f"{DECODE_STEPS} decode steps: {err_dec:.3g}, K4, K5 launches "
            f"{d4}, {d5}")
        check((c4, c5) == (n_hybrid * n_chunks, n_slots * n_chunks),
              f"K4, K5 launched {c4}, {c5} times in the chunked prefill")
        check((d4, d5) == (0, 0), f"decode launched K4, K5 {d4}, {d5} times")
        check(err_last <= 1e-3 and err_dec <= 1e-3,
              f"chunked prefill / decode logits off by {err_last}, "
              f"{err_dec} (> 1e-3)")
        summary.update(chunked_prefill_max_abs_diff=err_last,
                       decode_max_abs_diff=err_dec,
                       launches_chunked_prefill={"K4": c4, "K5": c5},
                       launches_decode={"K4": d4, "K5": d5})
        del caches, ref, steps, last

        # ---- (iii) a check by decode: prefill against 32 decode steps ---
        short = tokens[:1, :32]
        full, s4, s5 = forward(cfg32, short)
        r1_check = route1["last"]
        caches = M.init_caches(cfg32, batch=1, cache_len=32,
                               dtype=torch.float32, device="cuda")
        steps = []

        def decode_short():
            nonlocal caches
            for t in range(short.shape[1]):
                lg, caches = M.sequential_decode_step(
                    params, cfg32, short[:, t:t + 1], caches, t)
                steps.append(lg[:, 0])

        _, e4, e5 = counted(decode_short)
        err_check = max((lg - full[:, t]).abs().max().item()
                        for t, lg in enumerate(steps))
        log(f"(iii) B=1, 32 tokens: kernel prefill (K4, K5 launches {s4}, "
            f"{s5}) against 32 decode steps from an empty cache (K4, K5 "
            f"launches {e4}, {e5}): max abs {err_check:.3g}")
        check((s4, s5, e4, e5) == (n_hybrid, n_slots, 0, 0),
              f"the decode check launched K4, K5 {s4}, {s5} / {e4}, {e5} "
              f"times")
        check(err_check <= 1e-3,
              f"prefill vs decode logits off by {err_check} (> 1e-3)")
        summary.update(decode_check_max_abs_diff=err_check,
                       launches_decode_check={"K4": s4 + e4, "K5": s5 + e5},
                       # on route 1; decode and serving launch no K4
                       k4_route1={"prefill_f32": r1_f32,
                                  "prefill_bf16": r1_bf16,
                                  "chunked_prefill": r1_chunks,
                                  "decode_check": r1_check})
        del caches, steps, full

    # ---- (iv) serving: continuous batching against standalone decode ----
    rng = np.random.default_rng(1)
    prompts = [lm.sample(rng, 1, int(n))[0][0].tolist()
               for n in rng.integers(8, 25, 6)]
    sv = serve_and_check(params, cfg32, prompts, 8, 64, counters, torch)
    check(sv["launches"] == {"K4": 0, "K5": 0},
          f"serving launched {sv['launches']}")
    log(f"(iv) ServingEngine: 6 requests (prompts "
        f"{[len(p) for p in prompts]}), 8 new tokens each, in "
        f"{sv['s']:.2f}s: {sv['generated_per_s']:.2f} generated tokens/s, "
        f"{sv['fed_per_s']:.2f} tokens fed/s; logits within "
        f"{sv['worst']:.3g} of standalone decode; {sv['checked']}/48 "
        f"tokens with a top-2 gap > 1e-3 all equal; smallest gap "
        f"{sv['min_gap']:.3g}")
    summary.update(serving_logits_max_abs_diff=sv["worst"],
                   serving_min_top2_gap=sv["min_gap"],
                   serving_tokens_checked=sv["checked"],
                   serving_s=sv["s"],
                   decode_tokens_per_s=sv["generated_per_s"],
                   decode_tokens_fed_per_s=sv["fed_per_s"],
                   launches_serving=sv["launches"],
                   wall_s=time.perf_counter() - t_phase)
    print(json.dumps({"slice_hybrid": summary}), flush=True)
    return summary


# ------------------- the expert combine (C): olmoe-1b-7b -------------------

# (name, T, experts, top-k, d, dtype, routing, capacity factor): see phase C
COMBINE_SHAPES = (
    ("train_none_dropped", 4096, 64, 8, 2048, "bfloat16", "even", 1.25),
    ("train_69pct_dropped", 4096, 64, 8, 2048, "bfloat16", "hot16", 1.25),
    ("train_all_dropped", 4096, 64, 8, 2048, "bfloat16", "none", 1.25),
    ("prefill_f32", 8192, 64, 8, 2048, "float32", "hot16", 1.25),
    ("decode_f32", 4, 64, 8, 2048, "float32", "random", 8.0),
)
COMBINE_TIMED = COMBINE_SHAPES[:3]        # a training microbatch's
COMBINE_TRAIN = (4, 4, 1024, 4)           # phase C (iii): layers, B, S, M


def combine_inputs(shape, seed, torch):
    """(y, slot, w, dout) of one ``COMBINE_SHAPES`` entry as ``_moe_ffn``
    makes them: slot from ``moe.dispatch`` at the shape's capacity, w the
    renormalised top-k weights masked by keep, in the shape's dtype.
    ``even`` spreads the routes over the experts (none dropped),
    ``hot16`` puts each token on 8 of 16 experts (~69% dropped, as the
    benchmark's random router does), ``random`` on k of all of them, and
    ``none`` sends every route to the trash row (as on a tensor shard
    that owns none of the experts)."""
    from repro_torch.models import moe
    _, T, E, k, d, dtype, rule, cf = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = moe.capacity(T, types.SimpleNamespace(
        moe_top_k=k, num_experts=E, capacity_factor=cf))
    if rule == "even":
        top_e = (torch.arange(T * k, device="cuda") % E).reshape(T, k)
    else:
        pool = E if rule == "random" else 16
        top_e = torch.rand((T, pool), generator=g,
                           device="cuda").argsort(-1)[:, :k]
    keep, local, slot = moe.dispatch(top_e, E, C)
    top_w = torch.rand((T, k), generator=g, device="cuda") + 0.05
    top_w = top_w / top_w.sum(-1, keepdim=True)
    w = (top_w.reshape(-1) * keep * local).to(dt).reshape(T, k)
    slot = slot.reshape(T, k)
    if rule == "none":
        slot, w = torch.full_like(slot, E * C), torch.zeros_like(w)
    y = torch.randn((E * C, d), generator=g, device="cuda").to(dt)
    dout = torch.randn((T, d), generator=g, device="cuda").to(dt)
    return y, slot, w, dout


def combine_vs_plain(shape, torch, cops, cref):
    """Phase C (i) at one shape: the kernels' output and both gradients
    against the plain version's and the exact (f64) values. Returns the
    shape's figures."""
    y, slot, w, dout = combine_inputs(shape, 7, torch)
    rows = y.shape[0]
    # one rounding to the dtype, relative (unit roundoff)
    rnd = 2.0 ** -8 if y.dtype == torch.bfloat16 else 2.0 ** -24

    def through(fn):
        yl, wl = (t.clone().requires_grad_(True) for t in (y, w))
        out = fn(yl, slot, wl)
        return (out.detach(), *torch.autograd.grad(out, (yl, wl), dout))

    n0 = cops.combine_forward.launches, cops.combine_backward.launches
    out, dy, dw = through(cops.moe_combine)
    n = (cops.combine_forward.launches - n0[0],
         cops.combine_backward.launches - n0[1])
    p_out, p_dy, p_dw = through(cref.combine_reference)
    again = [cops.combine_backward(dout, y, slot, w) for _ in range(2)]
    tok = torch.cat([y.double(), y.new_zeros((1, y.shape[1]),
                                             dtype=torch.float64)])[slot]
    prod = tok * w.double()[..., None]                       # [T, k, d]
    want, scale = prod.sum(1), prod.abs().sum(1)
    prod = tok * dout.double()[:, None]
    dw_want, dw_scale = prod.sum(-1), prod.abs().sum(-1)
    del tok, prod
    owned = torch.zeros(rows, dtype=torch.bool, device="cuda")
    owned[slot[slot < rows]] = True
    unowned = dy[~owned]
    # out: k products summed in f32, rounded once (the f32 sum's error is
    # below 1e-6 of the scale); dw: 2,048 products, 64 summed in a lane,
    # then 5 levels of a warp's tree: (64 + 5) x 2^-24 ~ 4.1e-6 of the
    # scale at worst, held at 1e-5. The plain version rounds each product
    # to the dtype before its f32 sum, so it lies up to 2 roundings of the
    # scale from the exact value: 3 roundings from the kernels'
    out_err = (out.double() - want).abs()
    dw_err = (dw.double() - dw_want).abs()
    out_plain = (out.double() - p_out.double()).abs()
    dw_plain = (dw.double() - p_dw.double()).abs()
    fig = {
        "name": shape[0], "T": slot.shape[0], "rows": rows,
        "d": y.shape[1], "dtype": str(y.dtype).split(".")[-1],
        "dropped_share": 1.0 - int((slot < rows).sum()) / slot.numel(),
        "out_max_abs_err": out_err.max().item(),
        "out_max_abs_vs_plain": out_plain.max().item(),
        "dw_max_abs_err": dw_err.max().item(),
        "dw_max_abs_vs_plain": dw_plain.max().item(),
        "dy_equal_plain": bool(torch.equal(dy, p_dy)),
        "unowned_rows": int((~owned).sum())}
    log(f"C (i) {shape[0]}: T={fig['T']} rows={rows} {fig['dtype']}, "
        f"{100 * fig['dropped_share']:.1f}% of routes at the trash row: "
        f"out {fig['out_max_abs_err']:.3g} from exact "
        f"({fig['out_max_abs_vs_plain']:.3g} from plain), dw "
        f"{fig['dw_max_abs_err']:.3g} ({fig['dw_max_abs_vs_plain']:.3g}), "
        f"dy bit for bit {fig['dy_equal_plain']}, "
        f"{fig['unowned_rows']} rows no route owns")
    what = f"moe_combine at {shape[0]}"
    check(n == (1, 1), f"{what}: {n} forward / backward launches, not one "
          f"each")
    check(bool((out_err <= rnd * want.abs() + 1e-6 * scale).all()),
          f"{what}: out farther than one rounding from the exact sum")
    check(bool((out_plain <= (3 * rnd + 2e-6) * scale).all()),
          f"{what}: out farther from the plain version than its roundings")
    check(fig["dy_equal_plain"], f"{what}: dy is not the plain one's bit "
          f"for bit")
    check(bool((unowned == 0).all()) and not bool(
        torch.signbit(unowned).any()), f"{what}: a row no route owns is not "
          f"exactly 0 in dy")
    check(bool((dw_err <= rnd * dw_want.abs() + 1e-5 * dw_scale).all()),
          f"{what}: dw farther than one rounding from the exact dot")
    check(bool((dw_plain <= (3 * rnd + 2e-5) * dw_scale).all()),
          f"{what}: dw farther from the plain version than its roundings")
    check(bool((dw[slot >= rows] == 0).all()), f"{what}: dw not 0 at the "
          f"trash row")
    check(all(torch.equal(a, b) for a, b in zip(again[0], again[1]))
          and torch.equal(again[0][0], dy) and torch.equal(again[0][1], dw),
          f"{what}: two backward calls differ")
    return fig


def combine_timings(shape, torch, cops, cref):
    """Phase C (ii): one call's device time of each pass at one shape
    (median of 30, L2 flushed, ``time_ms``), beside the plain version's
    and the bound: the bytes the pass must move at 3.35 TB/s. The forward
    reads the kept rows of y and slot and w, and writes out; the backward
    writes every row of dy, reads dout of the tokens with a kept route,
    the kept rows of y (for dw), slot and w, writes dw, and writes its
    owner map (4 bytes a row, and a route's index at a kept row) and
    reads it back. The kernels are timed by calling ``combine_forward``
    and ``combine_backward``, which make the launches ``moe_combine``
    and its backward make: through autograd a backward takes ~150 us of
    host work, which can outlast ``time_ms``'s head start, and host
    stalls then entered the reading (medians 1.9x and 2.5x the time
    alone in two runs); the plain version, 0.4 ms a pass or more, is
    timed through autograd."""
    y, slot, w, dout = combine_inputs(shape, 7, torch)
    (T, k), (rows, d), es = slot.shape, y.shape, y.element_size()
    kept = int((slot < rows).sum())
    tokens = int((slot < rows).any(1).sum())
    moved = {"fwd": es * d * (kept + T) + T * k * (8 + es),
             "bwd": (es * d * (rows + tokens + kept) + T * k * (8 + 2 * es)
                     + 4 * (2 * rows + kept))}

    yl, wl = (t.clone().requires_grad_(True) for t in (y, w))
    plain = cref.combine_reference(yl, slot, wl)
    with torch.no_grad():
        fwd = (time_ms(lambda: cops.combine_forward(y, slot, w), torch),
               time_ms(lambda: cref.combine_reference(y, slot, w), torch))
    bwd = (time_ms(lambda: cops.combine_backward(dout, y, slot, w), torch),
           time_ms(lambda: torch.autograd.grad(plain, (yl, wl), dout,
                                               retain_graph=True), torch))
    out = {"name": shape[0], "dropped_share": 1.0 - kept / (T * k)}
    for name, (ms, plain_ms) in (("fwd", fwd), ("bwd", bwd)):
        out.update({f"{name}_ms": ms, f"{name}_plain_ms": plain_ms,
                    f"{name}_bound_ms": 1e3 * moved[name] / HBM_BYTES_PER_S,
                    f"{name}_mb": moved[name] / 1e6})
    log(f"C (ii) {shape[0]} ({100 * out['dropped_share']:.1f}% dropped): "
        f"forward {fwd[0]:.4f} ms (bound {out['fwd_bound_ms']:.4f}, plain "
        f"{fwd[1]:.4f}), backward {bwd[0]:.4f} ms (bound "
        f"{out['bwd_bound_ms']:.4f}, plain {bwd[1]:.4f})")
    return out


def combine_engine_steps(torch, cops):
    """Phase C (iii): the combine's launches in two train steps of the
    engine at olmoe-1b-7b's widths cut to ``COMBINE_TRAIN``'s layers.
    Returns the phase's figures."""
    import numpy as np
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline_step import make_train_step
    L, B, S, Mb = COMBINE_TRAIN
    cfg = get_config("olmoe-1b-7b").with_overrides(
        num_layers=L, tensor_parallel=1, use_flash_attention=1,
        stash_depth=2, aggregate_every=2)
    n_slots = cfg.pipeline_stages * cfg.layers_per_stage
    check(n_slots == L and cfg.slot_layout == ("moe",)
          and cfg.d_model == 2048 and cfg.num_experts == 64
          and cfg.moe_top_k == 8, f"olmoe-1b-7b cut to {L} layers: {cfg}")
    mesh = make_debug_mesh(1, cfg.pipeline_stages, 1, device="cuda")
    step_fn, _ = make_train_step(mesh, cfg, TrainConfig(
        learning_rate=ENGINE_TRAIN_LR, optimizer="adam", microbatches=Mb,
        remat=True, weight_decay=0.0))
    x, lab = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).sample(
        np.random.default_rng(3), B, S)
    batch = {"tokens": torch.as_tensor(x, device="cuda"),
             "labels": torch.as_tensor(lab, device="cuda")}
    state = step_fn.init_state(M.init_params(0, cfg, device="cuda"))
    found, counts, losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with checked_blends(found, torch):
        for _ in range(2):
            cops.combine_forward.launches = 0
            cops.combine_backward.launches = 0
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            counts.append((cops.combine_forward.launches,
                           cops.combine_backward.launches))
            losses.append(float(m["loss"]))
    want = (2 * n_slots * Mb, n_slots * Mb)
    fig = {"config": f"{cfg.name} num_layers={L}", "B": B, "S": S,
           "microbatches": Mb, "launches_per_step": counts,
           "launches_want": want, "losses": losses, "blends": found,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"C (iii) engine train steps, {fig['config']}, B={B} S={S} M={Mb}, "
        f"remat: combine launches (forward, backward) a step {counts} "
        f"(want {want}); losses {losses}; blends (leaves, last stage new, "
        f"earlier stages 0.5) {found}; peak {fig['peak_gb']:.2f} GB")
    check(all(c == want for c in counts), f"engine steps launched the "
          f"combine {counts} times, not {want} a step")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(len(found) == 1 and found[0][0] > 0 and found[0][1]
          and found[0][2], f"the blend at step 2: {found}")
    del state, batch
    return fig


def combine_phase(torch, cops, cref):
    """Phase C: returns (per-shape checks, engine steps, timings)."""
    t_phase = time.perf_counter()
    checks = [combine_vs_plain(sh, torch, cops, cref)
              for sh in COMBINE_SHAPES]
    times = [combine_timings(sh, torch, cops, cref) for sh in COMBINE_TIMED]
    free_card(torch)
    steps = combine_engine_steps(torch, cops)
    free_card(torch)
    log(f"phase C took {time.perf_counter() - t_phase:.1f}s")
    return checks, steps, times


# ----------------------- the MoE slice (M): olmoe-1b-7b -------------------

@contextlib.contextmanager
def recorded_routes(store):
    """Every ``moe.route`` call's router probabilities and top-k experts,
    appended to ``store`` in call order (one entry a MoE layer). The
    smoke's recorder: the package reads no switch for it."""
    from repro_torch.models import moe
    route = moe.route

    def recording(p, xt, k):
        out = route(p, xt, k)
        store.append((out[0], out[2]))
        return out

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def route_diff(a, b, cfg):
    """Two runs' recorded routes of one MoE layer: (routes whose expert
    differs, [T] mask of the tokens whose experts or drops differ, the
    largest |router probability difference|). Drops are the package's
    own rule (``moe.dispatch``) at this layer's capacity."""
    from repro_torch.models import moe
    (pa, ea), (pb, eb) = a, b
    T, k = ea.shape
    C = moe.capacity(T, cfg)
    ka, kb = (moe.dispatch(e, cfg.num_experts, C)[0].reshape(T, k)
              for e in (ea, eb))
    hit = ((ea != eb) | (ka != kb)).any(dim=-1)
    return int((ea != eb).sum()), hit, (pa - pb).abs().max().item()


def routes_diff(ra, rb, cfg):
    """Whole-forward ``route_diff``: (routes that differ over all layers,
    (layer, token) pairs whose experts or drops differ, largest |router
    probability difference|)."""
    n_routes, n_tokens, dprob = 0, 0, 0.0
    for a, b in zip(ra, rb):
        r, hit, dp = route_diff(a, b, cfg)
        n_routes, n_tokens = n_routes + r, n_tokens + int(hit.sum())
        dprob = max(dprob, dp)
    return n_routes, n_tokens, dprob


def moe_slot_updates(params, cfg, tokens):
    """``cfg``'s forward slot by slot: each ``Moe`` slot with K4 against the
    plain slot (``use_flash_attention=0``) on the same input, the kernel
    slot's output feeding the next. A token whose routes or drops differ
    between the two (a near-tie of the router flipped by the attention's
    rounding) is counted and left out; over the others, the updates
    (output - input) differ by ``err``: the largest |difference| in f32,
    the largest relative L2 over a slot in bf16. The router probabilities,
    which are continuous, are held over every token (``dprob``). Launches
    here are comparisons, not counted."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import modules
    from repro_torch.models.blocks import BLOCKS, BlockCtx
    dtype = modules.dtype_of(cfg.dtype)
    x, positions, _ = M.embed(params, cfg, tokens, dtype=dtype)
    pm = M.pad_mask(cfg, device=x.device)
    plain = cfg.with_overrides(use_flash_attention=0)
    out = {"err": 0.0, "routes": 0, "tokens": 0, "dprob": 0.0,
           "of_tokens": 0}
    for s in range(cfg.pipeline_stages):
        for j, t in enumerate(cfg.slot_layout):
            p = M._slot_params(params["blocks"][j], s)
            ra, rb = [], []
            with recorded_routes(ra):
                y, _ = BLOCKS[t].apply(p, x, BlockCtx(
                    cfg=cfg, positions=positions, dtype=dtype,
                    active=pm[s, j]))
            with recorded_routes(rb):
                yp, _ = BLOCKS[t].apply(p, x, BlockCtx(
                    cfg=plain, positions=positions, dtype=dtype,
                    active=pm[s, j]))
            r, hit, dp = route_diff(ra[0], rb[0], cfg)
            same = ~hit.reshape(x.shape[:2])
            du = (y.float() - x.float())[same]
            dpl = (yp.float() - x.float())[same]
            err = ((du - dpl).abs().max().item() if dtype == torch.float32
                   else ((du - dpl).norm() / dpl.norm()).item())
            out["err"] = max(out["err"], err)
            out["dprob"] = max(out["dprob"], dp)
            out["routes"] += r
            out["tokens"] += int(hit.sum())
            out["of_tokens"] += hit.numel()
            x = y
    return out


def moe_phase(torch, fops, cops):
    """Phase M: prefill, chunked prefill + decode, and serving, at the full
    width of olmoe-1b-7b on the card. Returns its summary."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg = get_config("olmoe-1b-7b").with_overrides(tensor_parallel=1,
                                                   use_flash_attention=1)
    check(cfg.num_layers == 16 and cfg.d_model == 2048
          and cfg.num_heads == cfg.num_kv_heads == 16 and cfg.head_dim == 128
          and cfg.num_experts == 64 and cfg.moe_top_k == 8
          and cfg.d_ff == 1024 and cfg.vocab_size == 50_304
          and cfg.capacity_factor == 1.25 and cfg.pipeline_stages == 4
          and cfg.slot_layout == ("moe",) * 4,
          f"olmoe-1b-7b at its published widths: {cfg}")
    cfg32 = cfg.with_overrides(dtype="float32")
    n_slots = cfg.pipeline_stages * cfg.layers_per_stage
    params = M.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == OLMOE_PARAMETERS, f"{n_params:,} parameters, not "
          f"{OLMOE_PARAMETERS:,}")
    lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=0)
    toks, _ = lm.sample(np.random.default_rng(0), PREFILL_B,
                        PREFILL_S + DECODE_STEPS)
    tokens = torch.as_tensor(toks, device="cuda")
    prompt = tokens[:, :PREFILL_S]
    log(f"{cfg.name}: {n_params:,} parameters (f32), {n_slots} moe slots "
        f"of {cfg.num_experts} experts, top-{cfg.moe_top_k}, capacity "
        f"factor {cfg.capacity_factor}; prompts [{PREFILL_B}, {PREFILL_S}] "
        f"from SyntheticLM")
    summary = {"config": f"{cfg.name} tensor_parallel=1 "
                         f"use_flash_attention=1", "parameters": n_params}

    combined = {}                      # the combine's launches, by run

    def reset_combine():
        cops.combine_forward.launches = cops.combine_backward.launches = 0

    def read_combine(name):
        combined[name] = (cops.combine_forward.launches,
                          cops.combine_backward.launches)

    def forward(c, toks_, name):
        """(logits, aux, recorded routes, K4 launches, of them on route 1)
        of one sequential_lm_forward; the counts (and the combine's, kept
        under ``name``) are set to 0 just before, read just after."""
        reset_k4(K)
        reset_combine()
        routes = []
        with recorded_routes(routes):
            logits, aux, _ = M.sequential_lm_forward(params, c, toks_)
        torch.cuda.synchronize()
        read_combine(name)
        return logits, aux, routes, K.launches, K.launches_route1

    def rel_l2(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    with torch.no_grad():
        # ---- (i) prefill: K4 against the plain attention path ----------
        t0 = time.perf_counter()
        kern, aux, rk, n, r1_f32 = forward(cfg32, prompt, "prefill_f32")
        prefill32_s = time.perf_counter() - t0
        plain, _, rp, n0, _ = forward(
            cfg32.with_overrides(use_flash_attention=0), prompt,
            "prefill_f32_plain")
        check(n == n_slots and r1_f32 == 0 and n0 == 0,
              f"f32 prefill: {n} K4 launches with flash ({r1_f32} on route "
              f"1), {n0} without")
        check(bool(torch.isfinite(kern).all()) and math.isfinite(float(aux)),
              "non-finite f32 logits or aux")
        err = (kern - plain).abs().max().item()
        flips, hit, dprob = routes_diff(rk, rp, cfg32)
        log(f"(i) f32 prefill B={PREFILL_B} S={PREFILL_S}: max |logit "
            f"flash - plain| {err:.3g}; routes that differ {flips} of "
            f"{n_slots * PREFILL_B * PREFILL_S * cfg.moe_top_k} ((layer, "
            f"token) pairs with other experts or drops: {hit}), largest "
            f"|router prob difference| {dprob:.3g}; aux {float(aux):.4f}; "
            f"K4 launches {n}; {prefill32_s * 1e3:.1f} ms (the phase's "
            f"first forward)")
        summary.update(prefill_f32_max_abs_diff=err,
                       prefill_f32_routes_differing=flips,
                       prefill_f32_tokens_differing=hit,
                       prefill_f32_router_prob_max_diff=dprob,
                       prefill_f32_ms=prefill32_s * 1e3, aux_f32=float(aux))
        if flips == 0 and hit == 0:
            check(err <= 1e-3, f"f32 prefill logits differ by {err} "
                  f"(> 1e-3) with the same routes")
        else:
            sl = moe_slot_updates(params, cfg32, prompt)
            log(f"(i) f32 slot by slot: routes differing {sl['routes']}, "
                f"tokens left out {sl['tokens']} of {sl['of_tokens']}, "
                f"the others' updates within {sl['err']:.3g}, router "
                f"probabilities within {sl['dprob']:.3g}")
            check(sl["err"] <= 1e-3 and sl["dprob"] <= MOE_PROB_TOL[
                "float32"], f"f32 slot by slot: updates {sl['err']} "
                f"(> 1e-3) or router probabilities {sl['dprob']} (> "
                f"{MOE_PROB_TOL['float32']}) apart")
            summary.update(prefill_f32_slot_max_abs_diff=sl["err"],
                           prefill_f32_slot_router_prob_max_diff=sl["dprob"],
                           prefill_f32_slot_routes_differing=sl["routes"],
                           prefill_f32_slot_tokens_left_out=sl["tokens"])
        kern32 = kern
        del plain, rk, rp
        forward(cfg, prompt, "warm_up")                    # warm-up
        t0 = time.perf_counter()
        kern, aux16, rk, n16, r1_bf16 = forward(cfg, prompt, "prefill_bf16")
        prefill_s = time.perf_counter() - t0
        plain, _, rp, n0, _ = forward(
            cfg.with_overrides(use_flash_attention=0), prompt,
            "prefill_bf16_plain")
        check(n16 == r1_bf16 == n_slots and n0 == 0,
              f"bf16 prefill: {n16} K4 launches with flash ({r1_bf16} on "
              f"route 1), {n0} without")
        check(bool(torch.isfinite(kern).all())
              and math.isfinite(float(aux16)), "non-finite bf16 logits/aux")
        rel = rel_l2(kern, plain)
        rel_f32 = rel_l2(kern, kern32)
        top1 = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        flips16, hit16, dprob16 = routes_diff(rk, rp, cfg)
        log(f"(i) bf16 prefill: rel L2 {rel:.3g} from the plain forward "
            f"(the f32 forward {rel_f32:.3g} away), top-1 agreement "
            f"{top1:.4f}; routes that differ {flips16}, (layer, token) "
            f"pairs {hit16}; {PREFILL_B * PREFILL_S / prefill_s:,.0f} "
            f"tokens/s ({prefill_s * 1e3:.1f} ms)")
        summary.update(prefill_bf16_rel_l2=rel,
                       prefill_bf16_rel_l2_vs_f32=rel_f32,
                       prefill_bf16_top1_agreement=top1,
                       prefill_bf16_routes_differing=flips16,
                       prefill_bf16_tokens_differing=hit16,
                       prefill_bf16_ms=prefill_s * 1e3,
                       prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s)
        del kern32, rk, rp
        if flips16 == 0 and hit16 == 0:
            check(rel <= 2e-2, f"bf16 prefill rel L2 {rel} (> 2e-2)")
        else:
            # as phase Z: each slot held on the same input, and the whole
            # forward no farther from plain than bf16 puts it from f32
            sl = moe_slot_updates(params, cfg, prompt)
            log(f"(i) bf16 slot by slot: routes differing {sl['routes']}, "
                f"tokens left out {sl['tokens']} of {sl['of_tokens']}, "
                f"the others' updates within {sl['err']:.3g} (rel L2), "
                f"router probabilities within {sl['dprob']:.3g}")
            check(sl["err"] <= 2e-2 and sl["dprob"] <= MOE_PROB_TOL[
                "bfloat16"], f"bf16 slot by slot: updates {sl['err']} "
                f"(rel L2 > 2e-2) or router probabilities {sl['dprob']} "
                f"(> {MOE_PROB_TOL['bfloat16']}) apart")
            check(rel <= rel_f32, f"bf16 prefill rel L2 {rel} from the "
                  f"plain forward, above the f32 forward's {rel_f32}")
            summary.update(prefill_bf16_slot_max_rel_l2=sl["err"],
                           prefill_bf16_slot_router_prob_max_diff=sl["dprob"],
                           prefill_bf16_slot_routes_differing=sl["routes"],
                           prefill_bf16_slot_tokens_left_out=sl["tokens"])
        del kern, plain

        # ---- (ii) chunked prefill + decode at capacity factor 8 ---------
        # (decode never drops, T <= 8; the full forward then neither)
        cfg8 = cfg32.with_overrides(capacity_factor=8.0)
        caches = M.init_caches(cfg8, batch=PREFILL_B,
                               cache_len=PREFILL_S + DECODE_STEPS,
                               dtype=torch.float32, device="cuda")
        reset_k4(K)
        reset_combine()
        last = prefill_chunks(params, cfg8, prompt, caches, CHUNK)
        torch.cuda.synchronize()
        n_chunks = K.launches
        read_combine("chunked_prefill")
        reset_k4(K)
        reset_combine()
        steps = []
        for t in range(DECODE_STEPS):
            lg, caches = M.sequential_decode_step(
                params, cfg8, tokens[:, PREFILL_S + t:PREFILL_S + t + 1],
                caches, PREFILL_S + t)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        n_decode = K.launches
        read_combine("decode")
        ref = M.sequential_lm_forward(params, cfg8, tokens)[0][
            :, PREFILL_S - 1:]
        err_last = (last - ref[:, 0]).abs().max().item()
        err_dec = max((lg - ref[:, 1 + t]).abs().max().item()
                      for t, lg in enumerate(steps))
        log(f"(ii) capacity factor 8: {PREFILL_S // CHUNK} chunks of "
            f"{CHUNK}: last logits {err_last:.3g} from a flash forward, K4 "
            f"launches {n_chunks}; {DECODE_STEPS} decode steps: "
            f"{err_dec:.3g}, K4 launches {n_decode}")
        check(n_chunks == n_slots * PREFILL_S // CHUNK,
              f"{n_chunks} K4 launches in the chunked prefill")
        check(n_decode == 0, f"decode launched K4 {n_decode} times")
        check(err_last <= 1e-3 and err_dec <= 1e-3,
              f"chunked prefill / decode logits off by {err_last}, "
              f"{err_dec} (> 1e-3)")
        summary.update(chunked_prefill_max_abs_diff=err_last,
                       decode_max_abs_diff=err_dec)
        del caches, ref, steps, last

    # ---- (iii) serving: continuous batching against standalone decode ---
    rng = np.random.default_rng(1)
    prompts = [lm.sample(rng, 1, int(n))[0][0].tolist()
               for n in rng.integers(8, 65, 8)]
    sv = serve_and_check(params, cfg32, prompts, 16, 128, {
        "K4": K, "combine_fwd": cops.combine_forward,
        "combine_bwd": cops.combine_backward}, torch)
    check(sv["launches"]["K4"] == 0,
          f"serving launched K4 {sv['launches']['K4']} times")
    combined["serving"] = (sv["launches"]["combine_fwd"],
                           sv["launches"]["combine_bwd"])
    # a forward, a chunk, a decode step: one combine forward a MoE slot
    per_call = {"chunked_prefill": PREFILL_S // CHUNK,
                "decode": DECODE_STEPS}
    log(f"expert combine launches (forward, backward) by run: {combined}")
    for name, (f, b) in combined.items():
        want = n_slots * per_call.get(name, 1)
        check(b == 0 and (f == want or name == "serving" and f > 0
                          and f % n_slots == 0),
              f"{name}: the combine launched {f} forwards and {b} "
              f"backwards, not {want} and 0")
    log(f"(iii) ServingEngine: 8 requests (prompts "
        f"{[len(p) for p in prompts]}), 16 new tokens each, in "
        f"{sv['s']:.2f}s: {sv['generated_per_s']:.1f} generated tokens/s, "
        f"{sv['fed_per_s']:.1f} tokens fed/s; logits within "
        f"{sv['worst']:.3g} of standalone decode; {sv['checked']}/128 "
        f"tokens with a top-2 gap > 1e-3 all equal; smallest gap "
        f"{sv['min_gap']:.3g}")
    summary.update(serving_logits_max_abs_diff=sv["worst"],
                   serving_min_top2_gap=sv["min_gap"],
                   serving_tokens_checked=sv["checked"],
                   serving_s=sv["s"],
                   decode_tokens_per_s=sv["generated_per_s"],
                   decode_tokens_fed_per_s=sv["fed_per_s"],
                   combine_launches=combined,
                   k4_launches={"prefill_f32": n, "prefill_bf16": n16,
                                "chunked_prefill": n_chunks,
                                "decode": n_decode,
                                "serving": sv["launches"]["K4"]},
                   # on route 1; decode and serving launch no K4
                   k4_route1={"prefill_f32": r1_f32,
                              "prefill_bf16": r1_bf16},
                   wall_s=time.perf_counter() - t_phase)
    log(f"phase M took {summary['wall_s']:.1f}s")
    print(json.dumps({"slice_moe": summary}), flush=True)
    return summary


# ------------------------ the xLSTM slice (X): xlstm-125m -----------------

@contextlib.contextmanager
def timed_slstm(acc):
    """Each sLSTM mixer's wall time (synchronised before and after),
    appended to ``acc``: the smoke's instrument, which the package reads
    no switch for."""
    import torch
    from repro_torch.models import xlstm
    mixer = xlstm.slstm_mixer

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mixer(*a, **kw)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out

    xlstm.slstm_mixer = timed
    try:
        yield
    finally:
        xlstm.slstm_mixer = mixer


def decode_batch_rounding(params, cfg, tokens, torch):
    """How far the batch shape alone moves a decode: ``tokens`` stepped
    through ``sequential_decode_step`` from ``init_caches`` at batch 1 and
    at batch 4 (the same tokens in every row); the largest |logit
    difference| of row 0 over the steps."""
    from repro_torch.models import model as M
    rows = {}
    with torch.no_grad():
        for B in (1, 4):
            caches = M.init_caches(cfg, batch=B, cache_len=len(tokens),
                                   dtype=torch.float32, device="cuda")
            rows[B] = []
            for pos, tok in enumerate(tokens):
                lg, caches = M.sequential_decode_step(
                    params, cfg, [[tok]] * B, caches, pos)
                rows[B].append(lg[0, 0])
    return max((a - b).abs().max().item() for a, b in zip(rows[1], rows[4]))


def slot_chunk_updates(params, cfg, tokens, chunk, n_prompt):
    """Slot by slot in f32: each slot's chunk and step forms against its
    parallel form on the same input. The slot's ``apply`` over all of
    ``tokens``' positions; then, from ``init_cache``, ``prefill_chunk``
    over the first ``n_prompt`` positions in chunks of ``chunk`` and
    ``step`` over the rest; the apply's output feeds the next slot.
    Returns the largest |difference| at any position."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.blocks import BLOCKS, BlockCtx
    f32 = torch.float32
    x, positions, _ = M.embed(params, cfg, tokens, dtype=f32)
    B, S = tokens.shape
    pm = M.pad_mask(cfg, device=x.device)
    worst = 0.0
    with torch.no_grad():
        for s in range(cfg.pipeline_stages):
            for j, t in enumerate(cfg.slot_layout):
                slot, p = BLOCKS[t], M._slot_params(params["blocks"][j], s)
                y, _ = slot.apply(p, x, BlockCtx(
                    cfg=cfg, positions=positions, dtype=f32,
                    active=pm[s, j]))
                cache = slot.init_cache(cfg, B, S, f32, x.device)
                outs = []
                for q in range(0, S):
                    if q < n_prompt and q % chunk:
                        continue
                    form, width = ((slot.prefill_chunk, chunk)
                                   if q < n_prompt else (slot.step, 1))
                    o, cache = form(p, x[:, q:q + width], cache, BlockCtx(
                        cfg=cfg, pos=q, dtype=f32, active=pm[s, j]))
                    outs.append(o)
                worst = max(worst, (torch.cat(outs, dim=1) - y).abs().max()
                            .item())
                x = y
    return worst


def xlstm_phase(torch, fops):
    """Phase X: prefill, chunked prefill + decode, and serving, at the full
    width of xlstm-125m on the card (no kernel: the recurrences are plain
    PyTorch, as the JAX package's are plain JAX). Returns its summary."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg = get_config("xlstm-125m").with_overrides(tensor_parallel=1,
                                                  use_flash_attention=1)
    check(cfg.num_layers == 12 and cfg.d_model == 768 and cfg.num_heads == 4
          and cfg.ssm_expand == 2 and cfg.pipeline_stages == 4
          and cfg.vocab_size == 50_304
          and cfg.slot_layout == ("mlstm", "slstm", "mlstm"),
          f"xlstm-125m at its published widths: {cfg}")
    cfg32 = cfg.with_overrides(dtype="float32")
    params = M.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == XLSTM_PARAMETERS, f"{n_params:,} parameters, not "
          f"{XLSTM_PARAMETERS:,}")
    lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=0)
    toks, _ = lm.sample(np.random.default_rng(0), PREFILL_B,
                        PREFILL_S + DECODE_STEPS)
    tokens = torch.as_tensor(toks, device="cuda")
    prompt = tokens[:, :PREFILL_S]
    log(f"{cfg.name}: {n_params:,} parameters (f32), 4 stages of "
        f"{cfg.slot_layout}; prompts [{PREFILL_B}, {PREFILL_S}] from "
        f"SyntheticLM")
    summary = {"config": f"{cfg.name} tensor_parallel=1 "
                         f"use_flash_attention=1", "parameters": n_params}

    def forward(c, toks_):
        reset_k4(K)
        logits = M.sequential_lm_forward(params, c, toks_)[0]
        torch.cuda.synchronize()
        return logits, K.launches

    with torch.no_grad():
        # ---- (i) prefill in f32 and bf16 --------------------------------
        t0 = time.perf_counter()
        full32, n = forward(cfg32, prompt)
        prefill32_s = time.perf_counter() - t0
        forward(cfg, prompt)                               # warm-up
        t0 = time.perf_counter()
        full16, n16 = forward(cfg, prompt)
        prefill_s = time.perf_counter() - t0
        acc = []
        with timed_slstm(acc):
            t0 = time.perf_counter()
            forward(cfg, prompt)
            timed_s = time.perf_counter() - t0
        share = sum(acc) / timed_s
        rel = ((full16 - full32).norm() / full32.norm()).item()
        check(bool(torch.isfinite(full32).all())
              and bool(torch.isfinite(full16).all()), "non-finite logits")
        check(n == n16 == 0, f"xLSTM prefill launched K4 {n}, {n16} times")
        log(f"(i) prefill B={PREFILL_B} S={PREFILL_S}: f32 "
            f"{prefill32_s * 1e3:.1f} ms (the phase's first forward), bf16 "
            f"{prefill_s * 1e3:.1f} ms, "
            f"{PREFILL_B * PREFILL_S / prefill_s:,.0f} tokens/s; bf16 "
            f"{rel:.3g} rel L2 from f32; the {len(acc)} sLSTM layers "
            f"{sum(acc) * 1e3:.1f} ms of a synchronised "
            f"{timed_s * 1e3:.1f} ms bf16 forward ({share:.1%}); K4 "
            f"launches {n}, {n16}")
        summary.update(prefill_f32_ms=prefill32_s * 1e3,
                       prefill_bf16_ms=prefill_s * 1e3,
                       prefill_tokens_per_s=PREFILL_B * PREFILL_S / prefill_s,
                       prefill_bf16_rel_l2_vs_f32=rel,
                       slstm_ms=sum(acc) * 1e3,
                       slstm_share_of_prefill=share)
        del full16, full32

        # ---- (ii) chunked prefill into the caches, then decode ----------
        caches = M.init_caches(cfg32, batch=PREFILL_B,
                               cache_len=PREFILL_S + DECODE_STEPS,
                               dtype=torch.float32, device="cuda")
        reset_k4(K)
        t0 = time.perf_counter()
        last = prefill_chunks(params, cfg32, prompt, caches, CHUNK)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        steps = []
        for t in range(DECODE_STEPS):
            lg, caches = M.sequential_decode_step(
                params, cfg32, tokens[:, PREFILL_S + t:PREFILL_S + t + 1],
                caches, PREFILL_S + t)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        n_cd = K.launches
        ref, _ = forward(cfg32, tokens)
        ref = ref[:, PREFILL_S - 1:]
        err_last = (last - ref[:, 0]).abs().max().item()
        err_dec = max((lg - ref[:, 1 + t]).abs().max().item()
                      for t, lg in enumerate(steps))
        del caches, ref, steps, last
        slot_err = slot_chunk_updates(params, cfg32, tokens, CHUNK,
                                      PREFILL_S)
        log(f"(ii) {PREFILL_S // CHUNK} chunks of {CHUNK} "
            f"({chunked_s * 1e3:.1f} ms): last logits {err_last:.3g} from "
            f"the full forward; {DECODE_STEPS} decode steps: {err_dec:.3g}; "
            f"slot by slot, every chunk and step output within "
            f"{slot_err:.3g} of the slot's parallel form on the same "
            f"input; K4 launches {n_cd}")
        check(n_cd == 0, f"chunked prefill / decode launched K4 {n_cd} times")
        check(slot_err <= 1e-3, f"a slot's chunk / step outputs are "
              f"{slot_err} from its parallel form (> 1e-3)")
        check(err_last <= XLSTM_WHOLE_MODEL_TOL
              and err_dec <= XLSTM_WHOLE_MODEL_TOL,
              f"chunked prefill / decode logits off by {err_last}, "
              f"{err_dec} (> {XLSTM_WHOLE_MODEL_TOL})")
        summary.update(chunked_prefill_max_abs_diff=err_last,
                       decode_max_abs_diff=err_dec,
                       chunked_and_decode_slot_max_abs_diff=slot_err)

    # ---- (iii) serving, and a reused slot against a fresh engine --------
    rng = np.random.default_rng(1)
    prompts = [lm.sample(rng, 1, int(n))[0][0].tolist()
               for n in rng.integers(8, 25, 6)]
    sv = serve_and_check(params, cfg32, prompts, 8, 64, {"K4": K}, torch,
                         standalone_batch=4)
    batch_shape = max(decode_batch_rounding(params, cfg32, p + t[:-1], torch)
                      for p, t in zip(prompts, sv["tokens"]))
    check(sv["launches"]["K4"] == 0,
          f"serving launched K4 {sv['launches']['K4']} times")
    # requests 5 and 6 were admitted into slots that earlier requests left
    for i in (4, 5):
        eng = ServingEngine(cfg32, params, max_slots=4, cache_len=64,
                            device="cuda")
        u = eng.submit(prompts[i], max_new_tokens=8)
        alone = eng.run_until_drained()[u]
        check(alone == sv["tokens"][i], f"request {i + 1} in a reused slot "
              f"gave {sv['tokens'][i]}, in a fresh engine {alone}")
    log(f"(iii) ServingEngine: 6 requests (prompts "
        f"{[len(p) for p in prompts]}), 8 new tokens each, in "
        f"{sv['s']:.2f}s: {sv['generated_per_s']:.1f} generated tokens/s, "
        f"{sv['fed_per_s']:.1f} tokens fed/s; logits within "
        f"{sv['worst']:.3g} of standalone decode at batch 4; "
        f"{sv['checked']}/48 tokens with a top-2 gap > 1e-3 all equal; "
        f"smallest gap {sv['min_gap']:.3g}; requests 5, 6 (reused slots) "
        f"equal to a "
        f"fresh engine's; the same tokens decoded at batch 1 and at batch "
        f"4 differ by {batch_shape:.3g} (the batch shape's rounding "
        f"alone)")
    summary.update(serving_logits_max_abs_diff=sv["worst"],
                   serving_min_top2_gap=sv["min_gap"],
                   serving_tokens_checked=sv["checked"],
                   decode_batch_1_vs_4_max_abs_diff=batch_shape,
                   serving_s=sv["s"],
                   decode_tokens_per_s=sv["generated_per_s"],
                   decode_tokens_fed_per_s=sv["fed_per_s"],
                   k4_launches={"prefill_f32": n, "prefill_bf16": n16,
                                "chunked_prefill_and_decode": n_cd,
                                "serving": sv["launches"]["K4"]},
                   wall_s=time.perf_counter() - t_phase)
    log(f"phase X took {summary['wall_s']:.1f}s")
    print(json.dumps({"slice_xlstm": summary}), flush=True)
    return summary


# ----------------------- the Whisper slice (W): whisper-base --------------

@contextlib.contextmanager
def recorded_flash(calls):
    """(Sq, Skv, causal) of every self-attention that ``attention()`` sends
    to K4, appended to ``calls``: the smoke's recorder."""
    from repro_torch.models import attention
    fa = attention.flash_attention

    def recording(q, k, v, causal, window):
        calls.append((q.shape[2], k.shape[2], bool(causal)))
        return fa(q, k, v, causal, window)

    attention.flash_attention = recording
    try:
        yield
    finally:
        attention.flash_attention = fa


def whisper_phase(torch, fops):
    """Phase W: the encoder over 1,500 frames and the decoder over 448
    tokens, then decode with ``kv_source``, at the full width of
    whisper-base on the card. Returns its summary."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.blocks import BlockCtx
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg = get_config("whisper-base").with_overrides(tensor_parallel=1,
                                                    use_flash_attention=1)
    check(cfg.encoder_layers == cfg.decoder_layers == 6
          and cfg.d_model == 512 and cfg.num_heads == cfg.num_kv_heads == 8
          and cfg.head_dim == 64 and cfg.d_ff == 2048
          and cfg.vocab_size == 51_865 and cfg.max_target_positions == 448
          and cfg.num_audio_frames == 1500 and cfg.rope_theta == 0.0
          and cfg.slot_layout == ("enc",) * 3
          and cfg.decoder_slot_layout == ("dec",) * 3,
          f"whisper-base at its published widths: {cfg}")
    cfg32 = cfg.with_overrides(dtype="float32")
    params = M.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == WHISPER_PARAMETERS, f"{n_params:,} parameters, not "
          f"{WHISPER_PARAMETERS:,}")
    B, F, S = PREFILL_B, cfg.num_audio_frames, cfg.max_target_positions
    frames = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, F, cfg.d_model)).astype(np.float32), device="cuda")
    toks, _ = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).sample(
        np.random.default_rng(0), B, S)
    tokens = torch.as_tensor(toks, device="cuda")
    log(f"{cfg.name}: {n_params:,} parameters (f32), 6 encoder + 6 decoder "
        f"layers; frames [{B}, {F}, {cfg.d_model}] (numpy, seed 0), tokens "
        f"[{B}, {S}] from SyntheticLM")
    summary = {"config": f"{cfg.name} tensor_parallel=1 "
                         f"use_flash_attention=1", "parameters": n_params}
    want_calls = sorted([(F, F, False)] * 6 + [(S, S, True)] * 6)

    def forward(c):
        reset_k4(K)
        calls = []
        with recorded_flash(calls):
            logits = M.sequential_encdec_forward(params, c, frames, tokens)[0]
        torch.cuda.synchronize()
        return logits, K.launches, K.launches_route1, sorted(calls)

    with torch.no_grad():
        # ---- (i) the whole forward: K4 against the plain attention ------
        t0 = time.perf_counter()
        kern, n, r1_f32, calls = forward(cfg32)
        fwd32_s = time.perf_counter() - t0
        plain, n0, _, _ = forward(cfg32.with_overrides(use_flash_attention=0))
        check(n == 12 and r1_f32 == 0 and n0 == 0 and calls == want_calls,
              f"f32 forward: {n} K4 launches ({r1_f32} on route 1), {n0} "
              f"without; (Sq, Skv, causal) {calls}")
        err = (kern - plain).abs().max().item()
        check(bool(torch.isfinite(kern).all()), "non-finite f32 logits")
        log(f"(i) f32 forward: max |logit flash - plain| {err:.3g}; K4 "
            f"launches {n}: 6 non-causal over {F} keys (the encoder), 6 "
            f"causal over {S} (the decoder); {fwd32_s * 1e3:.1f} ms (the "
            f"phase's first forward)")
        check(err <= 1e-3, f"f32 logits differ by {err} (> 1e-3)")
        kern32 = kern
        del plain
        forward(cfg)                                       # warm-up
        t0 = time.perf_counter()
        kern, n16, r1_bf16, _ = forward(cfg)
        fwd_s = time.perf_counter() - t0
        plain, n0, _, _ = forward(cfg.with_overrides(use_flash_attention=0))
        check(n16 == r1_bf16 == 12 and n0 == 0,
              f"bf16 forward: {n16} K4 launches ({r1_bf16} on route 1), "
              f"{n0} without")
        check(bool(torch.isfinite(kern).all()), "non-finite bf16 logits")
        rel = ((kern - plain).norm() / plain.norm()).item()
        top1 = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"(i) bf16 forward: rel L2 {rel:.3g}, top-1 agreement "
            f"{top1:.4f}; {fwd_s * 1e3:.1f} ms: {B * F / fwd_s:,.0f} frames/s "
            f"with {B * S / fwd_s:,.0f} decoder tokens/s")
        check(rel <= 2e-2, f"bf16 rel L2 {rel} (> 2e-2)")
        summary.update(forward_f32_max_abs_diff=err,
                       forward_f32_ms=fwd32_s * 1e3,
                       forward_bf16_rel_l2=rel,
                       forward_bf16_top1_agreement=top1,
                       forward_bf16_ms=fwd_s * 1e3,
                       frames_per_s=B * F / fwd_s,
                       decoder_tokens_per_s=B * S / fwd_s)
        del kern, plain

        # ---- (ii) decode with kv_source against the full forward --------
        xe, pos_e = M.embed_frames(cfg32, frames, torch.float32)
        kv, _ = M.forward_blocks(
            params["blocks"], cfg32.slot_layout, xe,
            BlockCtx(cfg=cfg32, positions=pos_e, dtype=torch.float32,
                     causal=False), M.pad_mask(cfg32, device="cuda"))
        caches = M.init_caches(cfg32, batch=B, cache_len=S,
                               layout=cfg32.decoder_slot_layout,
                               dtype=torch.float32, device="cuda")
        reset_k4(K)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(WHISPER_DECODE_STEPS):
            lg, caches = M.sequential_decode_step(
                params, cfg32, tokens[:, t:t + 1], caches, t, kv_source=kv)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        n_dec = K.launches
        err_dec = max((lg - kern32[:, t]).abs().max().item()
                      for t, lg in enumerate(steps))
        log(f"(ii) {WHISPER_DECODE_STEPS} decode steps with kv_source: "
            f"{err_dec:.3g} from the f32 forward's first "
            f"{WHISPER_DECODE_STEPS} positions; K4 launches {n_dec}; "
            f"{B * WHISPER_DECODE_STEPS / decode_s:.1f} tokens/s at B={B}")
        check(n_dec == 0, f"decode launched K4 {n_dec} times")
        check(err_dec <= 1e-3, f"decode logits off by {err_dec} (> 1e-3)")
        summary.update(decode_max_abs_diff=err_dec,
                       decode_tokens_per_s=B * WHISPER_DECODE_STEPS
                       / decode_s,
                       k4_launches={"forward_f32": n, "forward_bf16": n16,
                                    "decode": n_dec},
                       k4_route1={"forward_f32": r1_f32,
                                  "forward_bf16": r1_bf16},
                       wall_s=time.perf_counter() - t_phase)
    log(f"phase W took {summary['wall_s']:.1f}s")
    print(json.dumps({"slice_whisper": summary}), flush=True)
    return summary


# ---------------------- the pipeline engine on the card (E) ----------------

# phase E (ii): Adam's learning rate for the bf16 training run, chosen
# before the first run and not tuned to its result. Adam's first update
# moves every weight by the lr (m / sqrt(v) = sign(g)); at 3e-4 that is
# ~1% of qwen2's weight scale (0.0255) in one coherent direction, ~30% of
# a matrix's norm, so 1e-5, a warm-up's early value. The run repeats ONE
# SyntheticLM batch: whether six steps lower the loss is then a property
# of the step, not of how much four updates generalise to fresh batches.
ENGINE_TRAIN_LR = 1e-5
ENGINE_TRAIN_B, ENGINE_TRAIN_S, ENGINE_TRAIN_M, ENGINE_TRAIN_STEPS = (
    4, 1024, 4, 6)


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    den = b.norm().item()
    num = (a - b).norm().item()
    return num / den if den else num


def engine_grads(loss_fn, params, batch, torch):
    """(total, metrics, gradients) of ``loss_fn`` at ``params``, taken as
    ``make_train_step`` takes them: on detached copies of the leaves."""
    from repro_torch import tree
    leaves, paths = tree.flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    total, metrics = loss_fn(tree.unflatten(paths, live), batch)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    return total.detach(), metrics, [
        torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]


def sequential_grads(params, cfg, tokens, labels, torch):
    """The port's sequential forward + cross-entropy: (loss, gradients)."""
    import torch.nn.functional as F
    from repro_torch import tree
    from repro_torch.models import model as M
    leaves, paths = tree.flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    logits = M.sequential_lm_forward(tree.unflatten(paths, live), cfg,
                                     tokens)[0]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for g, t in zip(grads, live)]


@contextlib.contextmanager
def checked_blends(found, torch):
    """Wraps the engine's ``_stage_window_blend`` and ``_blend_leaf`` (the
    smoke's recorder; the package reads no switch): at each leaf, on the
    step's own tensors (the new params copied first, since the blend
    writes into them), the last stage of the result must be the new params
    bit for bit and every earlier stage an independent 0.5 blend of (new,
    stash) bit for bit. Appends (leaves, last stage equal, earlier stages
    equal) to ``found`` for each blend."""
    from repro_torch.pipeline import pipeline_step as ps
    blend, blend_leaf = ps._stage_window_blend, ps._blend_leaf
    record = []

    def checking_leaf(n, st, first, S):
        new = n.clone()
        o = blend_leaf(n, st, first, S)
        half = (0.5 * new[:S - 1].to(torch.float32)
                + 0.5 * st[:S - 1].to(torch.float32)).to(n.dtype)
        record[0] += 1
        record[1] &= torch.equal(o[S - 1], new[S - 1])
        record[2] &= torch.equal(o[:S - 1], half)
        return o

    def checking(mesh, cfg, *blocks):
        record[:] = [0, True, True]
        out = blend(mesh, cfg, *blocks)
        found.append((record[0], bool(record[1]), bool(record[2])))
        return out

    ps._stage_window_blend, ps._blend_leaf = checking, checking_leaf
    try:
        yield
    finally:
        ps._stage_window_blend, ps._blend_leaf = blend, blend_leaf


def engine_phase(torch, fops, handoff):
    """Phase E: qwen2-1.5b at full width through the pipeline engine on
    a (1, 4, 1) mesh folded onto the card (f32 parity step, bf16 training,
    pipelined and chunked prefill, decode), whisper-base through its
    audio branch, a full-width re-pack, and the train and serve entry
    points. Returns its summary; leaves in ``handoff`` the bf16 train
    step, its state after the last step, its batch and the pipelined
    prefill, for phase D."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline import repack as rp
    from repro_torch.pipeline.pipeline_step import (make_prefill_step,
                                                    make_serve_step,
                                                    make_train_step,
                                                    pipeline_forward)
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b").with_overrides(tensor_parallel=1,
                                                  use_flash_attention=1)
    cfg32 = cfg.with_overrides(dtype="float32")
    S_st, L = cfg.pipeline_stages, cfg.num_layers
    n_slots = S_st * cfg.layers_per_stage      # each runs K4 (pads too)
    check((S_st, cfg.layers_per_stage, cfg.d_model, cfg.vocab_size)
          == (4, 7, 1536, 151_936), f"qwen2-1.5b at its published widths: "
          f"{cfg}")
    mesh = make_debug_mesh(1, S_st, 1, device="cuda")
    V = cfg.vocab_size
    lm = SyntheticLM(vocab_size=V, seed=0)
    launches, route1 = {}, {}
    summary = {"config": f"{cfg.name} tensor_parallel=1 "
                         f"use_flash_attention=1, mesh (data, stage, "
                         f"tensor) = (1, {S_st}, 1)"}

    def counted(name, fn):
        """fn() with K4's counts set to 0 just before and read just
        after; returns fn's result."""
        reset_k4(K)
        out = fn()
        torch.cuda.synchronize()
        launches[name], route1[name] = K.launches, K.launches_route1
        return out

    def batch_of(B, S, seed):
        x, y = lm.sample(np.random.default_rng(seed), B, S)
        return (torch.as_tensor(x, device="cuda"),
                torch.as_tensor(y, device="cuda"))

    params = M.init_params(0, cfg, device="cuda")

    # ---- (i) the f32 parity step against the sequential forward ---------
    B, S, Mb = 2, 256, 2
    tokens, labels = batch_of(B, S, 2)
    _, loss_fn = make_train_step(mesh, cfg32, TrainConfig(
        learning_rate=1e-4, optimizer="adam", microbatches=Mb, remat=True,
        weight_decay=0.0))
    total, metrics, grads = counted("parity_f32", lambda: engine_grads(
        loss_fn, params, {"tokens": tokens, "labels": labels}, torch))
    ref, ref_grads = sequential_grads(params, cfg32, tokens, labels, torch)
    loss_err = abs(float(metrics["loss"]) - float(ref))
    worst_rel = max(rel_l2(g, r) for g, r in zip(grads, ref_grads))
    log(f"E (i) f32 parity step, B={B} S={S} M={Mb}, remat: loss "
        f"{float(metrics['loss']):.6f}, sequential {float(ref):.6f} "
        f"(|diff| {loss_err:.3g}); largest gradient rel L2 {worst_rel:.3g} "
        f"over {len(grads)} leaves; K4 launches {launches['parity_f32']} "
        f"({route1['parity_f32']} on route 1)")
    check(launches["parity_f32"] == 2 * n_slots * Mb
          and route1["parity_f32"] == 0,
          f"parity step: {launches['parity_f32']} K4 launches "
          f"({route1['parity_f32']} on route 1), not {2 * n_slots * Mb} "
          f"on route 2")
    check(loss_err <= 1e-4, f"parity loss off by {loss_err} (> 1e-4)")
    check(worst_rel <= 1e-4, f"parity gradient rel L2 {worst_rel} (> 1e-4)")
    summary.update(parity_loss_abs_diff=loss_err,
                   parity_grad_max_rel_l2=worst_rel)
    del grads, ref_grads, total, metrics, ref

    # ---- (ii) bf16 training: Adam, stash 2, blend every 2, remat --------
    B, S, Mb, n_steps = (ENGINE_TRAIN_B, ENGINE_TRAIN_S, ENGINE_TRAIN_M,
                         ENGINE_TRAIN_STEPS)
    tcfg = cfg.with_overrides(stash_depth=2, aggregate_every=2)
    tc = TrainConfig(learning_rate=ENGINE_TRAIN_LR, optimizer="adam",
                     microbatches=Mb, remat=True, weight_decay=0.0)
    step_fn, _ = make_train_step(mesh, tcfg, tc)
    data = [batch_of(B, S, 1)] * n_steps
    state = step_fn.init_state(params)
    initial = [t.clone() for t in tree.leaves(params)]
    del params
    found, losses, step_ms, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    with checked_blends(found, torch):
        for i, (x, y) in enumerate(data):
            before = len(found)
            reset_k4(K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev_params = state["params"]
            state, m = step_fn(state, {"tokens": x, "labels": y})
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append((K.launches, K.launches_route1,
                             len(found) - before))
            if i == 0:
                check(all(a is b for a, b in zip(
                    tree.leaves(state["stash"]), tree.leaves(prev_params)))
                    and all(torch.equal(a, b) for a, b in zip(
                        tree.leaves(state["stash"]), initial)),
                      "the stash after step 1 is not the initial params "
                      "bit for bit")
                del initial
            del prev_params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["train_bf16"] = sum(n for n, _, _ in per_step)
    route1["train_bf16"] = sum(r for _, r, _ in per_step)
    med = statistics.median(step_ms)
    log(f"E (ii) bf16 training B={B} S={S} M={Mb} (one batch), Adam lr "
        f"{ENGINE_TRAIN_LR}, stash 2, blend every 2: losses "
        f"{[round(v, 4) for v in losses]}; step ms {[round(v, 1) for v in step_ms]} "
        f"(median {med:.1f}: {B * S / med * 1e3:,.0f} tokens/s); peak "
        f"{peak_gb:.1f} GB; K4 launches a step {[n for n, _, _ in per_step]} "
        f"(route 1: {[r for _, r, _ in per_step]}); blends checked "
        f"{[b for _, _, b in per_step]} ({found})")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(np.mean(losses[-2:]) < losses[0],
          f"training did not lower the loss: {losses}")
    check(all(n == r == 2 * n_slots * Mb for n, r, _ in per_step),
          f"K4 launches a step {per_step}, not {2 * n_slots * Mb} on "
          f"route 1")
    check([b for _, _, b in per_step] == [0, 1] * (n_steps // 2),
          f"blends by step {[b for _, _, b in per_step]}")
    check(all(last and early for _, last, early in found),
          f"blend identities broken: {found}")
    summary.update(train_losses=losses, train_step_ms=step_ms,
                   train_step_ms_median=med,
                   train_tokens_per_s=B * S / med * 1e3,
                   train_peak_gb=peak_gb, train_lr=ENGINE_TRAIN_LR)
    handoff.update(cfg=tcfg, train_config=tc, mesh=mesh, step_fn=step_fn,
                   state=state, batch={"tokens": data[0][0],
                                       "labels": data[0][1]})
    del state, data, m
    free_card(torch)
    params = M.init_params(0, cfg, device="cuda")       # the same draw

    with torch.no_grad():
        # ---- (iii) pipelined prefill, bf16, against the sequential ----
        B, S, Mb = PREFILL_B, PREFILL_S, 4
        prompt, _ = batch_of(B, S + DECODE_STEPS, 3)
        prefill = make_prefill_step(mesh, cfg, num_microbatches=Mb)
        prefill(params, {"tokens": prompt[:, :S]})         # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = counted("prefill_bf16", lambda: prefill(
            params, {"tokens": prompt[:, :S]}))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        want = M.sequential_lm_forward(params, cfg, prompt[:, :S])[0][:, -1]
        rel = rel_l2(got[:, 0, :V], want)
        log(f"E (iii) pipelined prefill bf16 B={B} S={S} M={Mb}: "
            f"{prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:,.0f} tokens/s); "
            f"last logits rel L2 {rel:.3g} from the sequential kernel "
            f"forward; K4 launches {launches['prefill_bf16']} (route 1: "
            f"{route1['prefill_bf16']})")
        check(launches["prefill_bf16"] == route1["prefill_bf16"]
              == n_slots * Mb,
              f"prefill: {launches['prefill_bf16']} K4 launches "
              f"({route1['prefill_bf16']} on route 1), not {n_slots * Mb}")
        check(bool(torch.isfinite(got).all()) and rel <= 2e-2,
              f"bf16 pipelined prefill rel L2 {rel} (> 2e-2)")
        del got, want
        S32 = min(512, S)
        got = counted("prefill_f32", lambda: make_prefill_step(
            mesh, cfg32, num_microbatches=Mb)(
                params, {"tokens": prompt[:, :S32]}))
        want = M.sequential_lm_forward(params, cfg32,
                                       prompt[:, :S32])[0][:, -1]
        err32 = (got[:, 0, :V] - want).abs().max().item()
        log(f"E (iii) pipelined prefill f32 B={B} S={S32}: last logits "
            f"{err32:.3g} from the sequential kernel forward; K4 launches "
            f"{launches['prefill_f32']}")
        check(launches["prefill_f32"] == n_slots * Mb
              and route1["prefill_f32"] == 0,
              f"f32 prefill: {launches['prefill_f32']} K4 launches")
        check(err32 <= 1e-3, f"f32 pipelined prefill off by {err32}")
        handoff.update(prefill=prefill, prompt=prompt[:, :S])
        summary.update(prefill_bf16_ms=prefill_ms,
                       prefill_tokens_per_s=B * S / prefill_ms * 1e3,
                       prefill_bf16_rel_l2=rel,
                       prefill_f32_max_abs_diff=err32)
        del got, want

        # ---- (iv) chunked prefill into the caches, then decode, f32 ----
        chunks = 4
        caches = M.init_caches(cfg32, batch=B, cache_len=S + DECODE_STEPS,
                               dtype=torch.float32, device="cuda")
        last, c_eng = counted("chunked_prefill", lambda: make_prefill_step(
            mesh, cfg32, seq_chunks=chunks)(
                params, {"tokens": prompt[:, :S]}, caches))
        want = M.sequential_lm_forward(params, cfg32, prompt[:, :S])[0][:, -1]
        err_chunk = (last[:, 0, :V] - want).abs().max().item()
        del want
        serve = make_serve_step(mesh, cfg32)
        c_seq = c_eng
        err_dec = 0.0
        reset_k4(K)
        for t in range(S, S + DECODE_STEPS):
            tok = prompt[:, t:t + 1]
            lg, c_eng = serve(params, tok, c_eng, t)
            ref, c_seq = M.sequential_decode_step(params, cfg32, tok,
                                                  c_seq, t)
            err_dec = max(err_dec, (lg[..., :V] - ref).abs().max().item())
        torch.cuda.synchronize()
        launches["decode"], route1["decode"] = K.launches, K.launches_route1
        log(f"E (iv) {chunks} chunks of {S // chunks} (f32): last logits "
            f"{err_chunk:.3g} from the sequential forward, K4 launches "
            f"{launches['chunked_prefill']}; {DECODE_STEPS} serve steps: "
            f"{err_dec:.3g} from sequential_decode_step on the same "
            f"caches, K4 launches {launches['decode']}")
        check(launches["chunked_prefill"] == n_slots * chunks
              and route1["chunked_prefill"] == 0,
              f"chunked prefill: {launches['chunked_prefill']} K4 launches")
        check(launches["decode"] == 0, "decode launched K4")
        check(err_chunk <= 1e-3 and err_dec <= 1e-3,
              f"chunked prefill / decode off by {err_chunk}, {err_dec}")
        summary.update(chunked_prefill_max_abs_diff=err_chunk,
                       decode_max_abs_diff=err_dec)
        del caches, c_eng, c_seq, last, lg, ref
    del params
    free_card(torch)

    # ---- (vi) re-pack at full width, then after losing stage 2 ----------
    # ceil(28 / 3) = 10 slots a stage: three survivors must hold the 28
    # layers (8 a stage would hold 24)
    lps = -(-L // (S_st - 1))
    rcfg = cfg32.with_overrides(layers_per_stage=lps,
                                slot_layout=("dense",) * lps)
    rparams = M.init_params(1, rcfg, device="cuda")
    a_old = M.default_assignment(rcfg)                  # [7, 7, 7, 7]
    q = L // S_st
    a_new = [q + 1, q + 1, q - 1, q - 1]                # [8, 8, 6, 6]
    a_lost = rp.recover_assignment_after_stage_loss(rcfg, a_new, 2)
    layer_bytes = sum(t[0].numel() * t.element_size()
                      for t in tree.leaves(rparams["blocks"][0]))
    toks, _ = batch_of(1, 256, 4)
    with torch.no_grad():
        base = M.sequential_lm_forward(rparams, rcfg, toks,
                                       assignment=a_old)[0]
        errs, moved = [], []
        blocks, cur = rparams["blocks"], a_old
        for nxt in (a_new, a_lost):
            plan = rp.make_repack_plan(rcfg, cur, nxt)
            blocks = rp.repack_blocks(blocks, plan, rcfg)
            got = M.sequential_lm_forward(dict(rparams, blocks=blocks), rcfg,
                                          toks, assignment=nxt)[0]
            errs.append((got - base).abs().max().item())
            moved.append(rp.redistribution_bytes(rcfg, plan, layer_bytes))
            cur = nxt
    log(f"E (vi) re-pack {a_old} -> {a_new} -> {a_lost} (stage 2 lost), "
        f"{rcfg.layers_per_stage} slots a stage: max |logit change| "
        f"{errs}; redistribution bytes {moved} ({layer_bytes:,} a layer)")
    check(all(e <= 2e-5 for e in errs), f"re-pack moved the logits {errs}")
    summary.update(repack_assignments=[a_old, a_new, a_lost],
                   repack_max_abs_diff=errs, repack_bytes=moved)
    del rparams, blocks, base, got
    free_card(torch)

    # ---- (v) whisper-base through the engine's audio branch, f32 --------
    wcfg = get_config("whisper-base").with_overrides(
        tensor_parallel=1, use_flash_attention=1, dtype="float32")
    wmesh = make_debug_mesh(1, wcfg.pipeline_stages, 1, device="cuda")
    wparams = M.init_params(0, wcfg, device="cuda")
    B, F_, T, Mb = 2, wcfg.num_audio_frames, wcfg.max_target_positions, 2
    frames = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, F_, wcfg.d_model)).astype(np.float32), device="cuda")
    x, y = SyntheticLM(vocab_size=wcfg.vocab_size, seed=0).sample(
        np.random.default_rng(5), B, T)
    wtok, wlab = (torch.as_tensor(a, device="cuda") for a in (x, y))
    with torch.no_grad():
        logits = M.sequential_encdec_forward(wparams, wcfg, frames, wtok)[0]
        wref = float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     wlab.reshape(-1).long()))
        del logits
    wstep, _ = make_train_step(wmesh, wcfg, TrainConfig(
        learning_rate=1e-4, optimizer="adam", microbatches=Mb, remat=True,
        weight_decay=0.0))
    wstate = wstep.init_state(wparams)
    wlosses, wlaunch = [], []
    for _ in range(3):
        reset_k4(K)
        wstate, m = wstep(wstate, {"frames": frames, "tokens": wtok,
                                   "labels": wlab})
        wlosses.append(float(m["loss"]))
        wlaunch.append((K.launches, K.launches_route1))
    launches["whisper_train"] = sum(n for n, _ in wlaunch)
    route1["whisper_train"] = sum(r for _, r in wlaunch)
    werr = abs(wlosses[0] - wref)
    # per microbatch: every encoder slot's self-attention (6, non-causal
    # over 1,500 frames) and every decoder slot's (6, causal over 448),
    # again in the recompute
    per = 2 * Mb * wcfg.pipeline_stages * (len(wcfg.slot_layout)
                                           + len(wcfg.decoder_slot_layout))
    log(f"E (v) whisper-base train B={B} M={Mb} (f32): losses {wlosses}, "
        f"the first {werr:.3g} from sequential_encdec_forward's "
        f"{wref:.6f}; K4 launches a step {[n for n, _ in wlaunch]}")
    check(all(math.isfinite(v) for v in wlosses), f"whisper {wlosses}")
    check(werr <= 1e-4, f"whisper first loss off by {werr} (> 1e-4)")
    check(all(n == per and r == 0 for n, r in wlaunch),
          f"whisper K4 launches {wlaunch}, not {per} a step on route 2")
    del wstate, m
    with torch.no_grad():
        xe = M.embed_frames(wcfg, frames, torch.float32)[0]
        kv = pipeline_forward(wmesh, wcfg, wparams["blocks"], xe,
                              M.pad_mask(wcfg, device="cuda"),
                              causal=False, remat=False)[0]
        layout = wcfg.decoder_slot_layout
        c_eng = M.init_caches(wcfg, batch=B, cache_len=T, layout=layout,
                              dtype=torch.float32, device="cuda")
        c_seq, werr_dec = c_eng, 0.0
        wserve = make_serve_step(wmesh, wcfg)
        reset_k4(K)
        for t in range(8):
            tok = wtok[:, t:t + 1]
            lg, c_eng = wserve(wparams, tok, c_eng, t, kv_source=kv)
            ref, c_seq = M.sequential_decode_step(wparams, wcfg, tok, c_seq,
                                                  t, kv_source=kv)
            werr_dec = max(werr_dec,
                           (lg[..., :wcfg.vocab_size] - ref).abs().max()
                           .item())
        torch.cuda.synchronize()
        launches["whisper_decode"] = K.launches
        route1["whisper_decode"] = K.launches_route1
    log(f"E (v) whisper-base 8 serve steps with kv_source: {werr_dec:.3g} "
        f"from sequential_decode_step; K4 launches "
        f"{launches['whisper_decode']}")
    check(launches["whisper_decode"] == 0, "whisper decode launched K4")
    check(werr_dec <= 1e-3, f"whisper decode off by {werr_dec} (> 1e-3)")
    summary.update(whisper_losses=wlosses, whisper_loss_abs_diff=werr,
                   whisper_decode_max_abs_diff=werr_dec)
    del wparams, kv, c_eng, c_seq, frames
    free_card(torch)

    # ---- (vii) the entry points as a user starts them -------------------
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        out, train_s = run_entry_point(
            ["repro_torch.launch.train", "--arch", "qwen2-1.5b",
             "--debug-mesh", "1,2,1", "--steps", "50", "--lr", "0.005",
             "--ckpt-dir", d], "E (vii)")
        check("training qwen2-1.5b on cuda" in out and "(improved)" in out,
              "launch.train did not train on the card or did not improve")
        rcfg = get_config("qwen2-1.5b").reduced(
            pipeline_stages=2, tensor_parallel=1, dtype="float32")
        restored, step = CheckpointStore(d).restore_latest(
            M.init_params(0, rcfg, device="cuda"))
        check(step == 50 and all(bool(torch.isfinite(t).all())
                                 for t in tree.leaves(restored)),
              f"launch.train's checkpoint: step {step}")
    out, serve_s = run_entry_point(["repro_torch.launch.serve"], "E (vii)")
    check("tok/s on cuda" in out, "launch.serve did not report the card")
    summary.update(k4_launches=launches, k4_route1=route1,
                   entry_points_s={"train": train_s, "serve": serve_s},
                   wall_s=time.perf_counter() - t_phase)
    log(f"phase E took {summary['wall_s']:.1f}s")
    print(json.dumps({"slice_engine": summary}), flush=True)
    return summary


# the report keys of ``python -m repro_torch.launch.dryrun`` (the JAX dry
# run's, ``lower_s`` as ``trace_s`` and ``hlo_flops_raw`` as
# ``traced_flops_per_device``)
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "stage_x_tensor",
               "microbatches", "ticks", "data_sharded", "trace_s",
               "compile_s", "traced_flops_per_device", "hlo_bytes_raw",
               "hlo_collectives_raw", "bytes_per_device", "flops_per_device",
               "collective_bytes_per_device", "hbm_bytes_per_device",
               "roofline", "dominant", "model_flops", "useful_ratio")
COST_MODEL_TOL = 0.35        # tests/test_substrates.py:165-198


def launch_tooling_phase(torch, fops, handoff, e_run, card):
    """Phase D: phase E's train step and pipelined prefill counted on the
    card and traced on meta, set beside the cost model and the H100
    roofline; then two dry runs as a user starts them. Prints the
    ``{"roofline": ...}`` line and returns it."""
    from repro_torch import compat
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import analysis, cost_model, dryrun
    K = fops.flash_attention_kernel
    t_phase = time.perf_counter()
    cfg, mesh = handoff["cfg"], handoff["mesh"]
    folded = cfg.pipeline_stages * cfg.tensor_parallel
    Mb = handoff["train_config"].microbatches
    out = {"card": card}
    steps = {
        "train": (handoff["batch"]["tokens"].shape, "train",
                  e_run["train_step_ms_median"],
                  lambda: handoff["step_fn"](handoff["state"],
                                             handoff["batch"])),
        "prefill": (handoff["prompt"].shape, "prefill",
                    e_run["prefill_bf16_ms"],
                    lambda: handoff["prefill"](handoff["state"]["params"],
                                               {"tokens": handoff["prompt"]})),
    }
    for name, ((B, S), kind, step_ms, run) in steps.items():
        shape = InputShape(f"phase_e_{name}", S, B, kind)
        reset_k4(K)
        with torch.no_grad() if kind == "prefill" else \
                contextlib.nullcontext():
            on_card = compat.cost_analysis(run)
        torch.cuda.synchronize()
        free_card(torch)
        launched = K.launches
        on_meta, _, trace_s = dryrun.trace_step(
            cfg, shape, mesh, B, tc=handoff["train_config"])
        combo = cost_model.Combo(cfg, shape)
        combo.D, combo.B_loc, combo.M, combo.mb = 1, B, Mb, B // Mb
        combo.S, combo.Tp, combo.ticks = cfg.pipeline_stages, \
            cfg.tensor_parallel, Mb
        combo.data_sharded = True
        rl = cost_model.roofline(combo)
        analytic = rl["flops"]["total"]
        per_device = on_card["flops"] / folded
        # one card does the work of all the folded devices
        terms = {k: v * folded for k, v in rl["terms"].items()}
        step_s = step_ms / 1e3
        mf = analysis.model_flops(cfg, shape)
        bound_s = max(terms["compute_s"], terms["memory_s"])
        out[name] = {
            "B": B, "S": S, "M": Mb, "step_ms": step_ms,
            "counted_flops": on_card["flops"],
            "counted_flops_aten": on_card["flops_aten"],
            "counted_flops_k4": on_card["flops_kernels"]["flash_attention"],
            "k4_launches": launched,
            "meta_flops": on_meta["flops"], "meta_trace_s": trace_s,
            "analytic_flops_per_device": analytic,
            "counted_over_analytic": per_device / analytic,
            "model_flops": mf, "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"], "dominant": rl["dominant"],
            "mfu": mf / (step_s * analysis.PEAK_FLOPS),
            "counted_share_of_peak": on_card["flops"]
            / (step_s * analysis.PEAK_FLOPS),
            "roofline_bound_over_step": bound_s / step_s}
        log(f"D {name}: counted on the card {on_card['flops']:.6e} FLOPs "
            f"(K4 as its plain version: "
            f"{on_card['flops_kernels']['flash_attention']:.6e}, "
            f"{launched} launches), traced on meta {on_meta['flops']:.6e} "
            f"in {trace_s:.1f}s; per device {per_device:.6e} against the "
            f"cost model's {analytic:.6e} (x{per_device / analytic:.4f}); "
            f"mfu {out[name]['mfu']:.4f}")
        check(launched > 0 and on_card["flops_kernels"]["flash_attention"]
              > 0, f"D {name}: no K4 launch was counted")
        check(on_card["flops"] == on_meta["flops"],
              f"D {name}: the card's count {on_card['flops']} differs from "
              f"the meta trace's {on_meta['flops']}")
        check(abs(per_device / analytic - 1) < COST_MODEL_TOL,
              f"D {name}: counted {per_device} per device, the cost model "
              f"{analytic} (tolerance {COST_MODEL_TOL})")
    del steps
    handoff.clear()
    free_card(torch)

    import tempfile
    reports = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for arch, shape_id, extra in (
                ("qwen2-1.5b", "train_4k", []),
                ("zamba2-7b", "prefill_32k",
                 ["--set", "use_flash_attention=1"])):
            run_entry_point(["repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape_id, "--out", d, *extra],
                            "D (iii)", timeout=900)
            path = os.path.join(d, f"{arch}_{shape_id}_16x16.json")
            with open(path) as f:
                rep = json.load(f)
            missing = [k for k in DRYRUN_KEYS if k not in rep]
            ratio = rep["traced_flops_per_device"] / \
                rep["flops_per_device_ticks_m"]["total"]
            log(f"D (iii) {arch} {shape_id}: trace {rep['trace_s']}s, "
                f"arguments {rep['bytes_per_device']['arguments']:,} B a "
                f"device, traced {rep['traced_flops_per_device']:.6e} "
                f"FLOPs a device (x{ratio:.4f} the analytic at ticks = M), "
                f"roofline {rep['roofline']}, dominant {rep['dominant']}")
            check(not missing, f"D (iii) {arch}: report lacks {missing}")
            check(rep["bytes_per_device"]["arguments"] > 0,
                  f"D (iii) {arch}: no argument bytes")
            check(abs(ratio - 1) < COST_MODEL_TOL,
                  f"D (iii) {arch}: traced x{ratio} the analytic count")
            reports[f"{arch} {shape_id}"] = {
                "trace_s": rep["trace_s"],
                "arguments_bytes_per_device":
                    rep["bytes_per_device"]["arguments"],
                "traced_flops_per_device": rep["traced_flops_per_device"],
                "traced_over_analytic": ratio, "roofline": rep["roofline"],
                "dominant": rep["dominant"]}
    out["dryrun"] = reports
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase D took {out['wall_s']:.1f}s")
    print(json.dumps({"roofline": out}), flush=True)
    return out


# ------------------------ the engine on ranks (R) --------------------------

RANK_NAMES = ("data", "stage", "tensor")
RANK_NCCL_STEPS = 2          # (i): steps held bit for bit
RANK_GLOO_STEPS = 3          # (ii): train steps a mesh (blend at 2; step 3
                             # runs on the stash step 1's update turned over)
RANK_GLOO_MESHES = ((1, 1, 2), (1, 2, 1))
RANK_BF16_REL_L2 = 2e-2      # phase E (iii)'s bf16 limit
# bf16 gradients: a per-leaf relative norm against the folded engine's
# does not hold. A k bias shifts every score of a query by the same q.b,
# which softmax ignores, so its gradient is zero in exact arithmetic and
# what either engine computes for it is rounding alone. So each leaf of
# the ranks' bf16 gradient may lie no farther from the folded engine's
# f32 gradient than RANK_BF16_VS_F32 times the folded engine's own bf16
# gradient does (two bf16 evaluations of one function, rounded in
# different orders).
RANK_BF16_VS_F32 = 2.0
# The Adam moments: a leaf's largest |error| over the largest |value| of
# any leaf ("of the largest"), against the same measure of the two engines'
# bf16 gradients at the first step. m sums the three steps' gradients
# with positive weights, so it may lie up to RANK_MOMENTS_VS_GRADS times
# as far; v sums their squares, whose error 2 g dg doubles that.
RANK_MOMENTS_VS_GRADS = 2.0
# Adam's step |m_hat| / sqrt(v_hat) is at most 1.001 over three steps at
# b1 0.9, b2 0.95 (Cauchy-Schwarz over the two weightings), so two runs
# from one init move an element apart by at most 2.002 lr a step, plus a
# bf16 spacing (2^-7 of the value) at each rounding: the updates and the
# blend. The bf16 params and stash are held to that, element by element.
ADAM_STEP_MAX = 1.001
RANK_F32_TOL = 1e-4          # phase E (i)'s f32 loss and gradient limits
RANK_TIMEOUT = 600.0         # seconds a rank call may take
# qwen2-1.5b's layers phase R runs (of 28; every width kept): the depth
# cut that leaves the smoke room for phase G's examples (PERF.md §6 PR 28)
RANK_LAYERS = 8


def rank_cfg(stages, tensor):
    """qwen2-1.5b at its published widths, ``RANK_LAYERS`` layers over
    ``stages`` stages, tensor parallel ``tensor``, with K4."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b").with_overrides(num_layers=RANK_LAYERS)
    lps = cfg.num_layers // stages
    return cfg.with_overrides(pipeline_stages=stages, tensor_parallel=tensor,
                              layers_per_stage=lps,
                              slot_layout=("dense",) * lps,
                              use_flash_attention=1)


def rank_train_cfg(shape):
    """Phase R (ii)'s config on a (data, stage, tensor) mesh: the weight
    stash of depth 2 and the blend every 2 steps, as phase E (ii)."""
    return rank_cfg(shape[1], shape[2]).with_overrides(stash_depth=2,
                                                       aggregate_every=2)


def rank_train_config():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=ENGINE_TRAIN_LR, optimizer="adam",
                       microbatches=ENGINE_TRAIN_M, remat=True,
                       weight_decay=0.0)


def lm_batch(vocab, B, S, seed, torch):
    """Phase E's ``SyntheticLM`` draw: (tokens, labels) on the card."""
    import numpy as np
    from repro_torch.data.synthetic import SyntheticLM
    x, y = SyntheticLM(vocab_size=vocab, seed=0).sample(
        np.random.default_rng(seed), B, S)
    return (torch.as_tensor(x, device="cuda"),
            torch.as_tensor(y, device="cuda"))


def rank_nccl_train(steps):
    """Phase R (i), on the one rank of an NCCL world: ``steps`` bf16 Adam
    steps of the rank engine (a ``RankMesh`` of (1, 1, 1)), then of the
    folded engine on the same config, draw and batch, in this process
    (the parent holds no model). Returns both runs' losses, step ms and K4
    counts, and whether every leaf of the two final states is equal bit
    for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_debug_mesh, make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline_step import make_train_step
    from repro_torch.pipeline.sharding import shard_params
    K = fops.flash_attention_kernel
    cfg = rank_cfg(1, 1).with_overrides(stash_depth=2, aggregate_every=2)
    x, y = lm_batch(cfg.vocab_size, ENGINE_TRAIN_B, ENGINE_TRAIN_S, 1, torch)
    out, kept = {}, None
    for name in ("rank", "folded"):
        mesh = (make_debug_mesh(1, 1, 1, device="cuda") if name == "rank"
                else make_local_mesh((1, 1, 1), RANK_NAMES, "cuda"))
        params = M.init_params(0, cfg, device="cuda")
        if name == "rank":
            params = shard_params(params, mesh, cfg)
        step_fn, _ = make_train_step(mesh, cfg, rank_train_config())
        state = step_fn.init_state(params)
        del params
        torch.cuda.reset_peak_memory_stats()
        losses, ms, k4 = [], [], []
        for _ in range(steps):
            reset_k4(K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, {"tokens": x, "labels": y})
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            k4.append((K.launches, K.launches_route1))
        out[name] = {"mesh": type(mesh).__name__, "losses": losses,
                     "step_ms": ms, "k4": k4, "peak_gb":
                     torch.cuda.max_memory_allocated() / 1e9}
        leaves = tree.leaves(state)
        del state, m
        if kept is None:
            kept = [t.cpu() for t in leaves]
        else:
            out["leaves"] = len(leaves)
            out["same"] = len(leaves) == len(kept) and all(
                torch.equal(a, b.cpu()) for a, b in zip(kept, leaves))
        del leaves
        free_card(torch)
    import torch.distributed as dist
    out["backend"] = dist.get_backend()
    out["jax"] = "jax" in sys.modules
    return out


_KEPT = {}      # phase R (ii): what a rank keeps for ``rank_vs_folded``


def _keep(name, t):
    """A CPU copy of tree ``t``'s leaves, kept in this rank's process
    under ``name`` for ``rank_vs_folded``."""
    from repro_torch import tree
    _KEPT[name] = [x.detach().cpu() for x in tree.leaves(t)]


def rank_gloo_run(shape):
    """Phase R (ii), on each rank of a gloo world sharing the card: the
    bf16 pipelined prefill (B=4, S=2,048, M=4, timed after a warm-up),
    the f32 and the bf16 loss and gradients of phase E's train batch,
    then ``RANK_GLOO_STEPS`` timed bf16 Adam steps on that batch (stash 2,
    the blend every 2 steps). This rank's shards of both gradients and of
    the final state's params, stash and moments are kept in host memory
    for ``rank_vs_folded``. Returns the logits (rank 0), losses, times, K4 counts
    by run, the collectives staged through the host by run, the final
    state's counts and the peak."""
    import torch
    from repro_torch import collectives, tree
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline_step import (make_loss_fn,
                                                    make_prefill_step,
                                                    make_train_step)
    from repro_torch.pipeline.sharding import shard_params
    K = fops.flash_attention_kernel
    cfg = rank_train_cfg(shape)
    mesh = make_debug_mesh(*shape, device="cuda")
    params = shard_params(M.init_params(0, cfg, device="cuda"), mesh, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "coords": mesh.coords, "k4": {}, "k4_route1":
           {}, "host_staged": {}, "backend": mesh.backend}

    def counted(name, fn):
        reset_k4(K)
        collectives.reset_host_staged()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out["k4"][name], out["k4_route1"][name] = (K.launches,
                                                   K.launches_route1)
        out["host_staged"][name] = {k: list(v) for k, v in
                                    collectives.HOST_STAGED.items()}
        return res

    prompt, _ = lm_batch(cfg.vocab_size, PREFILL_B, PREFILL_S, 3, torch)
    prefill = make_prefill_step(mesh, cfg, num_microbatches=4)
    with torch.no_grad():
        prefill(params, {"tokens": prompt})                   # warm-up
        logits = counted("prefill", lambda: prefill(params,
                                                    {"tokens": prompt}))
    if mesh.rank == 0:
        out["logits"] = logits.cpu().numpy()
    del logits
    x, y = lm_batch(cfg.vocab_size, ENGINE_TRAIN_B, ENGINE_TRAIN_S, 1, torch)
    vg = make_loss_fn(mesh, cfg.with_overrides(dtype="float32"),
                      num_microbatches=ENGINE_TRAIN_M,
                      remat=True).value_and_grad
    total, metrics, grads = counted("grads_f32", lambda: vg(
        params, {"tokens": x, "labels": y}))
    out["loss_f32"] = float(metrics["loss"])
    _keep("grads_f32", grads)
    del grads, total, metrics
    vg = make_loss_fn(mesh, cfg, num_microbatches=ENGINE_TRAIN_M,
                      remat=True).value_and_grad
    total, metrics, grads = counted("grads_bf16", lambda: vg(
        params, {"tokens": x, "labels": y}))
    out["loss_bf16"] = float(metrics["loss"])
    _keep("grads_bf16", grads)
    del grads, total, metrics
    step_fn, _ = make_train_step(mesh, cfg, rank_train_config())
    state = step_fn.init_state(params)
    del params
    losses = []
    for i in range(RANK_GLOO_STEPS):
        state, m = counted(f"step{i}", lambda: step_fn(
            state, {"tokens": x, "labels": y}))
        losses.append(float(m["loss"]))
    out["train_losses"] = losses
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["jax"] = "jax" in sys.modules
    for name, t in (("params", state["params"]), ("stash", state["stash"]),
                    ("m", state["opt_state"]["m"]),
                    ("v", state["opt_state"]["v"])):
        _keep(name, t)
    out["counts"] = (int(state["step"]), int(state["opt_state"]["count"]))
    del state, m
    free_card(torch)
    return out


def adam_drift(got, want, steps, lr):
    """Per leaf, the largest |got - want| over the bound that two bf16
    Adam runs of ``steps`` steps and a blend keep to (``ADAM_STEP_MAX``):
    at most 1 where the runs differ by rounding alone."""
    out = []
    for g, w in zip(got, want):
        w = w.float()
        bound = (steps * 2 * ADAM_STEP_MAX * lr + (steps + 1) * 2.0 ** -7
                 * (w.abs() + steps * ADAM_STEP_MAX * lr))
        out.append(float(((g.to(w.device).float() - w).abs() / bound)
                         .max()))
    return out


def _vs_folded(cfg, shape, r, torch):
    """Rank ``r``'s turn of ``rank_vs_folded``: the folded engine's f32
    and bf16 gradients and ``RANK_GLOO_STEPS`` train steps from the same
    draw and batch, in this process, each cut to rank r's shards
    (``shard_params``) and held against what this rank kept. Per leaf:
    sums of squares (rel L2), largest |differences| and |values|
    (of the largest), ``adam_drift``, and whether equal bit for bit."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline_step import (make_loss_fn,
                                                    make_train_step)
    from repro_torch.pipeline.sharding import shard_params
    Mb = ENGINE_TRAIN_M
    local = make_local_mesh(shape, RANK_NAMES, "cuda")
    params = M.init_params(0, cfg, device="cuda")
    paths = tree.flatten(params)[1]
    x, y = lm_batch(cfg.vocab_size, ENGINE_TRAIN_B, ENGINE_TRAIN_S, 1, torch)
    batch = {"tokens": x, "labels": y}

    def mine(leaves):
        """Rank r's shards of a whole tree's leaves (``paths`` order)."""
        return tree.leaves(shard_params(tree.unflatten(paths, leaves),
                                        local, cfg, rank=r))

    def sq(t):
        return float(t.double().square().sum())

    out = {}
    _, metrics, whole = engine_grads(make_loss_fn(
        local, cfg.with_overrides(dtype="float32"), num_microbatches=Mb,
        remat=True), params, batch, torch)
    out["loss_f32"] = float(metrics["loss"].detach())
    ref = mine(whole)
    del whole, metrics
    _, metrics, whole = engine_grads(make_loss_fn(
        local, cfg, num_microbatches=Mb, remat=True), params, batch, torch)
    out["loss_bf16"] = float(metrics["loss"].detach())
    ref16 = mine(whole)
    del whole, metrics
    g32, g16 = _KEPT.pop("grads_f32"), _KEPT.pop("grads_bf16")
    f32, b16 = [], []
    for a, a16, w, f in zip(g32, g16, ref, ref16):
        a, a16 = a.cuda(), a16.cuda()
        f32.append((sq(a - w), sq(w)))
        b16.append((sq(a16 - w), sq(f - w), sq(a16 - f), sq(f),
                    float((a16.float() - f.float()).abs().max()),
                    float(f.abs().max())))
    out["grads_f32"], out["grads_bf16"] = f32, b16
    del g32, g16, ref, ref16, a, a16, w, f
    free_card(torch)
    step_fn, _ = make_train_step(local, cfg, rank_train_config())
    state = step_fn.init_state(params)
    del params
    losses = []
    for _ in range(RANK_GLOO_STEPS):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    del m
    out["train_losses"] = losses
    out["counts"] = (int(state["step"]), int(state["opt_state"]["count"]))
    for name, t in (("params", state["params"]), ("stash", state["stash"]),
                    ("m", state["opt_state"]["m"]),
                    ("v", state["opt_state"]["v"])):
        want, got = mine(tree.leaves(t)), _KEPT.pop(name)
        rows = []
        for g, w in zip(got, want):
            g = g.cuda()
            if tuple(g.shape) != tuple(w.shape):
                rows.append((math.inf, math.inf, 0.0, False, False))
                continue
            rows.append((adam_drift([g], [w], RANK_GLOO_STEPS,
                                    ENGINE_TRAIN_LR)[0],
                         float((g.float() - w.float()).abs().max()),
                         float(w.abs().max()), bool(torch.equal(g, w)),
                         True))
        out[name] = rows
        del want, got, g, w
    del state
    return out


def rank_vs_folded(shape):
    """Phase R (ii), on each rank after ``rank_gloo_run``: the ranks take
    turns, one at a time while the others wait at a barrier holding
    nothing on the card, to run the folded engine in their own process
    and hold their kept shards against its (``_vs_folded``). No tensor
    crosses between processes; the parent combines the per-leaf sums."""
    import torch
    import torch.distributed as dist
    cfg = rank_train_cfg(shape)
    out = None
    for turn in range(dist.get_world_size()):
        if dist.get_rank() == turn:
            t0 = time.perf_counter()
            out = _vs_folded(cfg, shape, turn, torch)
            out["turn_s"] = time.perf_counter() - t0
            free_card(torch)
        dist.barrier()
    return out


def _combine(res):
    """The ranks' ``_vs_folded`` sums over the whole leaves (a leaf
    replicated over both ranks counts twice in a numerator and its
    denominator alike). Returns per leaf: f32 gradient rel L2; bf16
    gradient rel L2 against the f32 one over the folded bf16's
    (``RANK_BF16_VS_F32``), rel L2 to the folded bf16, of the largest;
    and per state tree (drifts or of the largest, leaves equal, shapes
    equal)."""
    def ratio(num, den):        # as rel_l2: the numerator where den is 0
        return math.sqrt(num / den) if den else math.sqrt(num)

    n = len(res[0]["grads_f32"])
    f32 = [ratio(sum(r["grads_f32"][i][0] for r in res),
                 sum(r["grads_f32"][i][1] for r in res)) for i in range(n)]
    b = [[sum(r["grads_bf16"][i][k] for r in res) for k in range(4)]
         for i in range(n)]
    vs32 = [ratio(x[0], x[1]) for x in b]
    rel16 = [ratio(x[2], x[3]) for x in b]
    top = max(r["grads_bf16"][i][5] for r in res for i in range(n))
    of16 = [max(r["grads_bf16"][i][4] for r in res) / top
            for i in range(n)]
    state = {}
    for name in ("params", "stash", "m", "v"):
        rows = [r[name] for r in res]
        k = len(rows[0])
        if name in ("m", "v"):
            top_s = max(row[i][2] for row in rows for i in range(k))
            errs = [max(row[i][1] for row in rows) / top_s
                    for i in range(k)]
        else:
            errs = [max(row[i][0] for row in rows) for i in range(k)]
        state[name] = (errs, sum(all(row[i][3] for row in rows)
                                 for i in range(k)),
                       all(row[i][4] for row in rows for i in range(k)))
    return f32, vs32, rel16, of16, state


def rank_gloo_mesh(torch, pool, shape, card, launches, route1):
    """Phase R (ii) on one mesh: the ranks' run (``rank_gloo_run``), the
    ranks' turns against the folded engine (``rank_vs_folded``), the
    folded engine's prefill here, the checks, and the ranks' K4 launches
    added to ``launches`` / ``route1``. Returns the mesh's summary."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline_step import make_prefill_step
    Mb = ENGINE_TRAIN_M
    key = "".join(map(str, shape))
    cfg = rank_train_cfg(shape)
    n_local = cfg.layers_per_stage            # slots a rank runs
    t0 = time.perf_counter()
    res = pool.run(rank_gloo_run, shape)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs = pool.run(rank_vs_folded, shape)
    folded_s = time.perf_counter() - t0
    rels, vs32, rels16, of16, state_errs = _combine(vs)
    ref = vs[0]
    # the folded engine's prefill here, on the same config, draw and prompt
    mesh = make_debug_mesh(*shape, device="cuda")
    params = M.init_params(0, cfg, device="cuda")
    prompt, _ = lm_batch(cfg.vocab_size, PREFILL_B, PREFILL_S, 3,
                         torch)
    with torch.no_grad():
        want = make_prefill_step(mesh, cfg, num_microbatches=4)(
            params, {"tokens": prompt})
    logit_rel = rel_l2(torch.from_numpy(res[0]["logits"]).cuda(),
                       want)
    del want, params
    free_card(torch)
    loss32_ref, loss16_ref = ref["loss_f32"], ref["loss_bf16"]
    losses_ref = ref["train_losses"]
    counts = {"ranks": [r["counts"] for r in res],
              "folded": ref["counts"]}

    worst, worst16, worst_vs32 = max(rels), max(of16), max(vs32)
    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(res[0]["train_losses"], losses_ref)]
    loss16_rel = abs(res[0]["loss_bf16"] - loss16_ref) / abs(loss16_ref)
    loss32_err = abs(res[0]["loss_f32"] - loss32_ref)
    steps = [[r[f"step{i}_ms"] for i in range(RANK_GLOO_STEPS)]
             for r in res]
    med = statistics.median(steps[0])
    state_worst = {k: max(e) for k, (e, _, _) in state_errs.items()}
    log(f"R (ii) {shape} over {res[0]['backend']}, two ranks on the "
        f"card: prefill B={PREFILL_B} S={PREFILL_S} M=4 "
        f"{[round(r['prefill_ms'], 1) for r in res]} ms, last logits "
        f"rel L2 {logit_rel:.3g} from the folded engine; f32 loss "
        f"{res[0]['loss_f32']:.6f} vs {loss32_ref:.6f} (|diff| "
        f"{loss32_err:.3g}), largest f32 gradient rel L2 {worst:.3g} over "
        f"{len(rels)} leaves (leaf {rels.index(worst)}); bf16 loss "
        f"{res[0]['loss_bf16']:.6f} vs {loss16_ref:.6f} (rel "
        f"{loss16_rel:.3g}), bf16 gradients: from the f32 gradient, the "
        f"ranks' over the folded engine's at most {worst_vs32:.3g} (leaf "
        f"{vs32.index(worst_vs32)}), largest |error| over the largest "
        f"|gradient| {worst16:.3g} (leaf {of16.index(worst16)}), "
        f"largest rel L2 {max(rels16):.3g} (leaf "
        f"{rels16.index(max(rels16))}); {RANK_GLOO_STEPS} bf16 Adam steps "
        f"(stash 2, blend every 2) ms by rank "
        f"{[[round(v, 1) for v in s] for s in steps]} (median "
        f"{med:.1f}), losses {res[0]['train_losses']} vs the folded "
        f"{losses_ref} (rel {[f'{v:.3g}' for v in loss_rel]}); final "
        f"state vs the folded engine's, largest error (params/stash: over "
        f"the Adam drift bound, at most 1; moments: of the largest) "
        f"{ {k: f'{v:.3g}' for k, v in state_worst.items()} }, leaves "
        f"equal bit for bit "
        f"{ {k: f'{n}/{len(e)}' for k, (e, n, _) in state_errs.items()} }, "
        f"counts {counts}; peaks {[round(r['peak_gb'], 1) for r in res]} "
        f"GB; wall {wall:.1f} s, then the ranks' turns with the folded "
        f"engine {folded_s:.1f} s ({[round(v['turn_s'], 1) for v in vs]} "
        f"s) ({card})")
    for r in res:
        log(f"  rank {r['rank']} {r['coords']}: K4 (all, route 1) "
            f"{r['k4']} / {r['k4_route1']}; staged through the host "
            f"[calls, bytes] by run: {r['host_staged']}")
    check(not any(r["jax"] for r in res), "R (ii): a rank loaded jax")
    check(logit_rel <= RANK_BF16_REL_L2 and loss16_rel <= RANK_BF16_REL_L2
          and max(loss_rel) <= RANK_BF16_REL_L2,
          f"R (ii) {shape}: bf16 logits {logit_rel}, loss {loss16_rel}, "
          f"train losses {loss_rel} from the folded engine (> "
          f"{RANK_BF16_REL_L2})")
    check(loss32_err <= RANK_F32_TOL and worst <= RANK_F32_TOL,
          f"R (ii) {shape}: f32 loss {loss32_err} and gradients "
          f"{worst} from the folded engine (> {RANK_F32_TOL})")
    check(worst_vs32 <= RANK_BF16_VS_F32,
          f"R (ii) {shape}: a bf16 gradient leaf {worst_vs32} times as "
          f"far from the f32 one as the folded engine's (> "
          f"{RANK_BF16_VS_F32})")
    check(all(ok for _, _, ok in state_errs.values()),
          f"R (ii) {shape}: a state leaf's shard has another shape than "
          f"the folded engine's")
    check(state_worst["params"] <= 1.0 and state_worst["stash"] <= 1.0
          and state_worst["m"] <= RANK_MOMENTS_VS_GRADS * worst16
          and state_worst["v"] <= 2 * RANK_MOMENTS_VS_GRADS * worst16,
          f"R (ii) {shape}: the final state {state_worst} from the "
          f"folded engine's (the bf16 gradients' {worst16})")
    check(all(c == (RANK_GLOO_STEPS,) * 2 for c in counts["ranks"])
          and counts["folded"] == (RANK_GLOO_STEPS,) * 2,
          f"R (ii) {shape}: step counts {counts}")
    want_k4 = {"prefill": n_local * 4, "grads_f32": 2 * n_local * Mb,
               "grads_bf16": 2 * n_local * Mb,
               **{f"step{i}": 2 * n_local * Mb
                  for i in range(RANK_GLOO_STEPS)}}
    want_r1 = dict(want_k4, grads_f32=0)          # f32: route 2
    for r in res:
        check(r["k4"] == want_k4 and r["k4_route1"] == want_r1,
              f"R (ii) {shape} rank {r['rank']}: K4 launches "
              f"{r['k4']} (route 1 {r['k4_route1']}), not {want_k4} "
              f"(route 1 {want_r1})")
    staged = {run: sum(st.get("send", [0, 0])[1] + st.get("recv",
                                                           [0, 0])[1]
                       for st in (r["host_staged"][run] for r in res))
              for run in res[0]["host_staged"]}
    check(all(v == 0 for v in staged.values()) if shape[1] == 1 else
          all(v > 0 for v in staged.values()),
          f"R (ii) {shape}: bytes through the host {staged}")
    for run in want_k4:
        launches[f"gloo_{key}_{run}"] = sum(r["k4"][run] for r in res)
        route1[f"gloo_{key}_{run}"] = sum(r["k4_route1"][run]
                                          for r in res)
    return {
        "prefill_ms": [r["prefill_ms"] for r in res],
        "prefill_logits_rel_l2": logit_rel,
        "loss_f32": res[0]["loss_f32"], "folded_loss_f32": loss32_ref,
        "grad_f32_max_rel_l2": worst, "loss_bf16_rel": loss16_rel,
        "grad_bf16_max_vs_f32": worst_vs32,
        "grad_bf16_max_of_largest": worst16,
        "grad_bf16_max_rel_l2": max(rels16),
        "step_ms": steps, "step_ms_median": med,
        "train_losses": res[0]["train_losses"],
        "folded_train_losses": losses_ref,
        "state_max_error": state_worst,
        "state_leaves_equal": {k: [n, len(e)] for k, (e, n, _) in
                               state_errs.items()},
        "peak_gb": [r["peak_gb"] for r in res],
        "host_staged_bytes": staged, "wall_s": wall,
        "folded_and_compare_s": folded_s}


def ranks_phase(torch, card):
    """Phase R: the pipeline engine over real ranks (one process a mesh
    position) at qwen2-1.5b's full width, ``RANK_LAYERS`` layers deep:
    (i) one rank over NCCL, bit for bit the folded engine; (ii) two ranks sharing the card over gloo on
    (1, 1, 2) (a real tensor axis) and (1, 2, 1) (the stage hand-off
    between processes): prefill logits, every gradient leaf and the
    state after 3 Adam steps with the blend against the folded engine
    within phase E's limits (bf16 logits and losses 2e-2 rel; the f32
    loss 1e-4 abs and every f32 gradient leaf 1e-4 rel L2, phase E
    (i)'s; bf16 gradients ``RANK_BF16_VS_F32``, moments
    ``RANK_MOMENTS_VS_GRADS``), exact
    K4 counts on every rank; (iii) ``torchrun
    --nproc-per-node 1 -m repro_torch.launch.train`` over NCCL. Returns
    the ranks' K4 launches by run (for the kernels line)."""
    import tempfile

    from repro_torch.pipeline.ranks import RankPool
    from repro_torch.runtime.net import free_port
    t_phase = time.perf_counter()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    launches, route1 = {}, {}
    Mb, n_layers = ENGINE_TRAIN_M, rank_cfg(1, 1).num_layers
    summary = {"card": card, "layers": n_layers}

    # ---- (i) one rank over NCCL: bit for bit the folded engine ----------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        with RankPool(1, d, backend="nccl", device="cuda",
                      timeout=RANK_TIMEOUT) as pool:
            (r,) = pool.run(rank_nccl_train, RANK_NCCL_STEPS)
    wall = time.perf_counter() - t0
    per_step = 2 * n_layers * Mb
    log(f"R (i) one rank over {r['backend']} ({r['rank']['mesh']}) vs the "
        f"folded engine ({r['folded']['mesh']}), qwen2-1.5b ({n_layers} "
        f"layers) bf16 B="
        f"{ENGINE_TRAIN_B} S={ENGINE_TRAIN_S} M={Mb}, remat, Adam: losses "
        f"{r['rank']['losses']} vs {r['folded']['losses']}; {r['leaves']} "
        f"state leaves equal bit for bit: {r['same']}; step ms "
        f"{[round(v, 1) for v in r['rank']['step_ms']]} vs "
        f"{[round(v, 1) for v in r['folded']['step_ms']]}; peak "
        f"{r['rank']['peak_gb']:.1f} / {r['folded']['peak_gb']:.1f} GB; K4 "
        f"(all, route 1) a step {r['rank']['k4']} / {r['folded']['k4']}; "
        f"wall {wall:.1f} s ({card})")
    check(r["backend"] == "nccl" and not r["jax"], f"R (i) ran on "
          f"{r['backend']}, jax loaded: {r['jax']}")
    check(r["same"] and r["rank"]["losses"] == r["folded"]["losses"],
          "R (i): the one-rank NCCL step is not bit for bit the folded "
          "engine's")
    check(all(k == (per_step, per_step) for run in ("rank", "folded")
              for k in r[run]["k4"]),
          f"R (i) K4 launches a step, not {per_step} on route 1: "
          f"{r['rank']['k4']}, {r['folded']['k4']}")
    launches["nccl_train"] = sum(n for n, _ in r["rank"]["k4"])
    route1["nccl_train"] = sum(k for _, k in r["rank"]["k4"])
    summary["nccl"] = {"losses": r["rank"]["losses"],
                       "folded_losses": r["folded"]["losses"],
                       "bit_for_bit": r["same"], "leaves": r["leaves"],
                       "step_ms": r["rank"]["step_ms"],
                       "folded_step_ms": r["folded"]["step_ms"],
                       "peak_gb": r["rank"]["peak_gb"], "wall_s": wall}

    # ---- (ii) two ranks sharing the card over gloo, one pool for both
    # meshes (each call makes its mesh's process groups) ------------------
    with tempfile.TemporaryDirectory(dir=build_dir) as d, RankPool(
            2, os.path.join(d, "store"), backend="gloo", device="cuda",
            timeout=RANK_TIMEOUT) as pool:
        for shape in RANK_GLOO_MESHES:
            summary["gloo_" + "".join(map(str, shape))] = rank_gloo_mesh(
                torch, pool, shape, card, launches, route1)

    # ---- (iii) torchrun of the train entry point, one rank over NCCL ----
    out, train_s = run_entry_point(
        ["torch.distributed.run", "--nproc-per-node", "1", "--master-addr",
         "127.0.0.1", "--master-port", str(free_port()),
         "-m", "repro_torch.launch.train", "--debug-mesh", "1,1,1",
         "--steps", "20", "--lr", "0.005"], "R (iii)")
    check("ranks (nccl)" in out and "(improved)" in out,
          "torchrun of launch.train did not train on an NCCL rank or did "
          "not improve")
    summary.update(torchrun_train_s=train_s, k4_launches=launches,
                   k4_route1=route1,
                   wall_s=time.perf_counter() - t_phase)
    log(f"phase R took {summary['wall_s']:.1f}s")
    print(json.dumps({"slice_ranks": summary}), flush=True)
    return summary


# ---------------------------- the examples (G) ----------------------------

EXAMPLE_TIMEOUT = 300.0      # seconds an example may take
# (name, arguments, run in this process, the start of its last line). The
# examples whose kernels would run in this process are called through
# ``main`` here, so their launches are counted; those that start processes
# of their own run as a user starts them, as subprocesses, and are held by
# their own checks, their exit code and the launches they print for their
# own process. train_e2e runs at its default width for 100 steps, its
# first checkpoint.
G_EXAMPLES = (
    ("heterogeneous_partition", [], True, "single fastest device epoch:"),
    ("fault_tolerance_demo", [], True, "recovery overhead: ftpipehd"),
    ("continuous_batching", [], True, "PASS"),
    ("quickstart", [], True, "quickstart OK"),
    ("train_e2e", ["--steps", "100"], True, "checkpoints: [100]"),
    ("serve_pipeline", [], True, "stream[2]:"),
    ("live_fault_tolerance", [], True, "PASS"),
    ("live_wan_heterogeneity", [], True, "PASS"),
    ("live_tcp_fault_tolerance", [], False, "PASS"),
    ("live_compressed_wire", [], False, "PASS"),
    ("live_elastic_rejoin", [], False, "PASS"),
    ("live_coordinator_failover", [], False, "PASS"),
    ("live_fleet_chain_failure", [], False, "PASS"),
)
G_KERNELS = ("fused_sgd", "quantize_ef", "dequantize", "flash_attention",
             "ssd_scan")
# The launches each example makes in the process that runs it, worked out
# from the code before the first run (PERF.md §6, PR 28): (least, most),
# most None where a kill's timing decides how many batches run again. No
# example sets use_flash_attention (the JAX examples leave it at 0), and
# serve_pipeline decodes only (K5 runs in prefill), so no example
# launches K4 or K5. A live run's stages each apply one fused SGD update a
# batch (StageExecutor._step_fused): at least 2 a committed batch with 2
# or 3 stages, 1 where only stage 0 runs in the process (TCP). The
# int8-fused tier quantizes every act and grad sent (2 a batch with 2
# stages) and dequantizes every act received, again in the backward, and
# every grad received (3 a batch). Subprocess demos print K1-K3 only.
G_ZERO = {k: (0, 0) for k in G_KERNELS}
G_LAUNCHES = {
    "live_fault_tolerance": {**G_ZERO, "fused_sgd": (2 * 40, None)},
    "live_wan_heterogeneity": {**G_ZERO, "fused_sgd": (2 * 16, None)},
    # worker 0 (stage 0) runs in the demo's process
    "live_tcp_fault_tolerance": {"fused_sgd": (32, None)},
    # two TCP runs (stage 0 here) + two queue runs (every stage here)
    "live_compressed_wire": {"fused_sgd": (2 * 20 + 2 * 2 * 20, None),
                             "quantize_ef": (2 * 20, None),
                             "dequantize": (3 * 20, None)},
    "live_elastic_rejoin": {"fused_sgd": (40, None)},
    # the queue reference (3 stages, 40 batches, no kill) + the resumed
    # coordinator's stage 0 from batch 8
    "live_coordinator_failover": {"fused_sgd": (3 * 40 + 32, None)},
    # each chain's coordinator (stage 0) runs here: the reference fleet's
    # 2 x 24 batches, the killed fleet's chain 0 (24) and chain 1's second
    # incarnation (from round 18)
    "live_fleet_chain_failure": {"fused_sgd": (2 * 24 + 24 + 6, None)},
}
# the figures each example is read for: (key, regular expression whose
# group is a number); a pattern that matches more than once gives a list
G_HEADLINES = {
    # ftpipehd's, then pipedream's, on the simulator's virtual clock
    "heterogeneous_partition": [("sim_steady_batch_s",
                                 r"steady per-batch ([\d.]+)s")],
    "fault_tolerance_demo": [("sim_recovery_overhead_s",
                              r"recovery overhead: ftpipehd ([\d.]+)s")],
    "continuous_batching": [("engine_steps", r"drained in (\d+)")],
    "quickstart": [("loss_first5", r"loss: ([\d.]+) ->"),
                   ("loss_last5", r"loss: [\d.]+ -> ([\d.]+)")],
    "train_e2e": [("params_m", r"([\d.]+)M params"),
                  ("loss_first5", r"loss ([\d.]+) ->"),
                  ("loss_last5", r"loss [\d.]+ -> ([\d.]+)")],
    "serve_pipeline": [("tok_per_s", r"\((\d+) tok/s")],
    # data plane and replicas (int8 over TCP), data plane (int8-fused)
    "live_compressed_wire": [("bytes_ratios", r"\(([\d.]+)x smaller\)"),
                             ("max_loss_diffs",
                              r"max \|loss diff\| = ([\d.]+)")],
    "live_coordinator_failover": [
        ("max_divergence", r"vs uninterrupted reference: ([\d.]+)")],
    "live_fleet_chain_failure": [("final_loss_diff",
                                  r"\|diff\| = ([\d.]+)\)")],
}


def example_path(name):
    return os.path.join(ROOT, "examples_torch", f"{name}.py")


def load_example(name):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  example_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example_here(name, argv, timeout):
    """``main(argv)`` of ``examples_torch/<name>.py`` in this process, on a
    thread with a bounded wait, its standard output captured. Returns (its
    return code, its output, wall s)."""
    import io
    import threading
    mod = load_example(name)
    box = {}

    def call():
        try:
            box["rc"] = mod.main(argv)
        except BaseException as e:            # reported below
            box["error"] = e

    buf = io.StringIO()
    log(f"phase G: main({argv}) of examples_torch/{name}.py")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        th = threading.Thread(target=call, name=f"example-{name}",
                              daemon=True)
        th.start()
        th.join(timeout)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    check(not th.is_alive(), f"phase G: {name} did not finish in "
          f"{timeout} s")
    check("error" not in box, f"phase G: {name} raised {box.get('error')!r}")
    return box["rc"], out, wall


def event_times(out, text):
    """The times (s) of the printed events that start with ``text``."""
    import re
    return [float(t) for t in re.findall(
        r"t=\s*([\d.]+)s\s+" + re.escape(text), out)]


def example_figures(name, out, wall):
    """An example's headline figures, read from its output."""
    import re
    fig = {}
    for key, pattern in G_HEADLINES.get(name, []):
        vals = [float(v) for v in re.findall(pattern, out)]
        check(vals, f"phase G: {name} printed no {key}")
        fig[key] = vals if len(vals) > 1 else vals[0]
    kill, rec = event_times(out, "KILL"), event_times(out, "recovered:")
    if kill and rec:
        fig["recovery_s"] = rec[0] - kill[0]
    adm = event_times(out, "admitted:")
    if kill and adm:
        fig["kill_to_rejoin_s"] = adm[0] - kill[0]
    if name == "continuous_batching":
        fig["tokens_per_s"] = 4 * 8 / wall
    if name == "train_e2e":       # set-up, 100 steps and checkpoint
        fig["tokens_per_s"] = 100 * 8 * 256 / wall
    return fig


def printed_launches(out):
    """{kernel: launches} an example printed for its own process."""
    import re
    line = re.findall(r"kernel launches in this process: (.*)", out)
    return {k: int(v) for k, v in re.findall(r"(\w+) (\d+)",
                                             line[-1])} if line else {}


def examples_phase(torch, card):
    """Phase G: the thirteen examples of ``examples_torch/`` as a user
    starts them (``G_EXAMPLES``): each returns 0 and ends with its verdict
    line; the kernel launches of each, counted here for those run in this
    process and read from the output of the others, within
    ``G_LAUNCHES``; train_e2e's checkpoint read back. Prints an
    ``{"examples": ...}`` line."""
    import tempfile

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.fused_sgd import ops
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.models import model as M
    counters = {"fused_sgd": ops.fused_sgd, "quantize_ef": qops.quantize_ef,
                "dequantize": qops.dequantize,
                "flash_attention": fops.flash_attention_kernel,
                "ssd_scan": sops.ssd_scan_kernel}
    t_phase = time.perf_counter()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    summary = {"card": card}
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        for name, argv, here, verdict in G_EXAMPLES:
            if name == "train_e2e":
                argv = argv + ["--ckpt", ckpt]
            if here:
                for fn in counters.values():
                    fn.launches = 0
                reset_k4(fops.flash_attention_kernel)
                rc, out, wall = run_example_here(name, argv,
                                                 EXAMPLE_TIMEOUT)
                launches = {k: fn.launches for k, fn in counters.items()}
                free_card(torch)
            else:
                out, wall = run_python([example_path(name), *argv], "G",
                                       EXAMPLE_TIMEOUT)
                rc, launches = 0, printed_launches(out)
            last = out.rstrip().splitlines()[-1] if out.strip() else ""
            check(rc == 0, f"phase G: {name} returned {rc}")
            check(last.startswith(verdict), f"phase G: {name} ended with "
                  f"{last!r}, not {verdict!r}")
            want = G_LAUNCHES.get(name, G_ZERO if here else {})
            for k, (lo, hi) in want.items():
                n = launches.get(k)
                check(n is not None and n >= lo and (hi is None or n <= hi),
                      f"phase G: {name} launched {k} {n} times, predicted "
                      f"{lo}..{'' if hi is None else hi}")
            summary[name] = {"wall_s": wall, "rc": rc, "in_process": here,
                             "launches": launches,
                             **example_figures(name, out, wall)}
            log(f"phase G: {name} {wall:.1f} s, launches {launches}")
        cfg = load_example("train_e2e").config(tiny=False)
        init = M.init_params(0, cfg, device="cuda")
        restored, step = CheckpointStore(ckpt).restore_latest(init)
        check(step == 100 and all(bool(torch.isfinite(t).all())
                                  for t in tree.leaves(restored)),
              f"train_e2e's checkpoint: step {step}")
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(tree.leaves(restored), tree.leaves(init)))
        check(moved > 0, "train_e2e's checkpoint holds the initial params")
        summary["train_e2e"]["checkpoint"] = {
            "step": step, "leaves": len(tree.leaves(restored)),
            "leaves_trained": moved}
        del init, restored
    free_card(torch)
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"phase G took {summary['wall_s']:.1f}s")
    print(json.dumps({"examples": summary}), flush=True)
    return summary


def main():
    t_smoke = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        raise SmokeFailure(f"the port is not beside this script: no "
                           f"src/repro_torch under {ROOT}")
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sgd import ops, ref
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.kernels.moe_combine import ops as cops
    from repro_torch.kernels.moe_combine import ref as cref
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()

    # ---- phase 1: build (one nvcc per source, together) + K1 vs plain ------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(build.build,
                             ("fused_sgd", "quant", "flash_attention",
                              "flash_attention_sm90", "ssd_scan",
                              "moe_combine")))
    log(f"built {[os.path.relpath(lib, ROOT) for lib in libs]} in "
        f"{time.perf_counter() - t0:.1f}s; ptxas says, for each kernel "
        f"(the whole nvcc output is beside each library, *.log):")
    for lib in libs:
        for name, what in ptxas_lines(lib):
            log(f"  {name[:90]}: {what}")
    smem = build.load("ssd_scan").ssd_scan_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_int
    log(f"  K5 dynamic shared memory at N=64 (passes 1, 3; x/dt,B,C f32 "
        f"or bf16): " + ", ".join(
            f"{'bf16' if xb else 'f32'}/{'bf16' if sb else 'f32'} "
            f"{smem(64, xb, sb, 1)}, {smem(64, xb, sb, 3)} B"
            for xb in (0, 1) for sb in (0, 1)))
    smem = build.load("flash_attention").flash_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    log(f"  K4 route 2 dynamic shared memory (q/kv f32 or bf16) at dh=112, "
        f"128: " + ", ".join(
            f"{'bf16' if qb else 'f32'}/{'bf16' if kb else 'f32'} "
            f"{smem(112, qb, kb)}, {smem(128, qb, kb)} B"
            for qb, kb in ((0, 0), (1, 0), (0, 1))))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.runtime.workload import WorkloadSpec
    probe, probe_batches = WorkloadSpec(
        kind="mobilenet", image_hw=32, batch_size=64).build(device="cuda")
    layout = probe.flat_layout()
    n_model = sum(layout.layer_size(j) for j in range(layout.num_layers))
    max_diff = 0.0
    for n in (1, 255, 65_539, n_model):
        max_diff = max(max_diff, kernel_vs_plain(n, n, torch, ops, ref))
    log(f"fused_sgd bit-identical to plain at n = 1, 255, 65539, {n_model}")

    # ---- phase Q: K2 and K3 vs plain at every boundary shape ---------------
    shapes = boundary_shapes(probe, probe_batches[0], torch)
    quant_err = quant_phase(shapes, torch, qops, qref)

    # ---- phase A: K4 vs plain at the slice's shapes ------------------------
    flash_errs, flash_rels = flash_phase(torch, fops, fref)

    # ---- phase S: K5 vs plain at the hybrid slice's shapes -----------------
    ssd_errs, ssd_rels, ssd_model = ssd_phase(torch, sops, sref)
    ssd_cover = ssd_coverage(torch, sops, sref)

    # ---- phase C: the expert combine vs plain, in the engine's step -------
    c_checks, c_steps, c_times = combine_phase(torch, cops, cref)

    # ---- phase 2: the port on the card against the CPU --------------------
    cross_device_checks(torch)

    # ---- phase 3: the main path ---------------------------------------------
    counters = {"fused_sgd": ops.fused_sgd, "quantize_ef": qops.quantize_ef,
                "dequantize": qops.dequantize}
    res, main_run = live_run(torch, counters)
    check(main_run["launches"]["quantize_ef"]
          == main_run["launches"]["dequantize"] == 0,
          "the default data plane launched a quant kernel")

    # ---- phase F: the main path on the exact and int8-fused wire ------------
    f_runs, fused, f_profile = fused_phase(torch, counters, probe,
                                           probe_batches[0])

    # ---- phase P: the main path over TCP (Run facade, worker processes) -----
    t0 = time.perf_counter()
    tcp_phase(torch, counters, f_profile, f_runs[1], fused)
    log(f"phase P took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    # ---- phase L: the entry point, python -m repro_torch.launch.live_train --
    t0 = time.perf_counter()
    entry_point_phase()
    log(f"phase L took {time.perf_counter() - t0:.1f}s")

    # ---- phase T: the dense transformer serving path -----------------------
    t_run = transformer_phase(torch, fops)
    free_card(torch)                  # phase T's model is freed

    # ---- phase Z: the hybrid Mamba2 serving path ---------------------------
    z_run = hybrid_phase(torch, fops, sops)
    free_card(torch)

    # ---- phase M: the MoE serving path --------------------------------------
    m_run = moe_phase(torch, fops, cops)
    free_card(torch)

    # ---- phase X: the xLSTM serving path ------------------------------------
    x_run = xlstm_phase(torch, fops)
    free_card(torch)

    # ---- phase W: the Whisper encoder-decoder path --------------------------
    w_run = whisper_phase(torch, fops)
    free_card(torch)

    # ---- phase E: the pipeline engine (train, prefill, serve, re-pack) ------
    handoff = {}
    e_run = engine_phase(torch, fops, handoff)
    free_card(torch)

    # ---- phase D: the launch tooling (FLOP counts, roofline, dry runs) ------
    launch_tooling_phase(torch, fops, handoff, e_run, card)
    del handoff
    free_card(torch)

    # ---- phase R: the pipeline engine over real ranks -----------------------
    r_run = ranks_phase(torch, card)
    free_card(torch)

    # ---- phase G: the examples, as a user starts them -----------------------
    g_run = examples_phase(torch, card)

    # ---- phase 4: K1 at the run's slice sizes, then timings -----------------
    sizes = sorted({s for r in (res, *f_runs)
                    for _, pts in r.partitions
                    for s in stage_sizes(layout, pts)})
    for n in sizes:
        max_diff = max(max_diff, kernel_vs_plain(n, n + 1, torch, ops, ref))
    log(f"fused_sgd bit-identical to plain at the run's slice sizes {sizes}")
    full = timings(n_model, torch, ops, ref)
    per_slice = [timings(n, torch, ops, ref) for n in sizes]
    k2_times, k3_times = zip(*(quant_timings(rows, C, torch, qops, qref)
                               for rows, C in shapes))
    kernels = [{
        "name": "fused_sgd", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sgd.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:23",
        "launches": main_run["launches"]["fused_sgd"],
        "max_abs_err": max_diff, **full, "per_slice": per_slice}]
    notes = {"quantize_ef": "no single PyTorch call computes it: "
                            "torch.quantize_per_channel takes its scales "
                            "as inputs and uses a zero point",
             "dequantize": "torch.addcmul(lo, scale, q), within 2 spacings "
                           "of the plain version"}
    quant_ptxas = [f"{name}: {what}" for name, what in
                   ptxas_lines(build.build("quant"))]
    for name, replaces, times in (
            ("quantize_ef", "src/repro/kernels/quant/kernel.py:57",
             k2_times),
            ("dequantize", "src/repro/kernels/quant/kernel.py:87",
             k3_times)):
        top = times[0]                   # the largest boundary
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/quant.cu", "replaces": replaces,
            "launches": fused["launches"][name], "max_abs_err": quant_err,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "host_ms": top["host_ms"],
            "library_note": notes[name], "ptxas": quant_ptxas,
            "per_shape": list(times)})
    log("K2 / K3 ms (bound, host ms a call; K3's addcmul) per boundary: "
        + "; ".join(
            f"[{a['rows']}, {a['C']}] {a['ms']:.4f} ({a['bound_ms']:.4f}, "
            f"{a['host_ms']:.4f}) / {b['ms']:.4f} ({b['bound_ms']:.4f}, "
            f"{b['host_ms']:.4f}; {b['library_ms']:.4f})"
            for a, b in zip(k2_times, k3_times)))
    k4_times = [flash_timings(sh, torch, fops, fref)
                for sh in flash_shapes()[0]]
    # route 2 at qwen2's top shape, then the serving paths' other shapes
    k4_f32, *k4_f32_more = [flash_timings(sh, torch, fops, fref, "float32")
                            for sh in route2_shapes()]
    log(f"K4 route 1 at qwen2's top shape (bf16): {k4_times[0]['ms']:.4f} "
        f"ms (0.1627-0.1652 ms in PR 16's runs on an H100 at 700 W); route "
        f"2 (f32): " + ", ".join(
            f"{t['ms']:.4f} ms (bounds {t['bound_ms']:.4f} f32, "
            f"{t['bound_ms_3xtf32']:.4f} 3xTF32; SDPA "
            f"{t['library_ms']:.4f}) at B={t['B']} H={t['H']} Sq={t['Sq']} "
            f"Skv={t['Skv']} dh={t['dh']} q_offset={t['q_offset']}"
            for t in (k4_f32, *k4_f32_more)))
    z_runs = ("prefill_f32", "prefill_bf16", "chunked_prefill", "decode",
              "decode_check", "serving")
    by_run = {"prefill_f32": t_run["k4_launches_prefill_f32"],
              "prefill_bf16": t_run["k4_launches_prefill_bf16"],
              "chunked_prefill": t_run["k4_launches_chunked_prefill"],
              "decode": t_run["k4_launches_decode"],
              "serving": t_run["k4_launches_serving"],
              **{f"zamba2_{r}": z_run[f"launches_{r}"]["K4"]
                 for r in z_runs},
              **{f"{name}_{r}": v for name, run in (
                  ("olmoe", m_run), ("xlstm", x_run), ("whisper", w_run),
                  ("engine", e_run), ("ranks", r_run))
                 for r, v in run["k4_launches"].items()}}
    top = k4_times[0]                    # B=4, S=2048, causal, bf16
    n_k4 = sum(by_run.values())
    n_route1 = sum(sum(run["k4_route1"].values())
                   for run in (t_run, z_run, m_run, w_run, e_run, r_run))
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        # route 1 (bf16, the serving path's dtype) is the one timed here;
        # route 2 (f32, bf16 q over f32 kv) is timed in "route2_f32"
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "sources_by_route": {
            "1": "src/repro_torch/csrc/flash_attention_sm90.cu",
            "2": "src/repro_torch/csrc/flash_attention.cu"},
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
        "launches": n_k4, "launches_by_run": by_run,
        "launches_by_route": {"1": n_route1, "2": n_k4 - n_route1},
        "max_abs_err": max(flash_errs.values()),
        "max_abs_err_by_dtype": flash_errs, "rel_l2_by_dtype": flash_rels,
        "limits": {**FLASH_TOL, "bfloat16_rel_l2": FLASH_BF16_REL_L2},
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")},
        "per_shape": k4_times, "route2_f32": k4_f32,
        "route2_f32_per_shape": k4_f32_more})
    k5_times = [ssd_timings(sh, torch, sops, sref) for sh in SSD_SHAPES]
    k5_passes = ssd_pass_times(SSD_SHAPES[0], torch, sops)
    log(f"K5 at B=4 S=2048 f32: {k5_times[0]['ms']:.4f} ms (bound "
        f"{k5_times[0]['bound_ms']:.4f} f32, "
        f"{k5_times[0]['bound_ms_3xtf32']:.4f} 3xTF32); by pass "
        f"(profiler, ms a call): {k5_passes}")
    k5_by_run = {f"zamba2_{r}": z_run[f"launches_{r}"]["K5"] for r in z_runs}
    top = k5_times[0]                    # B=4, S=2048, f32
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:61",
        "launches": sum(k5_by_run.values()), "launches_by_run": k5_by_run,
        "max_abs_err": max(ssd_errs.values()),
        "max_abs_err_by_dtype": ssd_errs, "rel_l2_by_dtype": ssd_rels,
        "limits": {**SSD_TOL, "bfloat16_rel_l2": SSD_BF16_REL_L2,
                   "model_draw_rel_l2": SSD_MODEL_REL_L2},
        "model_draw": ssd_model,
        **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_ms_3xtf32",
                               "bound_by_3xtf32")},
        "coverage_max_abs_err_f32": ssd_cover,
        "ms_by_pass": k5_passes,
        "library_note": "no single PyTorch call computes the SSD scan",
        "per_shape": k5_times})
    c_by_run = {**{f"olmoe_{r}": v for r, v in
                   m_run["combine_launches"].items()},
                **{f"engine_step_{i + 1}": v for i, v in
                   enumerate(c_steps["launches_per_step"])}}
    top = c_times[1]                     # ~69% dropped, the benchmark's
    kernels.append({
        # ms, plain_ms, bound_ms: a training microbatch's forward and
        # backward together; each pass apart in "per_shape"
        "name": "moe_combine", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_combine.cu",
        "replaces": None,
        "replaces_note": "no Pallas counterpart: the JAX package gathers "
                         "and sums with jnp indexing (src/repro/models/"
                         "moe.py); the port's plain version is "
                         "kernels/moe_combine/ref.py",
        "launches": sum(map(sum, c_by_run.values())),
        "launches_by_pass": {p: sum(v[i] for v in c_by_run.values())
                             for i, p in enumerate(("fwd", "bwd"))},
        "launches_by_run": c_by_run,
        "max_abs_err": max(max(c["out_max_abs_err"], c["dw_max_abs_err"])
                           for c in c_checks),
        "checks": c_checks,
        **{k: top[f"fwd_{k}"] + top[f"bwd_{k}"]
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "engine_steps": c_steps,
        "library_note": "no single PyTorch call computes the gather back "
                        "and the top-k sum",
        "per_shape": c_times})
    for entry in kernels:          # phase G's launches, by example
        entry["launches_in_examples"] = {
            name: run["launches"][entry["name"]]
            for name, run in g_run.items() if isinstance(run, dict)
            and run.get("launches", {}).get(entry["name"])}
    log(f"smoke wall time {time.perf_counter() - t_smoke:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
