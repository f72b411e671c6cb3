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
     (fewer rows than a block), each in f32, bf16 and bf16 q over f32
     k/v; and dh=32, 64 at small sizes in those and f32 q over bf16 k/v;
     then on the strided views the model passes: q, k, v as ``[B, S,
     heads, dh].transpose(1, 2)`` (qwen2's and zamba2's S=2048 causal),
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
     at every phase-A shape, and in f32 (route 2) at the five shapes the
     serving paths launch it at (qwen2's top shape and its 512-row chunk
     at q_offset 1536, zamba2's top shape, its last 512-row chunk over the
     2,056-row cache, and its B=1, S=32 prefill) beside the library call
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


def entry_point_phase():
    """Phase L: the README's entry point as a user starts it, in its own
    process group, with a bounded wait (the whole group is killed on
    timeout, so no worker process outlives the smoke)."""
    import signal
    cmd = [sys.executable, "-m", "repro_torch.launch.live_train",
           "--chain", "mobilenet", "--workers", "3", "--batches", "20",
           "--kill", "1@8", "--transport", "tcp"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    log("phase L: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure("phase L: the entry point did not finish in "
                           "300 s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  | {line}")
    check(proc.returncode == 0,
          f"phase L: exit code {proc.returncode}; stderr tail: "
          f"{err[-2000:]}")
    check("worker exit codes: {1: -9, 2: 0}" in out,
          "phase L: the entry point did not report worker exit codes "
          "{1: -9, 2: 0}")
    check("recovered: 2 workers" in out, "phase L: no recovery reported")
    out_line = {"command": " ".join(cmd[1:]), "wall_s": wall,
                "exit_code": proc.returncode}
    print(json.dumps({"entry_point": out_line}), flush=True)
    return out_line


# ------------------------- flash attention (K4) --------------------------

def flash_shapes():
    """(B, H, Hkv, Sq, Skv, dh, causal, window, q_offset) of phase A: the
    dense slice's shapes at qwen2-1.5b's heads and the hybrid slice's at
    zamba2-7b's (H = Hkv = 32, dh = 112), then the smaller head dims."""
    H, Hkv, dh = 12, 2, 128
    big = [(4, H, Hkv, 2048, 2048, dh, True, 0, 0),
           (4, H, Hkv, 1000, 1000, dh, True, 0, 0),
           (4, H, Hkv, 2048, 2048, dh, True, 256, 0),
           (4, H, Hkv, 1000, 1000, dh, False, 0, 0),
           (4, H, Hkv, 512, 2048, dh, True, 0, 1536),
           (4, 32, 32, 2048, 2048, 112, True, 0, 0)]   # zamba2-7b's
    small = [(2, 4, 2, 200, 200, d, True, 64, 0) for d in (32, 64)]
    small += [(2, 4, 2, 130, 130, d, False, 0, 0) for d in (32, 64)]
    return big, small


# zamba2-7b's B=1, 32-token prefill (phase Z (iii)): fewer rows than a block
ZAMBA2_SHORT = (1, 32, 32, 32, 32, 112, True, 0, 0)


def route2_shapes():
    """The shapes the serving paths launch route 2 (f32) at: qwen2's
    prefill and its last 512-row chunk (q_offset 1536, over 2048 keys),
    zamba2's prefill, its last chunk (over the 2,056-row cache that
    ``chunk_attention`` hands the kernel whole), and its B=1, S=32
    prefill."""
    big = flash_shapes()[0]
    return [big[0], big[4], big[5],
            (4, 32, 32, 512, PREFILL_S + DECODE_STEPS, 112, True, 0, 1536),
            ZAMBA2_SHORT]


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
    cases += [(big[i], t, "model") for i in (0, 5) for t in ("bf16", "f32")]
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
                    counters, torch):
    """``ServingEngine`` with 4 slots answers ``prompts`` greedily, f32.
    Each engine step's logits row of a request is held within 1e-4 of a
    standalone ``sequential_decode_step`` (batch 1) fed the same tokens,
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
            caches = M.init_caches(cfg, batch=1, cache_len=cache_len,
                                   dtype=torch.float32, device="cuda")
            fed = p + out[u][:-1]
            rows = eng.rows[u]
            check(len(rows) == len(fed), f"request {u}: {len(rows)} steps "
                  f"for {len(fed)} tokens")
            for pos, tok in enumerate(fed):
                lg, caches = M.sequential_decode_step(params, cfg, [[tok]],
                                                      caches, pos)
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
            "launches": launches}


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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()

    # ---- phase 1: build (one nvcc per source, together) + K1 vs plain ------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(build.build,
                             ("fused_sgd", "quant", "flash_attention",
                              "flash_attention_sm90", "ssd_scan")))
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
    torch.cuda.empty_cache()          # phase T's model is freed

    # ---- phase Z: the hybrid Mamba2 serving path ---------------------------
    z_run = hybrid_phase(torch, fops, sops)
    torch.cuda.empty_cache()

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
                 for r in z_runs}}
    top = k4_times[0]                    # B=4, S=2048, causal, bf16
    n_k4 = sum(by_run.values())
    n_route1 = sum(t_run["k4_route1"].values()) + sum(
        z_run["k4_route1"].values())
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
