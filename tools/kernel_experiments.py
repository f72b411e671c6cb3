#!/usr/bin/env python3
"""Experiments on the port's kernels, on one CUDA GPU.

    python3 tools/kernel_experiments.py k5
    python3 tools/kernel_experiments.py ab --baseline FILE
    python3 tools/kernel_experiments.py k4r2
    python3 tools/kernel_experiments.py quant [--no-cuts] [--baseline FILE]
    python3 tools/kernel_experiments.py families
    python3 tools/kernel_experiments.py k4host --baseline FILE

``k5``: where the SSD scan's (K5) time goes. Builds variants of
``csrc/ssd_scan.cu`` into ``build/experiments/``, each with pieces of
pass 3 (``ssd_chunk_out``) cut out, and times each at phase S's top shape
(B=4, S=2048, zamba2-7b's H=112, P=64, N=64, f32, zamba2's draw): the
device time of each pass (``torch.profiler``) and of a call (CUDA
events, L2 flushed). The variants compute wrong results by design; a cut
product also removes the fragment arithmetic that only feeds it, and the
cut stores are guarded by a test no output passes (a store cut outright
leaves the accumulator dead, and the compiler then drops the products
too). Then,
on the unmodified source (held against the plain version first), a sweep
of the heads a block takes and the wrapper's host time per call.

``ab``: ``csrc/flash_attention_sm90.cu`` (K4 route 1) against a baseline
copy of it (``FILE``, for example the parent commit's; compiled with the
``.cuh`` headers beside ``FILE`` where there are any, else with this
tree's): whether the two compile to the same SASS (``cuobjdump -sass``,
the anonymous namespace's name normalised), and route 1's time at
qwen2-1.5b's and zamba2-7b's top shapes (bf16, causal) in six
alternating turns.

``k4r2``: K4's route 2 (f32, and bf16 q over an f32 kv cache;
``csrc/flash_attention.cu``): ``ptxas``'s registers, spills and shared
memory for each instance, phase A of ``chip_smoke.py`` (every K4 case
against the plain version, each held to its route), then route 2's time
at the five shapes the serving paths launch it at, beside its bounds,
its plain version's and ``scaled_dot_product_attention``'s in f32 (TF32
off), as ``chip_smoke.py`` phase 4 times them. Then where its time goes,
as ``k5`` does for K5: variants of ``csrc/flash_attention.cu`` with pieces
cut (the Q.K^T products, which then leave S at 0; the P.V products and
P's split that only feeds them; the split of K and V into operand tiles;
the exps), timed at qwen2-1.5b's and zamba2-7b's top shapes in f32.

``quant``: quantize (K2) and dequantize (K3), ``csrc/quant.cu``:
``ptxas``'s registers, spills and shared memory for each kernel, phase Q
of ``chip_smoke.py`` (both bit for bit against the plain version at every
MobileNetV2-CIFAR boundary shape and the other cases there), their times
at every boundary as phase 4 takes them (device time, bound, the
wrapper's host time a call, K3's ``torch.addcmul`` yardstick); the host
time of the wrapper's pieces, PyTorch's own elementwise kernels over the
same bytes (``q.float()``, an 8 MB fill, ``torch.add(x, res)``), the time
an empty launch measures (the floor of the CUDA-event timing) and the
kernels' device time from ``torch.profiler``. With ``--baseline FILE``:
an earlier ``quant.cu`` with the C interface of the three-pass version
(two memsets, min/max, params, apply; scalar K3), called as its wrapper
did (six allocations for K2), timed against this tree's at every
boundary in turns (baseline, tree, tree, baseline), device and host time.
Then block shapes (K2's threads, blocks an SM and units a thread loads
at once; K3's launch bounds), each held bit for bit first, and K2 taken
apart at [65,536, 32] and [1,024, 160] (with a residual, z not written;
also without a residual): variants with the apply half cut, the grid
barrier cut, the fold of the blocks' partials cut, all three cut (the
load-and-reduce half alone, also as an ordinary launch), all work cut
(the launch alone), and the loads through the read-only path instead of
streaming; and the unmodified kernel with its re-read branch forced (z
not kept on chip). Every time is beside the one with the L2 left clean
(``chip_smoke.time_ms(clean=True)``). ``--no-cuts`` stops after the
times.

``families``: where the prefill time of the model families of phases
M, X and W goes: olmoe-1b-7b and xlstm-125m at B=4, S=2048 and
whisper-base over [4, 1500] frames and 448 tokens, in bf16 with
``use_flash_attention=1`` (random weights, seed 0), one warm-up forward,
then one forward under ``torch.profiler``: its wall time, the device
kernels' time summed by kind (matrix products, flash attention, casts
and copies, sort, index and scatter, scans, reductions, other
elementwise), the five kernels that took the most,
their count, and the device's idle share (1 - kernel time / wall time;
one stream, so kernels do not overlap).

``k4host``: the host time of one call of K4's wrapper
(``flash_attention_kernel``, 1,000 calls with no sync, as
``chip_smoke.host_ms`` takes it) at zamba2-7b's B=1, S=32 route-2 shape
(f32, H=Hkv=32, dh=112, causal), for this tree's wrapper and for a
baseline copy of ``kernels/flash_attention/ops.py`` (``FILE``, for
example the parent commit's), loaded beside it, in turns (baseline,
tree, tree, baseline, three times); then this tree's with a FLOP count
open (``kernels/flops.counting``: each launch adds its plain version's
count, cached by shape).

Each result is one JSON line; the card's name and power limit come last.
"""
import argparse
import contextlib
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
OUT = os.path.join(ROOT, "build", "experiments")

# pieces of pass 3, each a list of (text, replacement) in csrc/ssd_scan.cu
MX = ("""            const uint64_t dhi = kstep_desc(sXhi, k, PT);
            wgmma_tf32<PT>(acc, fl[set][kk], dhi);
            if (X_F32)
              wgmma_tf32<PT>(acc, fh[set][kk], kstep_desc(sXlo, k, PT));
            wgmma_tf32<PT>(acc, fh[set][kk], dhi);""")
Y2 = ("""            const uint64_t dhi = kstep_desc(sShi, k, PT);
            wgmma_tf32<PT>(acc, fl[set][kk], dhi);
            wgmma_tf32<PT>(acc, fh[set][kk], kstep_desc(sSlo, k, PT));
            wgmma_tf32<PT>(acc, fh[set][kk], dhi);""")
CUTS = {
    "M x products": [(MX, MX.replace("            wgmma_tf32",
                                     "            if (false) wgmma_tf32")
                      .replace("              wgmma_tf32",
                               "              if (false) wgmma_tf32"))],
    "one of three M x products": [(MX, MX.replace(
        "            wgmma_tf32<PT>(acc, fl[set][kk], dhi);",
        "            if (false) wgmma_tf32<PT>(acc, fl[set][kk], dhi);"))],
    "(exp(cum) C) h products": [(Y2, Y2.replace(
        "            wgmma_tf32", "            if (false) wgmma_tf32"))],
    "operand split": [
        ("      put4(sXhi, sXlo,", "      if (false) put4(sXhi, sXlo,"),
        ("      put4(sShi, sSlo, 16 * u,",
         "      if (false) put4(sShi, sSlo, 16 * u,")],
    # a store no output takes, so the accumulator and its products stay live
    "epilogue stores": [("        if constexpr (X_F32)\n"
                         "          *reinterpret_cast<float2*>(&yrow[p])",
                         "        if (y0 == 1234.5f && y1 == -1234.5f)\n"
                         "        if constexpr (X_F32)\n"
                         "          *reinterpret_cast<float2*>(&yrow[p])")],
    "exps": [("            if (sep && 8 * kj + 8 <= R) {",
              "            if (true) {\n              m[0] = cbv[4 * kj];\n"
              "              m[1] = cbv[4 * kj + 2];\n"
              "              m[2] = cbv[4 * kj + 1];\n"
              "              m[3] = cbv[4 * kj + 3];\n"
              "            } else if (sep && 8 * kj + 8 <= R) {")],
}
VARIANTS = [[], ["M x products"], ["one of three M x products"],
            ["(exp(cum) C) h products"], ["operand split"],
            ["epilogue stores"], ["exps"],
            ["M x products", "(exp(cum) C) h products", "operand split",
             "epilogue stores", "exps"]]


# pieces of K4's route 2, each a list of (text, replacement) in
# csrc/flash_attention.cu
K4_CUTS = {
    "Q.K^T products": [
        ("    float sc[BK / 2];\n", "    float sc[BK / 2] = {};\n"),
        ("      if (Q_F32) wgmma_tf32_ss_n32(",
         "      if (false) wgmma_tf32_ss_n32("),
        ("        wgmma_tf32_ss_n32(sc, qh, kstep_desc(sKlo",
         "        if (false) wgmma_tf32_ss_n32(sc, qh, kstep_desc(sKlo"),
        ("      wgmma_tf32_ss_n32(sc, qh, kh,",
         "      if (false) wgmma_tf32_ss_n32(sc, qh, kh,")],
    "P.V products": [
        ("      wgmma_tf32<DH>(acc, pl[kk], vh);",
         "      if (false) wgmma_tf32<DH>(acc, pl[kk], vh);"),
        ("      if (KV_F32) wgmma_tf32<DH>(acc, ph[kk]",
         "      if (false) wgmma_tf32<DH>(acc, ph[kk]"),
        ("      wgmma_tf32<DH>(acc, ph[kk], vh);",
         "      if (false) wgmma_tf32<DH>(acc, ph[kk], vh);")],
    "K and V splits": [
        ("        put4(sKhi, sKlo, 16 * (tid",
         "        if (false) put4(sKhi, sKlo, 16 * (tid"),
        ("        put4(sVhi, sVlo, even,",
         "        if (false) put4(sVhi, sVlo, even,"),
        ("        put4(sVhi, sVlo, odd,",
         "        if (false) put4(sVhi, sVlo, odd,")],
    "exps": [
        ("expf((m[i] - m_new) * sscale)", "((m[i] - m_new) * sscale)"),
        ("x = expf((x - m_new) * sscale);", "x = (x - m_new) * sscale;")],
}
K4_VARIANTS = [[], ["Q.K^T products"], ["P.V products"], ["K and V splits"],
               ["exps"], list(K4_CUTS)]


# pieces of K2, each a list of (text, replacement) in csrc/quant.cu
QUANT_CUTS = {
    "apply": [("  for (int j = jt; active && j < a.J; j += a.Jt) {  // apply",
               "  for (int j = jt; false && j < a.J; j += a.Jt) {  // apply")],
    "barrier": [("  cg::this_grid().sync();\n", "")],
    "fold": [("  if (kc) {\n    // this block's own keys",
              "  if (false) {\n    // this block's own keys")],
    # x, res and the codes read through the read-only path
    # (ld.global.nc) instead of with the streaming hint (ld.global.cs)
    "streaming loads": [
        ("    xv[k] = __ldcs(x4 + u[k]);", "    xv[k] = __ldg(x4 + u[k]);"),
        ("      rv[k] = __ldcs(reinterpret_cast<const float4*>(a.res",
         "      rv[k] = __ldg(reinterpret_cast<const float4*>(a.res"),
        ("    uint4 v = have ? __ldcs(qv + u)",
         "    uint4 v = have ? __ldg(qv + u)"),
        ("      const uint4 vn = next ? __ldcs(qv + un)",
         "      const uint4 vn = next ? __ldg(qv + un)")],
    # the launch alone: every block returns at once
    "all work": [("  const bool kc = a.keys_on_chip;\n",
                  "  const bool kc = a.keys_on_chip;\n  if (C > 0) return;\n")],
    # an ordinary launch instead of a cooperative one (only where the grid
    # barrier is cut too)
    "cooperative launch": [("cudaLaunchCooperativeKernel(",
                            "cudaLaunchKernel(")],
}
QUANT_VARIANTS = [[], ["apply"], ["barrier"], ["fold"],
                  ["barrier", "fold", "apply"],
                  ["barrier", "fold", "apply", "cooperative launch"],
                  ["all work"], ["all work", "cooperative launch"],
                  ["streaming loads"],
                  ["barrier", "fold", "apply", "streaming loads"]]
# K2's block size and units a thread loads at once, and K3's launch bounds
QUANT_SHAPES = {
    "K2 threads": "constexpr int kQuantThreads = {};",
    "K2 blocks an SM": "__launch_bounds__(kQuantThreads, {})",
    "K2 unroll": "constexpr int kUnroll = {};",
    "K3 bounds": "__global__ void __launch_bounds__(kDequantThreads{})\n"
                 "dequantize_kernel(",
}
QUANT_TUNES = [
    {"K2 threads": 1024, "K2 blocks an SM": 1, "K2 unroll": 2,
     "K3 bounds": ", 3"},
    {"K2 threads": 512, "K2 blocks an SM": 2, "K2 unroll": 2,
     "K3 bounds": ", 4"},
    {"K2 threads": 512, "K2 blocks an SM": 1, "K2 unroll": 4,
     "K3 bounds": ""}]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def compile_lib(src, name, headers=None):
    """``src`` (with the ``.cuh`` headers of ``headers``, by default this
    tree's csrc, beside it) into build/experiments/<name>/."""
    from repro_torch.kernels import build
    headers = headers or build.CSRC
    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    for header in os.listdir(headers):
        if header.endswith(".cuh"):
            with open(os.path.join(headers, header)) as f, \
                    open(os.path.join(out, header), "w") as g:
                g.write(f.read())
    lib = os.path.join(out, f"{name}.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr[-4000:]}")
    return lib


@contextlib.contextmanager
def use_library(name, path):
    """``build.load(name)`` returns the library at ``path`` meanwhile."""
    from repro_torch.kernels import build
    load, lib = build.load, ctypes.CDLL(path)
    build.load = lambda n: lib if n == name else load(n)
    try:
        yield
    finally:
        build.load = load


def cut(src, names, cuts=CUTS):
    for name in names:
        for old, new in cuts[name]:
            if old not in src:
                raise SystemExit(f"the source no longer has the text cut "
                                 f"for {name!r}: update CUTS")
            src = src.replace(old, new)
    return src


def k5():
    import concurrent.futures

    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops, ref
    src = (build.CSRC / "ssd_scan.cu").read_text()
    jobs = [(cut(src, v), f"ssd_scan_{i}") for i, v in enumerate(VARIANTS)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda j: compile_lib(*j), jobs))
    emit(built_s=time.perf_counter() - t0, variants=len(libs))
    shape = c.SSD_SHAPES[0]
    ins = c.ssd_inputs(4, 2048, "zamba2", "float32", 7, torch)
    for v, lib in zip(VARIANTS, libs):
        with use_library("ssd_scan", lib):
            rec = {"cut": v or "nothing"}
            if not v:
                got = ops.ssd_scan_kernel(*ins)
                err = (got - ref.ssd_scan_reference(*ins)).abs().max().item()
                c.check(err <= c.SSD_TOL["float32"], f"K5 differs by {err}")
                rec["max_abs_err"] = err
            rec["ms"] = c.time_ms(lambda: ops.ssd_scan_kernel(*ins), torch)
            rec["ms_by_pass"] = c.ssd_pass_times(shape, torch, ops)
            emit(**rec)
    heads = ops.heads_per_block
    with use_library("ssd_scan", libs[0]):
        try:
            for g in (1, 2, 4, 7, 8, 14, 16):
                ops.heads_per_block = lambda chunks, H, sms=ops.SMS, g=g: g
                emit(heads_per_block=g, ms_by_pass=c.ssd_pass_times(
                    shape, torch, ops))
        finally:
            ops.heads_per_block = heads
        for _ in range(5):
            ops.ssd_scan_kernel(*ins)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            ops.ssd_scan_kernel(*ins)
        emit(host_ms_per_call=1e3 * (time.perf_counter() - t0) / 20)
        torch.cuda.synchronize()


def sass(lib):
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    # the anonymous namespace's mangled name carries the file's name
    return re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN_GLOBAL__N_",
                  out)


def ab(baseline):
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    beside = os.path.dirname(os.path.abspath(baseline))
    own = any(h.endswith(".cuh") for h in os.listdir(beside))
    with open(baseline) as f:
        base = compile_lib(f.read(), "flash_attention_sm90_baseline",
                           beside if own else None)
    tree = compile_lib((build.CSRC / "flash_attention_sm90.cu").read_text(),
                       "flash_attention_sm90_tree")
    a, b = sass(base).splitlines(), sass(tree).splitlines()
    diff = [(x.strip(), y.strip()) for x, y in zip(a, b) if x != y]
    emit(same_sass=a == b, sass_lines=[len(a), len(b)],
         differing_lines=len(diff) + abs(len(a) - len(b)),
         first_differences=diff[:8])
    big = c.flash_shapes()[0]
    for shape in (big[0], big[5]):
        q, k, v = c.flash_inputs(shape, torch.bfloat16, torch.bfloat16, 99,
                                 torch)
        off, causal = shape[8], shape[6]
        times, first = {"baseline": [], "tree": []}, None
        for turn in ("baseline", "tree", "tree", "baseline", "baseline",
                     "tree"):
            with use_library("flash_attention_sm90",
                             base if turn == "baseline" else tree):
                out = fops.flash_attention_kernel(q, k, v, off, causal=causal)
                first = out if first is None else first
                c.check(torch.equal(out, first), "the two differ in output")
                times[turn].append(c.time_ms(
                    lambda: fops.flash_attention_kernel(
                        q, k, v, off, causal=causal), torch, reps=50))
        emit(shape=c.describe(shape), ms=times)


def k4r2():
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    lib = build.build("flash_attention")
    name = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            emit(kernel=name, ptxas=line.split(":", 1)[-1].strip())
    smem = build.load("flash_attention").flash_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    emit(smem_bytes={f"dh={d} q_bf16={qb} kv_bf16={kb}": smem(d, qb, kb)
                     for d in (32, 64, 112, 128)
                     for qb, kb in ((0, 0), (1, 0), (0, 1))})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, rels = c.flash_phase(torch, fops, fref)
    emit(phase_a_max_abs_err=errs, phase_a_rel_l2=rels)
    for shape in c.route2_shapes():
        t = c.flash_timings(shape, torch, fops, fref, "float32")
        emit(**{k: t[k] for k in ("B", "H", "Hkv", "Sq", "Skv", "dh",
                                  "q_offset", "ms", "bound_ms",
                                  "bound_ms_3xtf32", "plain_ms",
                                  "library_ms")})

    import concurrent.futures
    src = (build.CSRC / "flash_attention.cu").read_text()
    jobs = [(cut(src, names, K4_CUTS), "k4r2_" + "_".join(
        "".join(ch for ch in n if ch.isalnum()) for n in names) or "k4r2")
        for names in K4_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda j: compile_lib(*j), jobs))
    big = c.flash_shapes()[0]
    for shape in (big[0], big[5]):
        B, H, Hkv, Sq, Skv, dh, causal, window, off = shape
        q, k, v = c.flash_inputs(shape, torch.float32, torch.float32, 99,
                                 torch)
        for names, lib in zip(K4_VARIANTS, libs):
            with use_library("flash_attention", lib):
                ms = c.time_ms(lambda: fops.flash_attention_kernel(
                    q, k, v, off, causal=causal, window=window), torch)
            emit(shape=c.describe(shape), cut=names, ms=ms)


def baseline_quant(path):
    """K2 and K3 of an earlier quant.cu with the three-pass C interface,
    allocating as its wrapper did: (k2(x, res), k3(q, lo, scale))."""
    import torch

    from repro_torch.kernels.quant.ref import inv_levels
    lib = ctypes.CDLL(compile_lib(open(path).read(), "quant_baseline"))
    vp = ctypes.c_void_p
    q2, q3 = lib.quantize_ef_launch, lib.dequantize_launch
    q2.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float] + [vp] * 8
    q3.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp, vp]
    q2.restype = q3.restype = ctypes.c_int

    def k2(x, res):
        C = x.shape[-1]
        q = torch.empty(x.shape, dtype=torch.uint8, device="cuda")
        lo = torch.empty(C, device="cuda")
        scale = torch.empty(C, device="cuda")
        res2 = torch.empty_like(x)
        ok = torch.empty((), dtype=torch.bool, device="cuda")
        scratch = torch.empty(2 * C + 1, dtype=torch.int32, device="cuda")
        rc = q2(x.data_ptr(), res.data_ptr(), x.numel() // C, C, 255,
                inv_levels(255), q.data_ptr(), lo.data_ptr(),
                scale.data_ptr(), res2.data_ptr(), None, ok.data_ptr(),
                scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return q, lo, scale, res2, ok

    def k3(q, lo, scale):
        out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        rc = q3(q.data_ptr(), lo.data_ptr(), scale.data_ptr(), q.numel(),
                q.shape[-1], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    return k2, k3


def quant_host_pieces(torch, qops):
    """Host time (us a call, 2,000 calls) of the pieces of a K2 call at
    [65,536, 32], and the kernels' device time from torch.profiler."""
    import chip_smoke as c
    from torch.profiler import ProfilerActivity, profile
    x, res = c.quant_inputs(65536, 32, 7, True, torch)
    dev = x.device
    plan = qops.quantize_plan(x, res)
    pieces = {
        "quantize_plan": lambda: qops.quantize_plan(x, res),
        "torch.empty": lambda: torch.empty(x.shape, dtype=torch.uint8,
                                           device=dev),
        "split": lambda: torch.empty(64, device=dev).split([32, 32]),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr": lambda: x.data_ptr(),
        "whole K2 call": lambda: qops.quantize_ef(x, res, with_z=False),
        "whole K3 call": lambda: qops.dequantize(*k2out[:3]),
    }
    k2out = qops.quantize_ef(x, res, with_z=False)
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
    emit(host_us_a_call=out, grid=plan.grid, smem=plan.smem)
    # PyTorch's own elementwise kernels over the same bytes: K3's (2 MB
    # of codes read, 8 MB of f32 written) and K2's read of x and res
    # with z written
    q8 = k2out[0]
    dst = torch.empty_like(x)
    for name, fn in (("q.float()", lambda: q8.float()),
                     ("fill 8 MB", lambda: dst.fill_(1.0)),
                     ("torch.add(x, res, out=z)",
                      lambda: torch.add(x, res, out=dst))):
        emit(yardstick=name, ms=c.time_ms(fn, torch),
             ms_clean_l2=c.time_ms(fn, torch, clean=True))
    one = torch.empty(1, device=dev)
    emit(event_floor_ms=c.time_ms(lambda: one.zero_(), torch),
         event_floor_ms_clean_l2=c.time_ms(lambda: one.zero_(), torch,
                                           clean=True))
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flush.zero_()
            qops.quantize_ef(x, res, with_z=False)
            flush.zero_()
            qops.dequantize(*k2out[:3])
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        for name in ("quantize_ef_kernel", "dequantize_kernel"):
            if name in e.key:
                us = (getattr(e, "device_time_total", None)
                      or getattr(e, "cuda_time_total", 0) or 0)
                dev_ms[name] = us / 1e3 / 20
    emit(profiler_device_ms=dev_ms)


def quant(cuts=True, baseline=None):
    import concurrent.futures

    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.runtime.workload import WorkloadSpec
    for name, what in c.ptxas_lines(build.build("quant")):
        emit(kernel=name, ptxas=what)
    chain, batches = WorkloadSpec(kind="mobilenet", image_hw=32,
                                  batch_size=64).build(device="cuda")
    shapes = c.boundary_shapes(chain, batches[0], torch)
    emit(phase_q_max_abs_err=c.quant_phase(shapes, torch, qops, qref))
    for rows, C in shapes:
        k2, k3 = c.quant_timings(rows, C, torch, qops, qref)
        emit(K2=k2, K3=k3)
    quant_host_pieces(torch, qops)
    if baseline:
        old2, old3 = baseline_quant(baseline)
        for rows, C in shapes:
            x, res = c.quant_inputs(rows, C, 7, True, torch)
            q, lo, scale, *_ = qops.quantize_ef(x, res)
            new2 = lambda: qops.quantize_ef(x, res, with_z=False)  # noqa
            new3 = lambda: qops.dequantize(q, lo, scale)           # noqa
            o2 = old2(x, res)
            c.check(all(torch.equal(a, b) for a, b in zip(o2, new2())),
                    "the baseline K2 differs")
            c.check(torch.equal(old3(q, lo, scale), new3()),
                    "the baseline K3 differs")
            rec = {"rows": rows, "C": C}
            for turn in ("baseline", "tree", "tree", "baseline"):
                f2 = (lambda: old2(x, res)) if turn == "baseline" else new2
                f3 = (lambda: old3(q, lo, scale)) if turn == "baseline" \
                    else new3
                for k, f in (("K2", f2), ("K3", f3)):
                    rec.setdefault(f"{k}_{turn}_ms", []).append(
                        c.time_ms(f, torch))
                    rec.setdefault(f"{k}_{turn}_ms_clean_l2", []).append(
                        c.time_ms(f, torch, clean=True))
                    rec.setdefault(f"{k}_{turn}_host_ms", []).append(
                        c.host_ms(f, torch))
            emit(**rec)
    if not cuts:
        return
    src = (build.CSRC / "quant.cu").read_text()
    tree = {k: next(v for v in (QUANT_SHAPES[k].format(x) for x in
                                (1024, 512, 256, 4, 2, 1, 8, ", 4", ", 3",
                                 ""))
                    if v in src) for k in QUANT_SHAPES}
    tunes = []
    for tune in QUANT_TUNES:
        text = src
        for k, v in tune.items():
            text = text.replace(tree[k], QUANT_SHAPES[k].format(v))
        tunes.append(text)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        tuned = list(pool.map(lambda j: compile_lib(j[1], f"quant_tune{j[0]}"),
                              enumerate(tunes)))
    threads, sms = qops.K2_THREADS, qops._sms
    for tune, lib in zip(QUANT_TUNES, tuned):
        qops.K2_THREADS = tune["K2 threads"]
        qops._sms = lambda i, k=tune["K2 blocks an SM"]: k * sms(i)
        qops._quantize_plan.cache_clear()
        try:
            for rows, C in (shapes[0], shapes[-1]):
                x, res = c.quant_inputs(rows, C, 7, True, torch)
                want = qref.quantize_ef_reference(x, res)
                with use_library("quant", lib):
                    got = qops.quantize_ef(x, res)
                    c.check(all(c.same(a, b, torch) for a, b in
                                zip(got, want)), f"{tune} differs")
                    dq = qops.dequantize(*got[:3])
                    c.check(torch.equal(dq, qref.dequantize_reference(
                        *got[:3])), f"{tune} K3 differs")
                    k2 = lambda: qops.quantize_ef(x, res,  # noqa: E731
                                                  with_z=False)
                    k3 = lambda: qops.dequantize(*got[:3])  # noqa: E731
                    emit(tune=tune, rows=rows, C=C,
                         K2_ms=c.time_ms(k2, torch),
                         K2_ms_clean_l2=c.time_ms(k2, torch, clean=True),
                         K3_ms=c.time_ms(k3, torch),
                         K3_ms_clean_l2=c.time_ms(k3, torch, clean=True))
        finally:
            qops.K2_THREADS, qops._sms = threads, sms
            qops._quantize_plan.cache_clear()
    for tune, lib in zip(QUANT_TUNES, tuned):
        emit(tune=tune, ptxas=[f"{n[-40:]}: {w}" for n, w in
                               c.ptxas_lines(pathlib.Path(lib))])
    jobs = [(cut(src, names, QUANT_CUTS),
             "quant_" + "_".join(names) if names else "quant_tree")
            for names in QUANT_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda j: compile_lib(*j), jobs))
    plan = qops._quantize_plan

    def reread(*args):
        p = plan(*args)
        return p._replace(z_on_chip=False,
                          smem=p.smem - p.per_block * p.period_units * 16)

    for rows, C in (shapes[0], shapes[-1]):
        x, res = c.quant_inputs(rows, C, 7, True, torch)
        k2 = lambda: qops.quantize_ef(x, res, with_z=False)  # noqa: E731
        for names, lib in zip(QUANT_VARIANTS, libs):
            with use_library("quant", lib):
                rec = dict(rows=rows, C=C, cut=names or "nothing",
                           ms=c.time_ms(k2, torch),
                           ms_clean_l2=c.time_ms(k2, torch, clean=True),
                           ms_without_res=c.time_ms(
                               lambda: qops.quantize_ef(x, with_z=False),
                               torch))
                if "streaming loads" in names or not names:
                    q, lo, scale, *_ = qops.quantize_ef(x, res)
                    rec["K3_ms"] = c.time_ms(
                        lambda: qops.dequantize(q, lo, scale), torch)
                emit(**rec)
        qops._quantize_plan = reread
        try:
            want = qref.quantize_ef_reference(x, res)
            got = k2()
            c.check(all(c.same(a, b, torch) for a, b in zip(got[:4], want)),
                    "the forced re-read branch differs from plain")
            emit(rows=rows, C=C, cut="re-read forced (z not kept on chip)",
                 ms=c.time_ms(k2, torch),
                 ms_clean_l2=c.time_ms(k2, torch, clean=True))
        finally:
            qops._quantize_plan = plan


KERNEL_KINDS = (            # (kind, substrings of a device kernel's name)
    ("flash_attention", ("flash_attention",)),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk",
                "dot_kernel")),
    ("cast_copy", ("copy", "cat")),
    ("sort", ("sort", "radix")),
    ("index_scatter", ("index", "scatter", "gather")),
    ("scan", ("cumsum", "scan")),
    ("reduce", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "launch_kernel")),
)


def kernel_kind(name):
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def families():
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    for name in ("flash_attention", "flash_attention_sm90"):
        build.build(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("olmoe-1b-7b", "xlstm-125m", "whisper-base"):
        cfg = get_config(arch).with_overrides(tensor_parallel=1,
                                              use_flash_attention=1)
        params = M.init_params(0, cfg, device="cuda")
        rng = np.random.default_rng(0)
        if cfg.family == "audio":
            frames = torch.as_tensor(rng.standard_normal(
                (c.PREFILL_B, cfg.num_audio_frames, cfg.d_model)).astype(
                np.float32), device="cuda")
            toks, _ = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).sample(
                rng, c.PREFILL_B, cfg.max_target_positions)
            tokens = torch.as_tensor(toks, device="cuda")

            def fwd():
                return M.sequential_encdec_forward(params, cfg, frames,
                                                   tokens)[0]
        else:
            toks, _ = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).sample(
                rng, c.PREFILL_B, c.PREFILL_S)
            tokens = torch.as_tensor(toks, device="cuda")

            def fwd():
                return M.sequential_lm_forward(params, cfg, tokens)[0]
        with torch.no_grad():
            fwd()                                     # warm-up
            _, summary = profiled(fwd, torch)
        emit(family=cfg.family, config=arch, dtype=cfg.dtype, **summary)
        del params
        torch.cuda.empty_cache()


def device_summary(prof, wall):
    """A profiled window: its wall time, the device kernels' time summed
    by kind, the five kernels that took the most, their count, and the
    device's idle share (1 - kernel time / wall time; one stream)."""
    from torch.autograd import DeviceType
    by_kind, by_name, count, total = {}, {}, 0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + ms
        count += 1
        total += ms
    return dict(wall_ms=wall * 1e3, device_kernel_ms=total, kernels=count,
                idle_share=1.0 - total / (wall * 1e3),
                device_ms_by_kind=dict(sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])),
                top_kernels_ms=dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:5]))


def profiled(fn, torch):
    """(fn's result, the device summary of one call under the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, device_summary(prof, wall)


def k4host(baseline):
    import importlib.util
    import statistics
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.kernels import flops
    from repro_torch.kernels.flash_attention import ops
    spec = importlib.util.spec_from_file_location("k4_baseline_ops",
                                                  baseline)
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 32, 32, 112)).astype(
        np.float32), device="cuda") for _ in range(3))
    want = ops.attention_reference(q, k, v, causal=True)
    for mod in (base, ops):
        err = (mod.flash_attention_kernel(q, k, v, causal=True) - want) \
            .abs().max().item()
        if err > c.FLASH_TOL["float32"]:
            raise SystemExit(f"{mod.__name__}: off by {err}")
    times = {"baseline": [], "tree": []}
    for _ in range(3):
        for name in ("baseline", "tree", "tree", "baseline"):
            mod = base if name == "baseline" else ops
            times[name].append(c.host_ms(lambda: mod.flash_attention_kernel(
                q, k, v, causal=True), torch))
    with flops.counting():
        counting = [c.host_ms(lambda: ops.flash_attention_kernel(
            q, k, v, causal=True), torch) for _ in range(3)]
    emit(what="k4_wrapper_host_ms", shape="B=1 H=Hkv=32 S=32 dh=112 causal "
         "f32 (route 2)", baseline_file=baseline,
         **{f"{n}_ms": t for n, t in times.items()},
         **{f"{n}_median_ms": statistics.median(t) for n, t in times.items()},
         counting_ms=counting, counting_median_ms=statistics.median(counting))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    sub.add_parser("k5")
    q = sub.add_parser("ab")
    q.add_argument("--baseline", required=True)
    sub.add_parser("k4r2")
    sub.add_parser("families")
    q = sub.add_parser("k4host")
    q.add_argument("--baseline", required=True)
    q = sub.add_parser("quant")
    q.add_argument("--no-cuts", action="store_true")
    q.add_argument("--baseline")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU")
    import chip_smoke as c
    print(c.card_line(), flush=True)
    if args.what == "k5":
        k5()
    elif args.what == "ab":
        ab(args.baseline)
    elif args.what == "k4r2":
        k4r2()
    elif args.what == "families":
        families()
    elif args.what == "k4host":
        k4host(args.baseline)
    else:
        quant(not args.no_cuts, args.baseline)
    print(c.card_line(), flush=True)


if __name__ == "__main__":
    main()
