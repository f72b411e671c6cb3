#!/usr/bin/env python3
"""Experiments on the port's tensor-core kernels, on one CUDA GPU.

    python3 tools/kernel_experiments.py k5
    python3 tools/kernel_experiments.py ab --baseline FILE
    python3 tools/kernel_experiments.py k4r2

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

Each result is one JSON line; the card's name and power limit come last.
"""
import argparse
import contextlib
import ctypes
import json
import os
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


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    sub.add_parser("k5")
    q = sub.add_parser("ab")
    q.add_argument("--baseline", required=True)
    sub.add_parser("k4r2")
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
    else:
        k4r2()
    print(c.card_line(), flush=True)


if __name__ == "__main__":
    main()
