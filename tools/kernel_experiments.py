#!/usr/bin/env python3
"""Experiments on the port's tensor-core kernels, on one CUDA GPU.

    python3 tools/kernel_experiments.py k5
    python3 tools/kernel_experiments.py ab --baseline FILE

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
copy of it (``FILE``, for example the parent commit's): whether the two
compile to the same SASS (``cuobjdump -sass``, the anonymous namespace's
name normalised), and route 1's time at qwen2-1.5b's and zamba2-7b's top
shapes (bf16, causal) in six alternating turns.

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


def emit(**kw):
    print(json.dumps(kw), flush=True)


def compile_lib(src, name):
    """``src`` (with the csrc headers beside it) into build/experiments/."""
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    for header in os.listdir(build.CSRC):
        if header.endswith(".cuh"):
            with open(build.CSRC / header) as f, \
                    open(os.path.join(OUT, header), "w") as g:
                g.write(f.read())
    lib = os.path.join(OUT, f"{name}.so")
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


def cut(src, names):
    for name in names:
        for old, new in CUTS[name]:
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
    with open(baseline) as f:
        base = compile_lib(f.read(), "flash_attention_sm90_baseline")
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


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    sub.add_parser("k5")
    q = sub.add_parser("ab")
    q.add_argument("--baseline", required=True)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU")
    import chip_smoke as c
    k5() if args.what == "k5" else ab(args.baseline)
    print(c.card_line(), flush=True)


if __name__ == "__main__":
    main()
