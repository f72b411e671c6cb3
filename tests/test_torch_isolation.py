"""The PyTorch port stands alone: it imports neither JAX nor the reference
package (nor do its alias ``ftpipehd_torch`` and its examples in
``examples_torch/``, which also leave ``benchmarks/`` alone), and it
never falls back to the CPU on its own — an entry point
asked (or left) to compute on CUDA raises where there is none, and a CUDA
kernel launches or raises."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_sgd import ops  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.runtime import live, stage_executor, transport  # noqa: E402
from repro_torch.runtime import workload as wl  # noqa: E402
from repro_torch.runtime.devices import resolve_device  # noqa: E402
from repro_torch.runtime.qtensor import DeviceQuantized  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ALIAS = ROOT / "src" / "ftpipehd_torch"
EXAMPLES = ROOT / "examples_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ftpipehd", "benchmarks")


def _examples():
    return sorted(EXAMPLES.glob("*.py"))


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + sorted(ALIAS.rglob("*.py"))
            + [ROOT / "chip_smoke.py"] + _examples())


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in [*PORT.rglob("*.py"), *ALIAS.rglob("*.py")])


def test_no_forbidden_import_in_the_source():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_examples_and_the_alias_are_all_there():
    """Every example of ``examples/`` has its port under its own name."""
    assert ({p.name for p in _examples()}
            == {p.name for p in (ROOT / "examples").glob("*.py")})
    assert (ALIAS / "__init__.py").exists()


def test_importing_every_module_loads_no_jax_nor_reference():
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            f"for i, p in enumerate({[str(p) for p in _examples()]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_alias_runs_without_jax_installed():
    """``from ftpipehd_torch.run import Run`` with every JAX import made
    to fail, as on a machine that has no JAX."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'ftpipehd'):\n"
            "    sys.modules[m] = None\n"
            "from ftpipehd_torch.run import Run, RunConfig, start_run\n"
            "import repro_torch.run\n"
            "assert Run is repro_torch.run.Run\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-fallback rule is "
                    "checked where there is none")


def test_entry_points_raise_without_cuda_unless_told_cpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        wl.WorkloadSpec().build()
    chain, batches = wl.WorkloadSpec().build(device="cpu")
    sl = chain.flat_layout().slice(0, 1)
    with pytest.raises(RuntimeError):
        stage_executor.StageExecutor(chain, sl, last=False, lr=0.1)
    with pytest.raises(RuntimeError):
        live.run_live_training(chain, batches, live.LiveConfig())
    with pytest.raises(RuntimeError):
        live.run_live_training(chain, batches, live.LiveConfig(device="cuda"))


def test_transformer_entry_points_raise_without_cuda_unless_told_cpu():
    _no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    cfg = get_config("qwen2-1.5b").reduced(num_layers=2, vocab_size=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_caches(cfg, batch=1, cache_len=8)
    params = model.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    eng = ServingEngine(cfg, params, max_slots=1, cache_len=8, device="cpu")
    eng.submit([1, 2], max_new_tokens=2)
    assert len(eng.run_until_drained()[1]) == 2


def test_fused_sgd_raises_instead_of_falling_back():
    n0 = ops.fused_sgd.launches
    p, g, m = (torch.zeros(8, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        ops.fused_sgd(p, g, m, lr=0.1)
    with pytest.raises(ValueError):           # mixed devices
        ops.fused_sgd(torch.zeros(8), g, m, lr=0.1)
    assert ops.fused_sgd.launches == n0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_library_key_follows_the_source():
    path = build.library_path("fused_sgd")
    assert path.parent == ROOT / "build" / "repro_torch"
    assert path.name.startswith("fused_sgd-") and path.suffix == ".so"
    assert build.library_path("fused_sgd") == path     # deterministic


def test_library_key_follows_the_headers_the_source_includes(monkeypatch,
                                                             tmp_path):
    """An edited ``.cuh`` rebuilds every source that includes it, directly
    or through another header, and no other."""
    (tmp_path / "a.cu").write_text('#include "x.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "x.cuh").write_text('  # include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("// y\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("a")] == ["a.cu", "x.cuh", "y.cuh"]
    assert [p.name for p in build.sources("b")] == ["b.cu"]
    a, b = build.library_path("a"), build.library_path("b")
    (tmp_path / "y.cuh").write_text("// y, edited\n")
    assert build.library_path("a") != a and build.library_path("b") == b
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_path("b") != b


def test_quant_raises_instead_of_falling_back():
    n0 = (qops.quantize_ef.launches, qops.dequantize.launches)
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        qops.quantize_ef(x)
    with pytest.raises(ValueError):           # mixed devices
        qops.quantize_ef(torch.zeros(4, 8), x)
    with pytest.raises(ValueError):           # wrong dtype
        qops.quantize_ef(torch.zeros(4, 8, dtype=torch.float64))
    q = torch.zeros(4, 8, dtype=torch.uint8)
    lo = torch.zeros(8)
    with pytest.raises(ValueError):
        qops.dequantize(q.to("meta"), lo.to("meta"), lo.to("meta"))
    with pytest.raises(ValueError):           # mixed devices
        qops.dequantize(q, lo.to("meta"), lo)
    with pytest.raises(ValueError):           # wrong dtype
        qops.dequantize(q.to(torch.int8), lo, lo)
    assert (qops.quantize_ef.launches, qops.dequantize.launches) == n0


def test_tcp_transport_raises_not_implemented():
    """The tcp factory once raised NotImplementedError (net.py unported).
    Now it builds the port's SocketTransport from ``addr_of``/``local``
    and raises ValueError without them."""
    from repro_torch.runtime import net
    with pytest.raises(ValueError, match="addr_of and local"):
        transport.Transport.create("tcp")
    with pytest.raises(ValueError, match="addr_of and local"):
        transport.Transport.create("tcp", addr_of={0: ("127.0.0.1", 1)})
    addr_of = net.cluster_addresses(2)
    t = transport.Transport.create("tcp", addr_of=addr_of,
                                   local=(live.COORD, 0), reliable=True)
    try:
        assert isinstance(t, net.SocketTransport) and t.is_networked
        assert t.local == (live.COORD, 0) and t._rel_on
    finally:
        t.close()


def test_int8_fused_tier_is_accepted():
    chain, batches = wl.WorkloadSpec().build(device="cpu")
    live.Coordinator(chain, lambda b: batches[b % len(batches)],
                     live.LiveConfig(device="cpu", wire_compress="int8-fused"))
    sl = chain.flat_layout().slice(0, 1)
    ex = stage_executor.StageExecutor(chain, sl, last=False, lr=0.1,
                                      device="cpu")
    payload, res = ex.forward_q(sl.pack(chain.flat_params(0, 1)),
                                batches[0]["x"], None)
    assert isinstance(payload, DeviceQuantized)
    assert payload.shape == tuple(res.shape)


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "cuda.is_available() is false" in proc.stderr


def test_chip_smoke_fails_without_the_port_beside_it(tmp_path):
    """Alone in a directory, even with a (pretended) GPU, the script
    exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "not beside this script" in proc.stderr
