"""The port's launch tooling: the kernels' FLOP counts on every device
(``repro_torch.kernels.flops``, ``compat.cost_analysis``), the meta
stand-ins (``launch/specs.py``) against the JAX package's
``ShapeDtypeStruct``s, the production and train meshes, and the dry run
(``launch/dryrun.py``) on the meta device.

A FLOP count must read the same work however a step runs: on the CPU
the wrappers run their plain version, on meta its shapes, and on CUDA a
kernel launch adds its plain version's count (the card's half of that is
``chip_smoke.py`` phase D). The stand-ins are held equal to the JAX
package's at full width for every architecture: shapes, dtypes and
partition specs, and the bytes a device holds of them on the JAX
package's 8-host-device debug mesh.
"""
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import mesh as jmesh_lib  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import axis_types_kwarg  # noqa: E402
from repro_torch import compat, tree  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, TrainConfig,  # noqa: E402
                                 get_config)
from repro_torch.kernels import flops as kflops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline.pipeline_step import make_train_step  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as c:
        fn(*args, **kw)
    return c.get_total_flops()


def _on(device, *arrays, grad=False):
    return [None if a is None else
            torch.from_numpy(a).to(device).requires_grad_(grad)
            for a in arrays]


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------- kernel FLOP counts --

def _k4_fwd_bwd(device):
    q, k, v = _on(device, *_rand(0, (2, 4, 40, 32), (2, 2, 40, 32),
                                 (2, 2, 40, 32)), grad=True)
    out = fa.flash_attention(q, k, v, causal=True, window=8)
    out.sum().backward()
    qc, kc, vc = _on(device, *_rand(1, (2, 4, 8, 64), (2, 2, 24, 64),
                                    (2, 2, 24, 64)))
    fa.flash_attention_kernel(qc, kc, vc, 16, causal=True)


def _k5_fwd_bwd(device):
    B, S, H, P, N = 2, 200, 3, 32, 16
    xh, Bm, Cm, h0 = _on(device, *_rand(2, (B, S, H, P), (B, S, N),
                                        (B, S, N), (B, H, P, N)), grad=True)
    rng = np.random.default_rng(3)
    dt, A, D = _on(device, rng.uniform(0.01, 0.1, (B, S, H)).astype(
        np.float32), -rng.uniform(0.5, 2, (H,)).astype(np.float32),
        np.ones((H,), np.float32))
    y, h = ssd.ssd_scan(xh, dt, A, Bm, Cm, D, chunk=128, h0=h0)
    (y.sum() + h.sum()).backward()
    ssd.ssd_scan_kernel(xh.detach(), dt, A, Bm.detach(), Cm.detach(), D,
                        chunk=64)


@pytest.mark.parametrize("call", [_k4_fwd_bwd, _k5_fwd_bwd],
                         ids=["K4", "K5"])
def test_kernel_call_counts_the_same_on_cpu_and_meta(call):
    """The wrappers' meta branch runs the plain version on meta tensors:
    the counter sees the same matmuls as on the CPU, forward and
    backward."""
    cpu = _counted(call, "cpu")
    assert cpu > 0
    assert _counted(call, "meta") == cpu


def test_plain_flops_is_the_counters_count_of_the_plain_version():
    q, k, v = _on("cpu", *_rand(4, (1, 4, 24, 32), (1, 2, 56, 32),
                                (1, 2, 56, 32)))
    want = _counted(attention_reference, q, k, v, causal=True, window=0,
                    scale=0.25, q_offset=32)
    got = kflops.plain_flops(attention_reference, (q, k, v), causal=True,
                             window=0, scale=0.25, q_offset=32)
    assert got == want > 0
    # cached by shape and dtype: a second call with other values agrees
    assert kflops.plain_flops(attention_reference, (q * 2, k, v),
                              causal=True, window=0, scale=0.25,
                              q_offset=32) == want


def test_cost_analysis_adds_the_kernels_tallies_while_counting():
    """A launch on CUDA adds to its wrapper's tally only while a count is
    open (here the additions a launch makes are made by hand)."""
    assert kflops.open_counts == 0

    def fn():
        assert kflops.open_counts == 1
        kflops.add(fa.flash_attention_kernel, 1000)
        kflops.add(ssd.ssd_scan_kernel, 24)
        return torch.ones(2, 3) @ torch.ones(3, 4)

    got = compat.cost_analysis(fn)
    assert kflops.open_counts == 0
    assert got == {"flops": 1000 + 24 + 48.0, "flops_aten": 48.0,
                   "flops_kernels": {"flash_attention": 1000.0,
                                     "ssd_scan": 24.0}}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-7b", "xlstm-125m"])
def test_engine_train_step_counts_the_same_on_cpu_and_meta(arch):
    """A reduced train step through the engine (remat, K4 and, for
    zamba2, K5 on the path): the same count on the CPU and on meta (the
    sequence is a multiple of K5's chunk, which meta takes as CUDA
    does; xLSTM's sLSTM runs its loop on the CPU and all steps at once
    on meta)."""
    cfg = get_config(arch).reduced(pipeline_stages=2, dtype="bfloat16",
                                   use_flash_attention=1)
    counts = []
    for dev in ("cpu", "meta"):
        step, _ = make_train_step(mesh_lib.make_debug_mesh(1, 2, 1, dev),
                                  cfg, TrainConfig(remat=True,
                                                   microbatches=2))
        state = step.init_state(M.init_params(0, cfg, device=dev))
        toks = torch.zeros((2, 128), dtype=torch.int32, device=dev)
        counts.append(compat.cost_analysis(
            step, state, {"tokens": toks, "labels": toks})["flops"])
    assert counts[0] > 0 and counts[1] == counts[0]


def test_meta_params_hold_no_memory_and_match_cpu_shapes():
    cfg = get_config("zamba2-7b").reduced(pipeline_stages=2)
    meta = M.init_params(0, cfg, device="meta")
    cpu = M.init_params(0, cfg, device="cpu")
    for m, c in zip(tree.leaves(meta), tree.leaves(cpu), strict=True):
        assert m.is_meta and (m.shape, m.dtype) == (c.shape, c.dtype)


# --------------------------------------------------------- stand-ins --

@pytest.fixture(scope="module")
def jmesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices")
    return jax.make_mesh((2, 2, 2), ("data", "stage", "tensor"),
                         **axis_types_kwarg(3))


def _pairs(cfg, jcfg, mesh, jmesh):
    """(name, (port tensors, port specs), JAX stand-ins) of every
    ``*_sds`` function, at full width."""
    out = []
    for opt in ("sgd", "adam"):
        out.append((f"state_{opt}",
                    specs.state_sds(cfg, mesh, TrainConfig(optimizer=opt)),
                    jspecs.state_sds(jcfg, jmesh,
                                     JTrainConfig(optimizer=opt))))
    out.append(("params", specs.params_sds(cfg, mesh),
                jspecs.params_sds(jcfg, jmesh)))
    for name in ("train_4k", "prefill_32k"):
        out.append((f"batch_{name}",
                    specs.train_batch_sds(cfg, SHAPES[name], mesh),
                    jspecs.train_batch_sds(jcfg, JSHAPES[name], jmesh)))
    if cfg.family != "audio":
        out.append(("prefill_caches",
                    specs.prefill_caches_sds(cfg, SHAPES["prefill_32k"],
                                             mesh),
                    jspecs.prefill_caches_sds(jcfg, JSHAPES["prefill_32k"],
                                              jmesh)))
    for name in ("decode_32k", "long_500k"):
        c = specs.shape_overrides(cfg, SHAPES[name])
        jc = jspecs.shape_overrides(jcfg, JSHAPES[name])
        (dec, dec_sp) = specs.decode_inputs_sds(c, SHAPES[name], mesh)
        jdec = jspecs.decode_inputs_sds(jc, JSHAPES[name], jmesh)
        assert dec.pop("data_sharded") == jdec.pop("data_sharded")
        out.append((f"decode_{name}", (dec, dec_sp), jdec))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_ins_equal_the_jax_packages(arch, jmesh):
    """Every stand-in's shape, dtype and spec equals the JAX stand-in's,
    and ``bytes_per_device`` equals the bytes of the JAX stand-ins'
    shards (``NamedSharding.shard_shape``) on the (2, 2, 2) mesh."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = mesh_lib.make_debug_mesh(2, 2, 2, device="meta")
    for name, (tensors, sp), jtree in _pairs(cfg, jcfg, mesh, jmesh):
        leaves, jleaves = tree.leaves(tensors), jax.tree.leaves(jtree)
        sps = tree.leaves(sp)
        assert len(leaves) == len(jleaves) == len(sps), name
        jbytes = 0
        for t, s, j in zip(leaves, sps, jleaves):
            assert t.is_meta, name
            assert tuple(t.shape) == j.shape, name
            assert t.dtype == DTYPES[str(j.dtype)], name
            assert tuple(s) == tuple(j.sharding.spec), name
            jbytes += math.prod(j.sharding.shard_shape(j.shape)) \
                * j.dtype.itemsize
        assert specs.bytes_per_device(tensors, sp, mesh) == jbytes, name


def test_production_and_train_meshes_are_the_jax_packages():
    assert mesh_lib.make_production_mesh(device="meta").shape == {
        "data": jmesh_lib.DATA_AXIS, "model": jmesh_lib.MODEL_AXIS}
    assert mesh_lib.make_production_mesh(multi_pod=True,
                                         device="meta").shape == {
        "pod": jmesh_lib.NUM_PODS, "data": jmesh_lib.DATA_AXIS,
        "model": jmesh_lib.MODEL_AXIS}
    devices = jax.devices() * (512 // jax.device_count())
    for S, T, extra in ((4, 4, 1), (16, 1, 1), (2, 8, 1), (2, 4, 2),
                        (4, 1, 4)):
        for mp in (False, True):
            m = mesh_lib.make_train_mesh(S, T, extra_data=extra,
                                         multi_pod=mp, device="meta")
            j = jmesh_lib.make_train_mesh(S, T, extra_data=extra,
                                          multi_pod=mp, devices=devices)
            assert m.axis_names == tuple(j.axis_names)
            assert m.axis_sizes == j.devices.shape
            assert m.device.type == "meta"
    with pytest.raises(AssertionError):
        jmesh_lib.make_train_mesh(4, 2, devices=devices)
    with pytest.raises(ValueError, match="!= 16"):
        mesh_lib.make_train_mesh(4, 2, device="meta")


# ----------------------------------------------------------- dry run --

KEYS = {"arch", "shape", "mesh", "chips", "stage_x_tensor", "microbatches",
        "ticks", "data_sharded", "device", "trace_s", "compile_s",
        "traced_flops_per_device", "hlo_bytes_raw", "hlo_collectives_raw",
        "bytes_per_device", "flops_per_device", "flops_per_device_ticks_m",
        "collective_bytes_per_device", "hbm_bytes_per_device",
        "roofline", "dominant", "model_flops", "useful_ratio"}


@pytest.mark.parametrize("arch,shape,over,ratio", [
    ("whisper-base", "train_4k", None, (0.65, 1.35)),
    ("qwen2-1.5b", "prefill_32k", {"prefill_seq_chunks": 8}, None),
    ("chatglm3-6b", "decode_32k", None, None),
])
def test_lower_combo_on_meta(arch, shape, over, ratio):
    """A full-width combo of each kind traced on meta: the JAX report's
    keys, null where they have no meaning, the H100 roofline, and (train)
    the traced count within 35% of the analytic count at ticks = M. A
    prefill chunk attends over the whole cache, masked, where the
    analytic count takes a causal half of the keys; at 32k that doubles
    the attention's part, so the chunked count is held above the
    analytic one only."""
    rep = dryrun.lower_combo(arch, shape, False, over)
    assert set(rep) == KEYS
    assert rep["device"] == "meta" and rep["chips"] == 256
    assert rep["compile_s"] is None and rep["hlo_bytes_raw"] is None
    assert rep["bytes_per_device"]["arguments"] > 0
    assert rep["bytes_per_device"]["temp"] is None
    f = rep["flops_per_device"]
    assert rep["roofline"]["compute_s"] == f["total"] / 989.4e12
    assert rep["traced_flops_per_device"] > 0
    r = rep["traced_flops_per_device"] / \
        rep["flops_per_device_ticks_m"]["total"]
    if ratio:
        assert ratio[0] < r < ratio[1], r
    elif shape.startswith("prefill"):
        assert r > 1, r
    json.dumps(rep)


def test_cli_writes_reports_and_exits_1_on_a_failure(tmp_path):
    args = ["--arch", "xlstm-125m", "--shape", "long_500k", "--out",
            str(tmp_path)]
    dryrun.main(args)
    path = tmp_path / "xlstm-125m_long_500k_16x16.json"
    rep = json.loads(path.read_text())
    assert rep["arch"] == "xlstm-125m" and rep["dominant"] == "memory_s"
    dryrun.main(args)                   # cached: skipped, exit 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                     "--set", "pipeline_stages=3", "--tag", "bad",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
