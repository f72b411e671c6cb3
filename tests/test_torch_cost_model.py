"""The port's cost model and roofline arithmetic
(``repro_torch.launch.{analysis,cost_model}``) against the JAX package's,
and the port's FLOP count of a step (``repro_torch.compat.cost_analysis``)
against the analytic one.

The arithmetic is a copy, so every figure is held EQUAL to the JAX
package's for every architecture x input shape x mesh; only the
hardware constants differ (an H100's for a TPU v5e's), and the roofline
terms are held equal to the same dicts over the H100 constants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import analysis as JA  # noqa: E402
from repro.launch import cost_model as JCM  # noqa: E402
from repro_torch import compat, tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import analysis as A  # noqa: E402
from repro_torch.launch import cost_model as CM  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline.pipeline_step import make_loss_fn  # noqa: E402


def test_h100_constants():
    """The data-sheet peaks of an H100 SXM5 80 GB at 700 W, and the
    roofline terms read them."""
    assert (A.PEAK_FLOPS, A.PEAK_FLOPS_TF32, A.PEAK_FLOPS_F32) == (
        989.4e12, 494.7e12, 66.9e12)
    assert (A.HBM_BW, A.NVLINK_BW) == (3.35e12, 450e9)
    t = A.roofline_terms(989.4e12 * 2, 3.35e12 * 3, 450e9 * 5, chips=1)
    assert t == pytest.approx({"compute_s": 2.0, "memory_s": 3.0,
                               "collective_s": 5.0})
    assert A.dominant(t) == "collective_s"
    assert A.roofline_terms(2, 3, 4, chips=2) == pytest.approx(
        {k: v / 2 for k, v in A.roofline_terms(2, 3, 4, chips=1).items()})


def test_shapes_are_the_jax_packages():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (
            j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert A.param_count_total(cfg) == JA.param_count_total(jcfg)
    assert A.param_count_active(cfg) == JA.param_count_active(jcfg)
    for name in SHAPES:
        for active in (True, False):
            assert A.model_flops(cfg, get_shape(name), active) == \
                JA.model_flops(jcfg, JSHAPES[name], active)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_model_equal_for_every_shape_and_mesh(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in SHAPES:
        for multi_pod in (False, True):
            co = CM.Combo(cfg, get_shape(name), multi_pod=multi_pod)
            jco = JCM.Combo(jcfg, JSHAPES[name], multi_pod=multi_pod)
            for f in ("S", "Tp", "D", "data_sharded", "B_loc", "chunked",
                      "M", "mb", "ticks", "seq", "chunk_len", "W"):
                assert getattr(co, f) == getattr(jco, f), (name, f)
            f = CM.flops_per_device(co)
            cb = CM.collective_bytes_per_device(co)
            hb = CM.hbm_bytes_per_device(co)
            assert f == JCM.flops_per_device(jco)
            assert cb == JCM.collective_bytes_per_device(jco)
            assert hb == JCM.hbm_bytes_per_device(jco)
            r = CM.roofline(co)
            assert (r["flops"], r["collective_bytes"], r["hbm_bytes"]) == (
                f, cb, hb)
            assert r["terms"] == {"compute_s": f["total"] / 989.4e12,
                                  "memory_s": hb["total"] / 3.35e12,
                                  "collective_s": cb["total"] / 450e9}
            assert r["dominant"] == max(r["terms"], key=r["terms"].get)


class TestCostModelProperties:
    """``tests/test_perf_features.py::TestCostModelProperties`` on the
    port's cost model."""

    def _combo(self, **over):
        cfg = get_config("llama3-8b")
        cfg = cfg.with_overrides(**over) if over else cfg
        return CM.Combo(cfg, get_shape("prefill_32k"))

    def test_more_chunks_lower_compute(self):
        bounds = [CM.roofline(self._combo(prefill_seq_chunks=c))
                  ["terms"]["compute_s"] for c in (0, 8, 16, 32)]
        assert bounds[1] < bounds[0]
        assert bounds[2] < bounds[1] and bounds[3] < bounds[2]

    def test_flash_removes_score_traffic(self):
        base = CM.hbm_bytes_per_device(self._combo())
        flash = CM.hbm_bytes_per_device(self._combo(use_flash_attention=1))
        assert base["scores"] > 0 and flash["scores"] == 0
        assert flash["total"] < base["total"]

    def test_decode_is_weights_bound(self):
        co = CM.Combo(get_config("llama3-8b"), get_shape("decode_32k"))
        hb = CM.hbm_bytes_per_device(co)
        assert hb["weights"] > hb["activations"]


def test_analytic_matches_traced_loss_and_grad():
    """The port of ``tests/test_substrates.py::TestCostModel::
    test_analytic_matches_unrolled_hlo``: the FLOPs ``compat.cost_analysis``
    counts for the reduced qwen2 loss-and-grad on the CPU, per device of
    the (2, 2, 2) mesh, within 35% of the analytic count. The port's
    engine runs no invalid tick, so the analytic count takes ticks = M
    (the JAX test's M + S - 1 = 5 becomes 4); it folds the mesh onto one
    device, so the count over all 8 devices is divided by 8."""
    cfg = get_config("qwen2-1.5b").reduced(
        pipeline_stages=2, tensor_parallel=2, num_layers=4, d_model=256,
        d_ff=512, vocab_size=1024, num_heads=4, num_kv_heads=2,
        dtype="bfloat16")
    mesh = make_debug_mesh(2, 2, 2, device="cpu")
    params = M.init_params(0, cfg, device="cpu")
    B, T = 8, 128
    toks = torch.zeros((B, T), dtype=torch.int32)
    loss_fn = make_loss_fn(mesh, cfg, num_microbatches=4, remat=False)
    leaves, paths = tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]

    def loss_and_grad():
        ps = tree.unflatten(paths, leaves)
        loss, _ = loss_fn(ps, {"tokens": toks, "labels": toks})
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    counted = compat.cost_analysis(loss_and_grad)
    assert counted["flops_kernels"] == {"flash_attention": 0.0,
                                        "ssd_scan": 0.0}
    per_device = counted["flops"] / 8
    combo = CM.Combo(cfg, InputShape("t", T, B, "train"))
    combo.D, combo.B_loc, combo.M, combo.mb = 2, 4, 4, 1
    combo.S, combo.Tp, combo.ticks = 2, 2, 4
    combo.data_sharded = True
    f = CM.flops_per_device(combo)
    analytic = f["blocks"] * 3 / 4 + f["head"]   # remat off: 3x not 4x
    assert abs(analytic - per_device) / per_device < 0.35


def test_cost_analysis_counts_a_matmul_and_returns_the_parts():
    a = torch.from_numpy(np.ones((4, 8), np.float32))
    b = torch.from_numpy(np.ones((8, 16), np.float32))
    got = compat.cost_analysis(torch.matmul, a, b)
    assert got == {"flops": 2.0 * 4 * 8 * 16, "flops_aten": 2.0 * 4 * 8 * 16,
                   "flops_kernels": {"flash_attention": 0.0,
                                     "ssd_scan": 0.0}}
