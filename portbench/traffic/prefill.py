"""Traffic kind ``prefill``: the pipeline engine's forward pass over a
batch of prompts (``make_prefill_step``: last-position logits), in a
closed loop, a fresh prompt batch a call.

The mix gives the batch, prompt length, microbatches, the warm-up calls,
the size of the pool of prompts drawn from the seed, how many of the
window's first calls are kept for the check, how many of those the
check samples, and how many calls are traced.

The check: once the window has closed, a sample drawn from the seed of
the kept calls is recomputed by the plain reference from the same
weights and prompts. Compared: ``logits_rel_l2``, the worst row's
relative L2 distance of the program's last-position logits from the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import flops, weights
from portbench.reference import Reference
from portbench.synthetic import SyntheticLM

RATE = "prefill_tokens_per_s"
FAULTS = (None, "half_batch", "alter_answer")


def flops_per_unit(c, mix) -> float:
    return flops.prefill_flops(c, mix["batch"], mix["seq_len"])


def attention_launch(c, mix):
    return (mix["batch"] // mix["microbatches"], c["num_heads"],
            c["num_kv_heads"], mix["seq_len"], c["head_dim"], 2)


def draw_pool(c, mix, seed):
    lm = SyntheticLM(vocab_size=c["vocab_size"], seed=weights.subseed(seed, 1))
    rng = np.random.default_rng(weights.subseed(seed, 2))
    P, B, S = mix["pool"], mix["batch"], mix["seq_len"]
    tokens, _ = lm.sample(rng, P * B, S)
    return tokens.reshape(P, B, S)


def worst_row(got, want) -> float:
    """The worst row's relative L2 distance of logits ``got`` ([rows, 1,
    padded vocab]; a row left out counts as zeros) from ``want`` ([B,
    vocab])."""
    V = want.shape[-1]
    got = got.reshape(-1, got.shape[-1])[:, :V].float()
    got = torch.cat([got, got.new_zeros((want.shape[0] - got.shape[0], V))])
    rel = (torch.linalg.vector_norm((got - want).double(), dim=-1)
           / torch.linalg.vector_norm(want.double(), dim=-1))
    return float(rel.max())


def control_readings(cell, seed, device, detail: bool = False) -> dict:
    """The control (the reference in lower precision) against the f32
    reference on the first ``checked_calls`` prompts of the pool."""
    c, mix, dev = cell.config, cell.mix, torch.device(device)
    pool = draw_pool(c, mix, seed)
    params = weights.draw(c, seed, dev)
    worst = 0.0
    for i in range(mix["checked_calls"]):
        tokens = torch.as_tensor(pool[i], device=dev)
        want = Reference(c).last_logits(params, tokens, mix["microbatches"])
        got = Reference(c, "control").last_logits(params, tokens,
                                                  mix["microbatches"])
        worst = max(worst, worst_row(got, want))
    return {"logits_rel_l2": worst}


class Driver:
    def __init__(self, run):
        self.run, self.c, self.mix = run, run.cell.config, run.cell.mix
        self.tokens_per_unit = self.mix["batch"] * self.mix["seq_len"]
        self.first_unit = self.mix["warm_calls"]
        self.traced_units = self.mix["traced_calls"]
        self.kept = {}
        if run.fault not in FAULTS:
            raise ValueError(f"prefill cells have no fault {run.fault!r}")

    def setup(self):
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.pipeline.pipeline_step import make_prefill_step
        from portbench.harness import check_layout

        run, mix, c = self.run, self.mix, self.c
        cfg = run.cfg
        mesh = make_debug_mesh(1, cfg.pipeline_stages, cfg.tensor_parallel,
                               device=run.device)
        self.prefill = make_prefill_step(
            mesh, cfg, num_microbatches=mix["microbatches"])
        self.host_pool = draw_pool(c, mix, run.seed)
        self.pool = torch.as_tensor(self.host_pool, device=run.device)
        self.params = weights.draw(c, run.seed, run.device)
        check_layout(cfg, self.params)
        first = self.first_unit
        self.keep = range(first, first + mix["kept_calls"])
        for i in range(first):
            self.call(i)

    def call(self, i: int):
        tokens = self.pool[i % len(self.pool)]
        with torch.no_grad():
            if self.run.fault == "half_batch":
                tokens = tokens[:self.mix["batch"] // 2]
            out = self.prefill(self.params, {"tokens": tokens})
        if i in self.keep:
            if self.run.fault == "alter_answer":
                out = out.clone()
                out[0] = out[1]
            self.kept[i] = out
        return out

    def free(self):
        del self.params, self.prefill, self.pool

    def readings(self):
        """The check's numbers against the reference (no limit applied)."""
        run, mix, c = self.run, self.mix, self.c
        rng = np.random.default_rng(weights.subseed(run.seed, 3))
        due = sorted(self.kept)
        if not due:
            return {"logits_rel_l2": float("inf")}
        pick = rng.choice(len(due), size=min(mix["checked_calls"], len(due)),
                          replace=False)
        ref = Reference(c)
        params = weights.draw(c, run.seed, run.device)
        worst = 0.0
        for j in sorted(pick):
            i = due[j]
            tokens = torch.as_tensor(self.host_pool[i % len(self.host_pool)],
                                     device=run.device)
            want = ref.last_logits(params, tokens, mix["microbatches"])
            worst = max(worst, worst_row(self.kept[i], want))
        return {"logits_rel_l2": worst}
