"""Traffic kind ``train``: the pipeline engine's training step in a closed
loop, a fresh batch a step.

The mix (``traffic/<mix>.json``) gives the batch, sequence length,
microbatches, recomputation, Adam's settings, the stash depth and the
blend period, how many first steps set-up runs, the size of the pool of
batches drawn from the seed, and how many steps are traced. One object,
the step of ``make_train_step`` on the folded mesh (1, stages, 1) with
its model and optimizer state, is built in set-up, driven through its
first steps by ``call`` (the window's own call and feed), and handed to
the window.

The check: the plain reference (``reference.py``) follows the first
steps from the same weights and batches. The numbers (``compare``; a
cell's ``cells/<cell>.json`` says which it holds to a limit), each by
the worst case:
- ``loss_gap``: each first step's loss against the reference's (nats);
- ``grad_gap``: the norm of each leaf's first gradient as Adam got it
  (its first moment after one step over 1 - b1) against the reference's
  norm of that leaf, over the larger of that norm and the median leaf's;
- ``change_gap``: the norm of each leaf's change from the initial
  weights after the first steps, in the params and in the stash that the
  next step takes, against the reference's, over the larger of that
  norm and the median leaf's; leaves whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone, such as a
  key's bias under softmax) are left out.
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gaps of
  the two above, for where the worst leaf swings by its nature (a
  router whose routes flip on near-ties);
- ``aux_gap`` (mixtures of experts): each first step's load-balance loss
  against the reference's.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench import flops, weights
from portbench.reference import Reference
from portbench.synthetic import SyntheticLM

RATE = "train_tokens_per_s"
B1 = 0.9                    # Adam's first-moment decay (the program's)


def flops_per_unit(c, mix) -> float:
    return flops.train_flops(c, mix["batch"], mix["seq_len"])


def attention_launch(c, mix):
    """(rows, heads, kv heads, seq, head dim, bytes an element) of each
    flash-attention launch: one microbatch of one layer, bf16."""
    return (mix["batch"] // mix["microbatches"], c["num_heads"],
            c["num_kv_heads"], mix["seq_len"], c["head_dim"], 2)


def draw_pool(c, mix, seed):
    """[pool, batch, seq] int32 tokens and labels from the seed."""
    lm = SyntheticLM(vocab_size=c["vocab_size"], seed=weights.subseed(seed, 1))
    rng = np.random.default_rng(weights.subseed(seed, 2))
    P, B, S = mix["pool"], mix["batch"], mix["seq_len"]
    tokens, labels = lm.sample(rng, P * B, S)
    return tokens.reshape(P, B, S), labels.reshape(P, B, S)


def leaf_norms(tree):
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for _, t in weights.flatten(tree)])


def diff_norms(a, b):
    """Each leaf's norm of ``a - b``, one leaf at a time."""
    return torch.stack([torch.linalg.vector_norm((x - y).float())
                        for (_, x), (_, y) in zip(weights.flatten(a),
                                                  weights.flatten(b))])


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's |prog - ref| / max(ref, median ref)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    den = torch.clamp(ref, min=float(ref.median()))
    return (prog - ref).abs() / den


def worst_gap(prog, ref, keep=None):
    """Worst leaf of |prog - ref| / max(ref, median ref)."""
    return float(leaf_gaps(prog, ref, keep).max())


class Driver:
    def __init__(self, run):
        self.run, self.c, self.mix = run, run.cell.config, run.cell.mix
        self.config = self.c
        self.tokens_per_unit = self.mix["batch"] * self.mix["seq_len"]
        self.first_unit = self.mix["first_steps"]
        self.traced_units = self.mix["traced_steps"]

    def setup(self):
        from repro_torch.configs import TrainConfig
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.pipeline.pipeline_step import make_train_step
        from portbench.harness import check_layout

        run, mix, c = self.run, self.mix, self.c
        cfg = run.cfg.with_overrides(stash_depth=mix["stash_depth"],
                                     aggregate_every=mix["aggregate_every"])
        tc = TrainConfig(learning_rate=mix["learning_rate"],
                         optimizer="adam", microbatches=mix["microbatches"],
                         remat=mix["remat"],
                         weight_decay=mix["weight_decay"])
        mesh = make_debug_mesh(1, cfg.pipeline_stages, cfg.tensor_parallel,
                               device=run.device)
        step, _ = make_train_step(mesh, cfg, tc)
        self.step = self._faulty(step)
        self.host_pool = draw_pool(c, mix, run.seed)
        self.pool = [torch.as_tensor(a, device=run.device)
                     for a in self.host_pool]
        w0 = weights.draw(c, run.seed, run.device)
        check_layout(cfg, w0)
        self.state = step.init_state(w0)
        self.losses, self.auxes = [], []
        for i in range(self.first_unit):
            m = self.call(i)
            self.losses.append(m["loss"])
            self.auxes.append(m["aux"])
            if i == 0:
                self.grad_norms = leaf_norms(
                    self.state["opt_state"]["m"]) / (1 - B1)
        self.change_norms = torch.cat([
            diff_norms(self.state["params"], w0),
            diff_norms(self.state["stash"], w0)])
        self.losses = [float(x) for x in self.losses]
        self.auxes = [float(x) for x in self.auxes]
        del w0

    def _faulty(self, step):
        fault = self.run.fault
        if fault is None:
            return step
        if fault == "unchanged":
            def unchanged(state, batch):
                _, m = step(state, batch)
                return state, m
            return unchanged
        if fault == "half_batch":
            def half(state, batch):
                h = self.mix["batch"] // 2
                return step(state, {k: v[:h] for k, v in batch.items()})
            return half
        raise ValueError(f"train cells have no fault {fault!r}")

    def call(self, i: int):
        tokens, labels = (a[i % len(a)] for a in self.pool)
        self.state, metrics = self.step(self.state, {"tokens": tokens,
                                                     "labels": labels})
        return metrics

    def free(self):
        del self.state, self.step, self.pool

    def readings(self, detail: bool = False):
        """The check's numbers against the reference (unlimited); with
        ``detail``, the leaves that read worst as well."""
        run, mix, c = self.run, self.mix, self.c
        n = self.first_unit
        batches = [(torch.as_tensor(self.host_pool[0][i], device=run.device),
                    torch.as_tensor(self.host_pool[1][i], device=run.device))
                   for i in range(n)]
        return compare(self, reference_run(c, mix, run.seed, run.device,
                                           batches), detail)


def reference_run(c, mix, seed, device, batches, precision="f32"):
    """The reference's first steps from the seed's weights."""
    return Reference(c, precision).train(
        weights.draw(c, seed, device), batches,
        microbatches=mix["microbatches"], lr=mix["learning_rate"],
        weight_decay=mix["weight_decay"], stash_depth=mix["stash_depth"],
        aggregate_every=mix["aggregate_every"])


def control_readings(cell, seed, device, detail: bool = False) -> dict:
    """The control (the reference in lower precision) against the f32
    reference, by the numbers of ``compare``."""
    c, mix, dev = cell.config, cell.mix, torch.device(device)
    host = draw_pool(c, mix, seed)
    batches = [(torch.as_tensor(host[0][i], device=dev),
                torch.as_tensor(host[1][i], device=dev))
               for i in range(mix["first_steps"])]
    low = reference_run(c, mix, seed, dev, batches, "control")
    control = types.SimpleNamespace(
        config=c, losses=low["loss"], auxes=low["aux"],
        grad_norms=low["grad_norms"], change_norms=low["change_norms"])
    del low
    return compare(control, reference_run(c, mix, seed, dev, batches),
                   detail)


def compare(prog, ref, detail: bool = False) -> dict:
    """The numbers of ``prog`` (an object with ``losses``, ``auxes``,
    ``grad_norms`` and ``change_norms``, as ``Driver`` keeps them) against
    a reference run ``ref`` (``Reference.train``). Besides the worst
    leaf's gaps, the median leaf's (``*_median``); with ``detail``, the
    five leaves whose first gradient reads worst, by path."""
    g_ref = ref["grad_norms"].cpu()
    moved = g_ref >= 1e-3 * g_ref.median()
    n = len(g_ref)
    change = ref["change_norms"]
    out = {"loss_gap": max(abs(a - b) for a, b in
                           zip(prog.losses, ref["loss"])),
           "grad_gap": worst_gap(prog.grad_norms, g_ref),
           "change_gap": max(
               worst_gap(prog.change_norms[:n], change[:n], moved),
               worst_gap(prog.change_norms[n:], change[n:], moved))}
    out["grad_gap_median"] = float(
        leaf_gaps(prog.grad_norms, g_ref).median())
    out["change_gap_median"] = float(torch.cat([
        leaf_gaps(prog.change_norms[:n], change[:n], moved),
        leaf_gaps(prog.change_norms[n:], change[n:], moved)]).median())
    if any(ref["aux"]):
        out["aux_gap"] = max(abs(a - b) for a, b in
                             zip(prog.auxes, ref["aux"]))
    if detail:
        gaps = leaf_gaps(prog.grad_norms, g_ref)
        paths = [".".join(map(str, p)) for p, _ in
                 weights._spec_items(weights.layout(prog.config))]
        top = torch.argsort(gaps, descending=True)[:5]
        out["grad_worst_leaves"] = [[paths[i], float(gaps[i])] for i in top]
    return out
