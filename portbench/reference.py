"""Plain PyTorch reference of the benchmark's language models and of the
pipeline engine's training step.

Written from the architecture and the step's definition, with plain
``torch`` operations in float32 (TF32 off), no kernel, no cache, no
pipeline: one sequence batch (a microbatch of the program's schedule) at
a time. It imports nothing of the program. It reads the weights in the
program's tree layout (``weights.py``), as a checkpoint reader would, and
takes nothing the program has made.

What it computes:
- a decoder-only LM: token embedding; per layer pre-RMSNorm causal GQA
  attention with RoPE (interleaved pairs of head dims, q/k/v biases where
  the config has them) and either a gated SiLU MLP or a mixture of
  experts; a final RMSNorm; the head; mean cross-entropy over every
  token of the step;
- the mixture of experts: an f32 router, softmax over experts, the
  top-k by a stable descending sort (ties to the lower index), weights
  renormalised over the k; each expert takes, in token-major route
  order, the first C routes sent to it (C = the capacity of a
  microbatch, ``capacity``) and drops the rest; the Switch load-balance
  loss E * sum_e mean_t p_te * f_e, f_e the share of routes to e, per
  layer and microbatch, added to the loss as
  ``router_aux_weight * sum / microbatches``;
- the training step of the FTPipeHD engine: gradients at the stashed
  weights (one step stale, stash depth 2), Adam (b1 0.9, b2 0.95, eps
  1e-8) on the newest, and at every ``aggregate_every``-th step each
  stage but the last blended half and half with its stash.

``precision="control"`` computes every product that the program runs in
bfloat16 with float8 operands (e4m3 forward, e5m2 gradients, a scale a
tensor) and every product it runs in float32 (router, head) with TF32
operands: the lower precision a later change might be tempted by. The
harness never runs it; its tests and the calibration do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.weights import flatten, unflatten


def _fp8(x, dtype):
    amax = x.detach().abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _exact:
    """Float32 products in float32: TF32 off for the duration."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


class _LowProduct(torch.autograd.Function):
    """a @ b on operands rounded to a lower precision; its gradient's
    operands are rounded too. Saves a and b as a plain product would and
    rounds them again in the backward."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ctx.save_for_backward(a, b)
        ctx.kind = kind
        return _round(a, kind) @ _round(b, kind)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qa, qb = _round(a, ctx.kind), _round(b, ctx.kind)
        gq = _round(g, ctx.kind, grad=True)
        return gq @ qb.mT, qa.mT @ gq, None


def _round(x, kind, grad=False):
    if kind == "bf16":
        return _fp8(x, torch.float8_e5m2 if grad else torch.float8_e4m3fn)
    return _tf32(x)


class Reference:
    """The reference model of one configuration (a dict of the config
    file's keys) at one precision: "f32" or "control"."""

    def __init__(self, c, precision: str = "f32"):
        if precision not in ("f32", "control"):
            raise ValueError(precision)
        self.c, self.precision = c, precision
        self.S = c["pipeline_stages"]
        self.lps = c["num_layers"] // self.S

    # -- products --------------------------------------------------------
    def mm(self, a, b, kind: str = "bf16"):
        """a [..., k] @ b [k, m] (or batched alike); ``kind``: the
        precision the program runs this product in."""
        if self.precision == "f32":
            return a @ b
        if b.dim() == 2:
            lead = a.shape[:-1]
            return _LowProduct.apply(a.reshape(-1, a.shape[-1]), b,
                                     kind).reshape(*lead, b.shape[-1])
        return _LowProduct.apply(a, b, kind)

    def rmsnorm(self, x, scale):
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["norm_eps"]) * scale

    def rope(self, x):
        """x [n, seq, heads, hd], positions 0 .. seq - 1."""
        hd, seq = x.shape[-1], x.shape[1]
        inv = 1.0 / (self.c["rope_theta"] ** (
            np.arange(0, hd, 2, dtype=np.float32) / hd))
        inv = torch.as_tensor(np.asarray(inv, np.float32), device=x.device)
        ang = torch.arange(seq, device=x.device, dtype=torch.float32)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    # -- layers ----------------------------------------------------------
    def attention(self, p, x):
        c = self.c
        n, seq, _ = x.shape
        H, K, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]

        def proj(name, heads):
            y = self.mm(x, p[name]["w"])
            if "b" in p[name]:
                y = y + p[name]["b"]
            return y.reshape(n, seq, heads, hd)

        q = self.rope(proj("wq", H))
        k = self.rope(proj("wk", K)).repeat_interleave(H // K, dim=2)
        v = proj("wv", K).repeat_interleave(H // K, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # [n, H, seq, hd]
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(seq, seq, dtype=torch.bool,
                            device=x.device).tril()
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = self.mm(w, v).transpose(1, 2).reshape(n, seq, H * hd)
        return self.mm(out, p["wo"]["w"])

    def mlp(self, p, h):
        gate = F.silu(self.mm(h, p["w_gate"]["w"]))
        return self.mm(gate * self.mm(h, p["w_up"]["w"]), p["w_down"]["w"])

    def capacity(self, tokens: int) -> int:
        c = self.c
        cap = int(tokens * c["moe_top_k"] / c["num_experts"]
                  * c["capacity_factor"])
        return max(8, -(-cap // 8) * 8)

    def moe(self, p, h):
        """h [n, seq, d] -> (out [n, seq, d], load-balance loss)."""
        c = self.c
        E, k = c["num_experts"], c["moe_top_k"]
        shape = h.shape
        h = h.reshape(-1, shape[-1])
        T = h.shape[0]
        probs = torch.softmax(self.mm(h, p["router"]["w"], "f32"), dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_e = top_w[:, :k], top_e[:, :k]
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        share = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * k)
        aux = E * (probs.mean(dim=0) * share).sum()
        C = self.capacity(T)
        flat_e, flat_w = top_e.reshape(-1), top_w.reshape(-1)
        out = torch.zeros_like(h)
        for e in range(E):
            routes = (flat_e == e).nonzero()[:, 0][:C]     # token-major order
            if routes.numel() == 0:
                continue
            tok = routes // k
            xe = h[tok]
            ye = self.mm(F.silu(self.mm(xe, p["w1"][e]))
                         * self.mm(xe, p["w3"][e]), p["w2"][e])
            out = out.index_add(0, tok, ye * flat_w[routes][:, None])
        return out.reshape(shape), aux

    def layer_params(self, params, layer: int):
        s, j = divmod(layer, self.lps)
        return _at(params["blocks"][j], s)

    def trunk(self, params, tokens):
        """tokens [n, seq] -> (final hidden states [n, seq, d], the sum of
        the layers' load-balance losses)."""
        x = params["embed"]["table"][tokens.long()]
        aux = x.new_zeros(())
        for layer in range(self.c["num_layers"]):
            p = self.layer_params(params, layer)
            x = x + self.attention(p["attn"], self.rmsnorm(x, p["ln1"]["scale"]))
            h = self.rmsnorm(x, p["ln2"]["scale"])
            if "moe" in p:
                y, a = self.moe(p["moe"], h)
                aux = aux + a
            else:
                y = self.mlp(p["mlp"], h)
            x = x + y
        return self.rmsnorm(x, params["final_norm"]["scale"]), aux

    def logits(self, params, y):
        out = self.mm(y, params["head"]["w"], "f32")
        V = self.c["vocab_size"]
        if out.shape[-1] > V:
            out = out.masked_fill(
                torch.arange(out.shape[-1], device=out.device) >= V,
                float("-inf"))
        return out

    # -- the step --------------------------------------------------------
    def loss_and_grads(self, params, tokens, labels, microbatches: int):
        """(mean loss, load-balance sum / microbatches, gradient tree) over
        the batch, one microbatch of rows at a time, as the engine splits
        it."""
        items = flatten(params)
        live = [leaf.detach().requires_grad_(True) for _, leaf in items]
        tree = unflatten([(p, t) for (p, _), t in zip(items, live)])
        grads = [torch.zeros_like(t) for t in live]
        B, seq = tokens.shape
        rows = B // microbatches
        loss = aux_total = 0.0
        for m in range(microbatches):
            sl = slice(m * rows, (m + 1) * rows)
            with torch.enable_grad():
                y, aux = self.trunk(tree, tokens[sl])
                lg = self.logits(tree, y)
                nll = torch.logsumexp(lg, dim=-1) - lg.gather(
                    -1, labels[sl].long()[..., None])[..., 0]
                part = nll.sum() / (B * seq)
                a = aux / microbatches
                obj = part + self.c.get("router_aux_weight", 0.0) * a
                gs = torch.autograd.grad(obj, live, allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc += g
            loss += float(part.detach())
            aux_total += float(a.detach())
            del y, aux, lg, nll, part, obj, gs
        return loss, aux_total, unflatten(
            [(p, g) for (p, _), g in zip(items, grads)])

    def last_logits(self, params, tokens, microbatches: int):
        """Last-position logits [B, V] of a prefill over ``tokens``."""
        B = tokens.shape[0]
        rows = B // microbatches
        outs = []
        with torch.no_grad(), _exact():
            for m in range(microbatches):
                y, _ = self.trunk(params, tokens[m * rows:(m + 1) * rows])
                outs.append(self.logits(params, y[:, -1]))
        return torch.cat(outs)

    def train(self, params, batches, *, microbatches: int, lr: float,
              weight_decay: float, stash_depth: int, aggregate_every: int):
        """The engine's training step from ``params``, once a batch of
        ``batches`` [(tokens, labels)]. Returns a dict: ``loss`` and
        ``aux`` a step; ``grad_norms``, each leaf's first gradient's norm;
        ``change_norms``, each leaf's distance from ``params`` in the
        params and then in the stash that the next step would take.
        Leaves in ``weights.flatten``'s order."""
        with _exact():
            return self._train(params, batches, microbatches=microbatches,
                               lr=lr, weight_decay=weight_decay,
                               stash_depth=stash_depth,
                               aggregate_every=aggregate_every)

    def _train(self, params, batches, *, microbatches, lr, weight_decay,
               stash_depth, aggregate_every):
        b1, b2, eps = 0.9, 0.95, 1e-8
        cur, stash = params, params
        m = v = None
        out = {"loss": [], "aux": []}
        for step, (tokens, labels) in enumerate(batches, start=1):
            loss, aux, g = self.loss_and_grads(stash, tokens, labels,
                                               microbatches)
            out["loss"].append(loss)
            out["aux"].append(aux)
            gi = [t for _, t in flatten(g)]
            del g
            if step == 1:
                out["grad_norms"] = _norms(gi)
                m = [torch.zeros_like(t) for t in gi]
                v = [torch.zeros_like(t) for t in gi]
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            new = []
            for i, (path, p) in enumerate(flatten(cur)):
                gr, gi[i] = gi[i], None
                m[i].mul_(b1).add_(gr, alpha=1 - b1)
                v[i].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                del gr
                upd = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps) \
                    + weight_decay * p
                new.append((path, p - lr * upd))
            new_tree = unflatten(new)
            del new
            if aggregate_every and step % aggregate_every == 0:
                new_tree["blocks"] = self.blend(new_tree["blocks"],
                                                stash["blocks"])
            stash = cur if stash_depth > 1 else new_tree
            cur = new_tree
        base = [t for _, t in flatten(params)]
        out["change_norms"] = torch.cat([
            _norms([t - b for (_, t), b in zip(flatten(tree), base)])
            for tree in (cur, stash)])
        return out

    def blend(self, new_blocks, stash_blocks):
        """Each stage but the last: half new, half stash; the last: new."""
        half = torch.full((self.S,), 0.5)
        half[-1] = 1.0

        def mix(n, s):
            a = half.to(n.device).reshape((self.S,) + (1,) * (n.dim() - 1))
            return a * n + (1 - a) * s

        return unflatten([(p, mix(n, s)) for (p, n), (_, s) in zip(
            flatten(new_blocks), flatten(stash_blocks))])


def _norms(leaves):
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in leaves])


def _at(tree, s):
    """The stage-``s`` slice of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _at(v, s) for k, v in tree.items()}
    return tree[s]
