"""Model FLOPs and kernel work from a configuration's shapes.

The arithmetic the yardstick rests on, kept with the benchmark so that
no later change to the program can move it. The 6 N D and 2 N D rule and
the parameter counts of a transformer layer are frozen from
``model_flops`` / ``_block_params`` / ``_moe_active_params`` of
``src/repro_torch/launch/analysis.py`` at commit 050b402, with three
changes the benchmark's cells need:

- N counts the weights of the matrix products only: each layer's
  attention projections, its dense MLP or, for a mixture-of-experts
  layer, the router and the ``moe_top_k`` experts a token is sent to,
  and the head. The embedding is a lookup and is left out.
- Causal attention's two products (scores and the weighted sum) are
  added: 2 products x 2 FLOPs x head_dim x heads per kept (query, key)
  pair, S (S + 1) / 2 pairs a sequence.
- A prefill call applies the head at each sequence's last position
  only (``make_prefill_step`` returns the last position's logits), so
  its head FLOPs are counted for those positions alone.

Training counts forward and backward (x 3); recomputation is not
counted. Shapes are read from the configuration's own keys.
"""
from __future__ import annotations


def attn_weights(c) -> int:
    d, H, K, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], \
        c["head_dim"]
    return d * (H + 2 * K) * hd + H * hd * d


def layer_weights(c) -> int:
    """Weights of one layer's products that one token goes through."""
    d, ff = c["d_model"], c["d_ff"]
    if c.get("num_experts"):
        return (attn_weights(c) + d * c["num_experts"]
                + c["moe_top_k"] * 3 * d * ff)
    return attn_weights(c) + 3 * d * ff


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def attn_product_flops(c, seq: int) -> int:
    """Forward FLOPs of one layer's two attention products over one
    causal sequence."""
    return 2 * 2 * c["head_dim"] * c["num_heads"] * causal_pairs(seq)


def train_flops(c, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` sequences."""
    L, tokens = c["num_layers"], batch * seq
    n = L * layer_weights(c) + c["d_model"] * c["vocab_size"]
    return 6.0 * n * tokens + 3.0 * L * batch * attn_product_flops(c, seq)


def prefill_flops(c, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill call: every layer over every position,
    the head at the last position of each sequence."""
    L, tokens = c["num_layers"], batch * seq
    return (2.0 * L * layer_weights(c) * tokens
            + 2.0 * c["d_model"] * c["vocab_size"] * batch
            + L * batch * attn_product_flops(c, seq))


def attention_kernel_work(rows: int, heads: int, kv_heads: int, seq: int,
                          head_dim: int, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal flash-attention launch over ``rows``
    sequences of ``seq`` positions: 4 head_dim FLOPs a kept (query, key)
    pair and head; q and o read or written once ([rows, heads, seq,
    head_dim]), k and v read once ([rows, kv_heads, seq, head_dim])."""
    flops = 4 * head_dim * heads * rows * causal_pairs(seq)
    nbytes = itemsize * rows * seq * head_dim * 2 * (heads + kv_heads)
    return flops, nbytes
