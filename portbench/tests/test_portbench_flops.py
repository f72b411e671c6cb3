"""The FLOP and byte arithmetic against hand counts at small shapes."""
from portbench import flops

DENSE = {"num_layers": 2, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "d_ff": 3, "vocab_size": 5}
MOE = dict(DENSE, num_experts=4, moe_top_k=2)


def test_layer_weights_by_hand():
    # q 4x4, k 4x2, v 4x2, o 4x4 = 16 + 8 + 8 + 16 = 48; MLP 3 x 4 x 3 = 36
    assert flops.attn_weights(DENSE) == 48
    assert flops.layer_weights(DENSE) == 84
    # router 4 x 4 = 16; two experts of 3 x 4 x 3
    assert flops.layer_weights(MOE) == 48 + 16 + 2 * 36


def test_attention_products_by_hand():
    # S = 3: 6 kept pairs; 2 products x 2 FLOPs x head_dim 2 x 2 heads
    assert flops.causal_pairs(3) == 6
    assert flops.attn_product_flops(DENSE, 3) == 2 * 2 * 2 * 2 * 6


def test_train_and_prefill_by_hand():
    B, S = 2, 3
    n = 2 * 84 + 4 * 5                      # layers + head
    attn = 2 * 2 * 2 * 2 * 6               # a layer, a sequence
    assert flops.train_flops(DENSE, B, S) == 6 * n * B * S + 3 * 2 * B * attn
    # prefill: the head at the last position of each sequence only
    assert flops.prefill_flops(DENSE, B, S) == (
        2 * 2 * 84 * B * S + 2 * 4 * 5 * B + 2 * B * attn)


def test_attention_kernel_work_by_hand():
    f, b = flops.attention_kernel_work(rows=1, heads=2, kv_heads=1, seq=3,
                                       head_dim=2, itemsize=2)
    assert f == 4 * 2 * 2 * 6
    # q and o: 1 x 2 x 3 x 2 each; k and v: 1 x 1 x 3 x 2 each; 2 bytes
    assert b == 2 * (12 + 12 + 6 + 6)
