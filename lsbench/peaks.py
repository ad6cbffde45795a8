"""Peaks of one NVIDIA H100 SXM, the work a frame's kernels need, and the
operations of a training step.

Compute and HBM from NVIDIA's data sheet (dense rates, at its 700 W
power limit); a card set below 700 W runs slower under load, so a run
reports the card's power limit beside its shares. The operation counts
are the program's own accounting of the blend and the preprocess
(``chip_smoke.py``), kept here so that a change to the program cannot
move them.
"""
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3

# Floating-point operations the blend needs per (pixel, real lane) reached
# while the pixel is not yet done: offsets 2, power 9, exp 1, alpha 3,
# stop test 1.
EVAL_FLOPS = 16
# ... and, on top, per (pixel, lane) with a nonzero weight: transmittance
# 5, weight 1, colour 6, depth 2, weight sum 1, truncated depth 1, min 1.
BLEND_FLOPS = 17
# Per Gaussian in the preprocess kernel (transform 18, quaternion and
# scales 40, covariances 50, Jacobian and 2D covariance 50, conic, eigen
# and radii 40).
PREPROCESS_FLOPS = 200


def blend_bytes(pairs: int, tiles: int, lanes: int) -> int:
    """Each binned pair's 10 floats read once; per tile its origin,
    count and flag, 256 pixels of 6 outputs, and ``lanes`` contributions
    written."""
    return 4 * (pairs * 10 + tiles * (4 + 1 + 256 * 6 + lanes))


def preprocess_bytes(n: int) -> int:
    """44 bytes read and 73 written per Gaussian, and the pose."""
    return n * (44 + 73) + 64


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)

# Dense tensor-core rates of the same card (data sheet, 700 W).
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12


def lm_matmul_params(arch: dict) -> int:
    """Weights one token is multiplied by in a forward pass of a decoder
    whose layers all hold attention (grouped-query, or latent with or
    without a query LoRA) and one MLP (dense, or ``experts_per_token``
    routed and ``num_shared_experts`` shared experts of width ``d_ff`` and
    the router), with the output head; the embedding lookup multiplies
    nothing. ``arch`` holds the port's ``ArchConfig`` fields."""
    d, h = arch["d_model"], arch["num_heads"]
    if arch["attention"] == "mla":
        qk = arch["nope_head_dim"] + arch["rope_head_dim"]
        lora = arch["q_lora_rank"]
        attn = (d * lora + lora * h * qk if lora else d * h * qk) \
            + d * (arch["kv_lora_rank"] + arch["rope_head_dim"]) \
            + arch["kv_lora_rank"] * h * (arch["nope_head_dim"]
                                          + arch["v_head_dim"]) \
            + h * arch["v_head_dim"] * d
    else:
        k = arch["head_dim"] or d // h
        attn = d * k * (h + 2 * arch["num_kv_heads"]) + h * k * d
    mult = 3 if arch["mlp_type"] == "swiglu" else 2
    if arch["family"] == "moe":
        mlp = (arch["experts_per_token"] + arch["num_shared_experts"]) \
            * mult * d * arch["d_ff"] + d * arch["num_experts"]
    else:
        mlp = mult * d * arch["d_ff"]
    return arch["num_layers"] * (attn + mlp) + d * arch["vocab_size"]


def lm_train_flops(arch: dict, sequences: int, seq_len: int) -> float:
    """Floating-point operations of one training step of ``sequences`` rows
    of ``seq_len`` tokens: 6 per weight a token multiplies by, and each
    layer's causal attention products (2 operations per multiply-add of
    the scores over d_qk and of the values over d_v, for the S(S+1)/2
    pairs a row attends), three times over for the forward and the
    backward. Recomputation is not counted."""
    if arch["attention"] == "mla":
        qk = arch["nope_head_dim"] + arch["rope_head_dim"]
        v = arch["v_head_dim"]
    else:
        qk = v = arch["head_dim"] or arch["d_model"] // arch["num_heads"]
    tokens = sequences * seq_len
    pairs = sequences * seq_len * (seq_len + 1) / 2
    attn = 2.0 * arch["num_heads"] * pairs * (qk + v) * arch["num_layers"]
    return 6.0 * lm_matmul_params(arch) * tokens + 3.0 * attn
