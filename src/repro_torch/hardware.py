"""Peak rates of one NVIDIA H100 SXM, read by ``launch/roofline.py`` and
``chip_smoke.py``: compute and HBM from NVIDIA's data sheet (dense
rates without sparsity, at its 700 W power limit), NVLink as the card
reports it. A card set below 700 W runs slower under load; measurements
print the card's limit beside them.
"""
BF16_FLOPS_PER_S = 989.4e12    # H100 SXM, bf16 / fp16 tensor cores, dense
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, HBM3
# H100 SXM NVLink 4, each way per GPU: 18 links of 26.562 GB/s, as
# `nvidia-smi nvlink --status` reports them on the card (the data sheet
# gives 900 GB/s both ways together, 450 each way). Links between nodes
# (InfiniBand) are not modelled.
NVLINK_BYTES_PER_S = 18 * 26.562e9
