"""Moonlight-16B-A3B (kimi/moonshot) — fine-grained MoE, 64 experts top-6
+ 2 shared experts (DeepSeek-V3-style). [hf:moonshotai/Moonlight-16B-A3B; hf]
d_ff=1408 is the per-expert intermediate size."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    moe_decode_capacity_factor=4.0,  # capped decode buffer (EXPERIMENTS.md §Perf cell B)
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    notes="MoE dispatch uses the LDU-style capacity cap (DESIGN.md §4).",
)
