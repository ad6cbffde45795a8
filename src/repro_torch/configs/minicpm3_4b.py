"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA dims follow the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attention="mla", q_lora_rank=768, kv_lora_rank=256,
    rope_head_dim=32, nope_head_dim=64, v_head_dim=64,
    notes="MLA latent cache: decode stores (kv_lora+rope)=288/token vs "
          "GQA 40*64*2=5120 — 17.8x smaller KV cache.",
)
