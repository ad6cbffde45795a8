"""StarCoder2-7B — GQA + RoPE, plain GELU MLP (no GLU).
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, mlp_type="gelu", rope_theta=1e5,
)
