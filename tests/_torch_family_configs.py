"""The four model families that no registered config reaches (ssm,
hybrid, encdec, vlm), as plain dicts of ``ArchConfig`` fields.

Copied from the reference's own configs before they left its registry:
``git show 930e629^:src/repro/configs/{mamba2_780m,zamba2_7b,
whisper_large_v3,internvl2_2b}.py``. Tests build the reference's and the
port's ``ArchConfig`` from the same dict (``ArchConfig(**FAMILY_CONFIGS[
name])``), and ``chip_smoke.py`` builds the port's from it. Neither
package registers them. This module imports neither package.
"""

FAMILY_CONFIGS = {
    # Mamba2-780m: attention-free SSD [arXiv:2405.21060]. 48 layers,
    # d_model 1536, state 128, expand 2 (d_inner 3072), head_dim 64.
    "mamba2-780m": dict(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280, attention="none",
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, tie_embeddings=True),
    # Zamba2-7B: 81 Mamba2 layers (d 3584, state 64) with one shared
    # attention + MLP block (32 heads GQA, 14336 MLP) after every 6
    # [arXiv:2411.15242].
    "zamba2-7b": dict(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        shared_attn_every=6, shared_attn_d_ff=14336),
    # Whisper-large-v3 backbone: encoder-decoder; the conv/mel frontend is
    # a stub supplying (B, 1500, d_model) frame embeddings
    # [arXiv:2212.04356].
    "whisper-large-v3": dict(
        name="whisper-large-v3", family="encdec",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866, mlp_type="gelu",
        encoder_layers=32, encoder_seq=1500),
    # InternVL2-2B backbone: InternLM2-1.8B with a (B, 256, d_model)
    # patch-embedding prefix through a learned projection; the InternViT
    # frontend is a stub [arXiv:2404.16821].
    "internvl2-2b": dict(
        name="internvl2-2b", family="vlm",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        d_ff=8192, vocab_size=92553,
        num_vision_tokens=256),
}
