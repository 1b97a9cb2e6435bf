"""minicpm3-4b [dense]: multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B; hf]. The latent KV cache is itself a learned KV
compression; IBEX block-compresses the latents."""
from repro_torch.common.types import MLAConfig, ModelConfig, replace

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73728,  # 73448 (+280 pad to a multiple of 256 for TP)
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64))

REDUCED = replace(
    CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16))
