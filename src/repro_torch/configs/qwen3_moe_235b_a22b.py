"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
64 query heads over 4 KV heads: a group of 16 a KV head."""
from repro_torch.common.types import ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536),
    rope_theta=1000000.0)

REDUCED = replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=256))
