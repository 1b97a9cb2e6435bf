"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]. 56 query heads over 8 KV heads:
a group of 7."""
from repro_torch.common.types import ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True, dense_d_ff=4864))

REDUCED = replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=256,
                  dense_residual=True, dense_d_ff=256))
