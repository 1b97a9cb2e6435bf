"""zamba2-2.7b [hybrid]: a Mamba2 backbone with shared attention blocks
applied every 6 layers, alternating between 2 shared weight sets
[arXiv:2411.15242; hf]. Its serving cache holds both kinds of state: a
compressed KV cache for the 9 attention sites and the raw recurrent state
of the 54 Mamba2 layers (``models/decode.py``)."""
from repro_torch.common.types import ModelConfig, SSMConfig, replace

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    attn_period=6, attn_shared_blocks=2,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, headdim=64,
                  ngroups=1, chunk=128))

REDUCED = replace(
    CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, attn_period=2, attn_shared_blocks=2,
    ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2, headdim=32,
                  ngroups=1, chunk=32))
