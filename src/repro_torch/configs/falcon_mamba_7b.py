"""falcon-mamba-7b [ssm]: attention-free Mamba1 [arXiv:2410.05355;
unverified]. No KV cache exists, so the paged-KV side of IBEX is idle:
the serving engines park the raw recurrent state (``models/ssm.py``)."""
from repro_torch.common.types import ModelConfig, SSMConfig, replace

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=65024, attn_kind="none",
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, chunk=128))

REDUCED = replace(
    CONFIG, num_layers=2, d_model=128, vocab_size=512,
    ssm=SSMConfig(kind="mamba1", d_state=8, d_conv=4, expand=2, chunk=32))
