"""The frozen counts against the program's roofline arithmetic as it stood
when they were frozen, at the cells' shapes: the peaks, a kernel's bound,
the decode step's matmul FLOPs, the parameter count, and B3's, B4's and
B5's bytes and operations against ``chip_smoke.py``'s kernel rows."""
from __future__ import annotations

import json
import re

import pytest

from tiny import REPO
from bench.counts import kernels as K
from bench.counts import model as CM
from bench.counts import peaks
from bench.harness import spec


def _cfg(name):
    return spec.model_config(json.loads(
        (REPO / "bench" / "configs" / f"{name}.json").read_text()))


def test_peaks_and_bound_equal_the_programs():
    from repro_torch.roofline import analyze as RA
    assert peaks.PEAK_FLOPS_BF16 == RA.PEAK_FLOPS
    assert peaks.PEAK_FLOPS_F32 == RA.PEAK_FLOPS_F32
    assert peaks.HBM_BYTES_PER_S == RA.HBM_BW
    for nb, ops, dt in ((1e9, 1e12, "bfloat16"), (1e6, 1e12, "float32"),
                        (3.3e9, 4e9, "float32")):
        ms, _ = RA.kernel_bound(nb, ops, dt)
        assert peaks.bound_s(nb, ops, dt) == pytest.approx(ms / 1e3,
                                                           rel=1e-12)


@pytest.mark.parametrize("name", ["deepseek-7b", "minicpm3-4b"])
def test_matmul_params_are_the_param_count_less_the_lookup(name):
    cfg = _cfg(name)
    assert CM.matmul_params(cfg) == \
        cfg.param_count() - cfg.vocab_size * cfg.d_model
    if name == "deepseek-7b":                 # 6.91e9 as published
        assert abs(cfg.param_count() - 6.91e9) < 0.01e9


@pytest.mark.parametrize("ctx", [1, 87, 1024, 2047])
def test_token_flops_equal_the_decode_steps_matmuls(ctx):
    """A GQA token's model FLOPs are ``count.decode_matmul_flops`` of one
    lane over ``ctx`` positions: the same products, the same attention."""
    from repro_torch.roofline import count
    cfg = _cfg("deepseek-7b")
    assert CM.token_flops(cfg, ctx - 1) == \
        count.decode_matmul_flops(cfg, 1, ctx)


def test_tokens_flops_closed_form_and_the_train_step():
    cfg = _cfg("deepseek-7b")
    assert CM.tokens_flops(cfg, 5, 40) == sum(CM.token_flops(cfg, t)
                                              for t in range(5, 40))
    from repro_torch.roofline import analyze as RA
    step = CM.train_step_flops(cfg, 4, 2048)
    six_n_d = RA.model_flops(CM.matmul_params(cfg), CM.matmul_params(cfg),
                             4 * 2048, "train")
    attn = 3 * 4 * 2 * cfg.num_layers * cfg.num_heads * \
        (2048 * 2049 // 2) * 2 * cfg.resolved_head_dim
    assert step == six_n_d + attn


def _smoke_rows():
    src = (REPO / "chip_smoke.py").read_text()
    gqa = re.search(r'out\["kvc_decode_attention"\] = dict\(.*?nbytes=(.*?),'
                    r'\s*ops=(.*?), reps', src, re.S)
    lat = re.search(r'out\["kvc_latent_partial"\] = dict\(.*?nbytes=(.*?),'
                    r'\s*ops=(.*?), reps', src, re.S)

    def flat(groups):                 # one expression a line
        return tuple(" ".join(g.split()) for g in groups)
    return flat(gqa.groups()), flat(lat.groups()), src


@pytest.mark.parametrize("lens", [[87, 672, 0, 300], [2047] * 64])
def test_b5_counts_equal_the_kernel_rows(lens):
    (gb, go), (lb, lo), _ = _smoke_rows()
    cfg = _cfg("deepseek-7b")
    B, Hq, Hkv, D, bits = len(lens), 32, 32, 128, 4
    env = dict(tok=sum(lens), B=B, Hq=Hq, Hkv=Hkv, D=D, Dp=D * bits // 8)
    nb, ops = K.b5_gqa(lens, B, Hq, Hkv, D, bits)
    assert nb == eval(gb, {}, env) and ops == eval(go, {}, env)
    assert K.b5_bound_s(cfg, lens, B, bits) == peaks.bound_s(nb, ops,
                                                             "float32")
    R = 288
    env = dict(tok=sum(lens), B=B, H=40, R=R, Rp=R * bits // 8)
    nb, ops = K.b5_latent(lens, B, 40, R, bits)
    assert nb == eval(lb, {}, env) and ops == eval(lo, {}, env)


def test_b3_b4_counts_equal_the_kernel_rows():
    import chip_smoke as CS
    assert K.ENCODE_OPS_PER_VALUE == CS.ENCODE_OPS_PER_VALUE
    assert K.DECODE_OPS_PER_VALUE == CS.DECODE_OPS_PER_VALUE
    src = _smoke_rows()[2]
    assert "nbytes=n * 4 + n + n // 512 * 4," in src
    assert "nbytes=n + n // 512 * 4 + n * 4," in src
    n = 1 << 26
    assert K.b3_encode(n) == (n * 4 + n + n // 512 * 4,
                              CS.ENCODE_OPS_PER_VALUE * n)
    assert K.b4_decode(n) == (n + n // 512 * 4 + n * 4,
                              CS.DECODE_OPS_PER_VALUE * n)


def test_update_bound_sums_every_leaf_twice():
    from repro_torch.optim.adamw import _blk
    numels = [102400 * 4096, 4096, 30 * 4096 * 11008, 30 * 4096]
    for n in numels:
        assert K.moment_block(n, 512) == _blk(n, 512)
    want = sum(2 * (peaks.bound_s(*K.b3_encode(n), "float32") +
                    peaks.bound_s(*K.b4_decode(n), "float32"))
               for n in numels)
    assert K.qpack_update_bound_s(numels, 512) == pytest.approx(want)
