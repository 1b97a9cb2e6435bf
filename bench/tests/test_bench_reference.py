"""The plain reference against the port at reduced sizes, both in float32:
the served tokens' logits (prefill, decode through the 4-bit cache, parks
and resumes) and the training step (loss, gradient, the compressed AdamW
update) agree to rounding."""
from __future__ import annotations

import pytest

import tiny


@pytest.mark.parametrize("workload", ["deepseek-7b.serve.oversub",
                                      "minicpm3-4b.serve.oversub",
                                      "deepseek-7b.serve.fit"])
def test_served_tokens_match_reference_in_float32(tmp_path, workload):
    root = tiny.make(tmp_path, dtype="float32")
    line = tiny.run(root, workload, seconds=1.0)
    gap = line["checks"]["logit_gap"]["value"]
    assert 0.0 <= gap < 1e-4


@pytest.mark.parametrize("workload", ["deepseek-7b.serve.oversub",
                                      "minicpm3-4b.serve.oversub"])
def test_parked_requests_are_checked(tmp_path, workload):
    from bench.harness import cell
    ctx, bench = tiny.context(tiny.make(tmp_path), workload, seconds=1.0)
    picked = []
    from bench.harness import serve
    orig = serve.choose

    def spy(*a, **kw):
        out = orig(*a, **kw)
        picked.extend(out)
        return out

    serve.choose = spy
    try:
        cell.run(ctx, bench)
    finally:
        serve.choose = orig
    assert any(f.parks and f.resumed_in_window for f in picked)


def test_train_step_matches_reference_in_float32(tmp_path):
    root = tiny.make(tmp_path, dtype="float32")
    line = tiny.run(root, "deepseek-7b.train.s2k")
    c = {k: v["value"] for k, v in line["checks"].items()}
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-3
    assert c["change_gap"] < 1e-3
