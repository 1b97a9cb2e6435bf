"""The check catches a broken timed path: a run with a fault planted under
the harness (the look for a card skipped, at reduced sizes on the CPU)
comes out not correct against the cell's limits, and the same run sound
comes out correct. Faults: a token altered where it is produced, a decode
step that leaves the cache as it was, a train step that returns its state
unchanged, half the batch left out of the loss (the mean over the rest)."""
from __future__ import annotations

import contextlib

import pytest
import torch

import tiny

SERVE = ["deepseek-7b.serve.oversub", "minicpm3-4b.serve.oversub",
         "deepseek-7b.serve.fit"]


@contextlib.contextmanager
def patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def altered_token(orig):
    def step(params, cache, state, embeds=None, **kw):
        cache, new, done = orig(params, cache, state, embeds, **kw)
        vocab = params["tok_embed"].shape[0]
        new["tok"] = torch.where(state["active"], (new["tok"] + 1) % vocab,
                                 new["tok"])
        return cache, new, done
    return step


def no_op(orig):
    return lambda *a, **kw: None


def _correct(root, workload):
    return tiny.run(root, workload, seconds=1.0)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_sound_serve_run_is_correct(tmp_path, workload):
    assert _correct(tiny.make(tmp_path), workload)


@pytest.mark.parametrize("workload", SERVE)
def test_altered_token_is_not_correct(tmp_path, workload):
    from repro_torch.serve import engine
    with patched(engine, "_engine_step_impl", altered_token):
        assert not _correct(tiny.make(tmp_path), workload)


@pytest.mark.parametrize("workload", SERVE)
def test_decode_step_leaving_the_cache_is_not_correct(tmp_path, workload):
    from repro_torch.kernels import qpack
    with patched(qpack, "ring_step_plain", no_op), \
            patched(qpack, "latent_ring_step_plain", no_op):
        assert not _correct(tiny.make(tmp_path), workload)


def test_sound_train_run_is_correct(tmp_path):
    assert _correct(tiny.make(tmp_path), "deepseek-7b.train.s2k")


def test_train_step_returning_its_state_is_not_correct(tmp_path):
    from repro_torch.optim import adamw

    def unchanged(orig):
        def update(grads, state, params, cfg, *a, **kw):
            g = torch.zeros(())
            return params, state, {"grad_norm": g, "lr": g}
        return update

    with patched(adamw, "update", unchanged):
        assert not _correct(tiny.make(tmp_path), "deepseek-7b.train.s2k")


def test_half_the_batch_is_not_correct(tmp_path):
    from repro_torch.models import transformer

    def half(orig):
        def loss_fn(params, batch, cfg, *a, **kw):
            rows = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return orig(params, rows, cfg, *a, **kw)
        return loss_fn

    with patched(transformer, "loss_fn", half):
        assert not _correct(tiny.make(tmp_path), "deepseek-7b.train.s2k")


@pytest.mark.parametrize("workload", ["deepseek-7b.serve.oversub",
                                      "minicpm3-4b.serve.oversub"])
def test_fp8_control_is_not_correct(tmp_path, workload):
    """The reference one precision below the configuration's (float8
    linear layers for bf16), put in the program's place: its tokens' gap
    fails the limit the program meets, and the run records the control as
    not correct, though the cell's limits file names only the program's
    number."""
    line = tiny.run(tiny.make(tmp_path), workload, seconds=1.0, control=True)
    limit = tiny.LIMITS["serve"]["logit_gap"]
    fp8 = line["variants"]["fp8"]
    assert line["correct"] and fp8["correct"] is False
    assert line["checks"]["logit_gap"]["value"] <= limit < \
        fp8["checks"]["logit_gap"]
    assert "checked_tokens" in line["readings"]


def test_fp8_control_of_training_is_not_correct(tmp_path):
    from bench.harness import train as T
    root = tiny.make(tmp_path)
    ctx, _ = tiny.context(root, "deepseek-7b.train.s2k")
    o = T.optimizer_settings(ctx.mix)
    ref = T.reference_readings(ctx.model, ctx.mix, o, ctx.seed, "cpu")
    low = T.reference_readings(ctx.model, ctx.mix, o, ctx.seed, "cpu", "fp8")
    got = T.compare(low, ref)
    lim = tiny.LIMITS["train"]
    assert any(got[k] > lim[k] for k in lim)


def test_train_control_run_records_each_variant_not_correct(tmp_path):
    """A control run of the train cell: the fp8 control and half the batch,
    each put in the program's place, are held against the cell's limits and
    recorded as not correct, every reading kept."""
    line = tiny.run(tiny.make(tmp_path), "deepseek-7b.train.s2k",
                    control=True)
    assert line["correct"]
    assert set(line["variants"]) == {"fp8", "half_batch"}
    for v in line["variants"].values():
        assert v["correct"] is False
        assert "change_gap_worst_leaf" in v["checks"]
