"""The traffic generator: deterministic from the seed, the stated
distributions, the same set of sizes for every seed."""
from __future__ import annotations

import json
import statistics
from collections import Counter

import pytest
import torch

from tiny import REPO, SEED
from bench.harness.traffic import ServeTraffic, TrainFeed, quantiles


def _mix(name):
    return json.loads((REPO / "bench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["serve.oversub", "serve.fit"])
def test_serve_deterministic_from_seed(name):
    a, b = (ServeTraffic(_mix(name), 102400, SEED) for _ in range(2))
    c = ServeTraffic(_mix(name), 102400, SEED + 1)
    for k in (0, 5, 63, 64, 200):
        assert a.request(k) == b.request(k)
    assert [a.lengths(k) for k in range(64)] != \
        [c.lengths(k) for k in range(64)]


@pytest.mark.parametrize("name", ["serve.oversub", "serve.fit"])
def test_every_seed_the_same_sizes_in_another_order(name):
    mix = _mix(name)
    n = mix["stratum"]
    for s in range(3):
        for part in (0, 1):              # prompt lengths, output lengths
            sets = []
            for seed in (1, SEED, 2 ** 40 + 3):
                t = ServeTraffic(mix, 102400, seed)
                sets.append(Counter(t.lengths(k)[part] for k in
                                    range(s * n, (s + 1) * n)))
            assert sets[0] == sets[1] == sets[2]


@pytest.mark.parametrize("name", ["serve.oversub", "serve.fit"])
def test_stated_distributions(name):
    mix = _mix(name)
    t = ServeTraffic(mix, 102400, SEED)
    lens = [t.lengths(k) for k in range(mix["stratum"] * 4)]
    prompts, outs = [p for p, _ in lens], [o for _, o in lens]
    assert min(prompts) >= 256 and max(prompts) <= 1792
    assert min(outs) >= 16 and max(outs) <= 255
    assert abs(statistics.median(prompts) - 1024) <= 16
    assert abs(statistics.median(outs) - 128) <= 4
    # lognormal: the log-lengths' quartiles at median * exp(+-0.674 sigma)
    q = quantiles(mix["prompt"], 1000)
    assert abs(q[250] - 1024 * 2.718281828 ** (-0.6745 * 0.4)) < 8


def test_prompt_ids_uniform_over_vocab():
    t = ServeTraffic(_mix("serve.oversub"), 73448, SEED)
    ids = [i for k in range(8) for i in t.request(k)[0]]
    assert min(ids) >= 0 and max(ids) < 73448
    assert abs(statistics.mean(ids) / 73448 - 0.5) < 0.05


def test_train_feed_deterministic_and_rows_differ():
    mix = dict(_mix("train.s2k"), batch=4, seq_len=64)
    a, b = (TrainFeed(mix, 1000, SEED, "cpu") for _ in range(2))
    x, y = a.next(), b.next()
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    nxt = a.next()
    rows = torch.cat([x["tokens"], nxt["tokens"]])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
