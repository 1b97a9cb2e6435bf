"""The port's roofline (``repro_torch.roofline``) against the JAX
package's ``repro.roofline`` on the same inputs, exactly, with the
reference module's roofs set to the H100's for the comparison (pytest's
monkeypatch; the JAX package is not edited): ``model_flops``,
``roofline_terms``, ``analyze_record``, ``kernel_roofline``,
``tokens_for``, ``fmt`` and ``markdown``. Then ``kernel_bound`` against
every row of PERF.md §6's kernel table: each row's bytes and operations
as ``chip_smoke.py`` counts them at the row's shape (B2's bytes follow
its codes' rates and B5's its lanes' lengths, printed by that run), and
the Bound column's digits and its "bytes"/"operations".
"""
import json

import pytest

pytest.importorskip("jax")

from repro.roofline import analyze as JA  # noqa: E402
from repro.roofline import report as JR  # noqa: E402
from repro_torch.common.types import ALL_SHAPES  # noqa: E402
from repro_torch.roofline import analyze as RA  # noqa: E402
from repro_torch.roofline import report as RR  # noqa: E402


@pytest.fixture
def h100(monkeypatch):
    """The reference's module at the H100's roofs."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JA, name, getattr(RA, name))


def test_h100_roofs():
    assert (RA.PEAK_FLOPS, RA.PEAK_FLOPS_F32, RA.HBM_BW, RA.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    # the memory a process can have of an H100 80GB HBM3, under 80 GiB
    assert RA.HBM_BYTES == 85_017_493_504 < 80 * 2 ** 30


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_reference(kind):
    for params, active, tokens in ((8_029_995_008, 8_029_995_008, 4096),
                                   (235_092_836_352, 22_000_000_000, 1),
                                   (1, 1, 1 << 20)):
        assert RA.model_flops(params, active, tokens, kind) == \
            JA.model_flops(params, active, tokens, kind)


COLLECTIVES = [{}, {"all-reduce": 5.95e9, "all-gather": 3.49e9},
               {"all-reduce": 1.0, "reduce-scatter": 2.0, "all-to-all": 3.0,
                "collective-permute": 4.0, "all-gather": 5.0}]


@pytest.mark.parametrize("coll", COLLECTIVES, ids=["none", "mesh", "all"])
def test_roofline_terms_equal_reference(h100, coll):
    for flops, nbytes, chips, kind in ((2.65e14, 1.3e11, 1, "train"),
                                       (1e9, 1e12, 8, "decode"),
                                       (0.0, 1.0, 256, "prefill")):
        kw = dict(flops=flops, bytes_accessed=nbytes, collective=coll,
                  chips=chips, params=8_029_995_008,
                  active_params=8_029_995_008, tokens=4096, kind=kind)
        assert RA.roofline_terms(**kw).as_dict() == \
            JA.roofline_terms(**kw).as_dict()


def _record(mesh, status="ok"):
    return {"status": status, "mesh": mesh, "flops": 3.3e14,
            "bytes_accessed": 1.2e11,
            "collective_bytes": {"all-reduce": 2.0e9, "all-gather": 1.0e9,
                                 "total": 3.0e9},
            "params": 8_029_995_008, "active_params": 8_029_995_008}


@pytest.mark.parametrize("mesh", [[1, 1], [4, 2], [2, 16, 16]],
                         ids=lambda m: "x".join(map(str, m)))
def test_analyze_record_equal_reference(h100, mesh):
    for kind, tokens in (("train", 4096), ("decode", 128)):
        got = RA.analyze_record(_record(mesh), tokens, kind)
        assert got.as_dict() == JA.analyze_record(_record(mesh), tokens,
                                                  kind).as_dict()
    assert RA.analyze_record(_record(mesh, "skipped"), 1, "train") is None
    assert JA.analyze_record(_record(mesh, "skipped"), 1, "train") is None


def test_f32_flops_priced_at_the_f32_peak():
    """The float32 part of a count's FLOPs takes the f32 peak, the rest
    the tensor cores'; none of it leaves the reference's term."""
    kw = dict(bytes_accessed=1.0, collective={}, chips=1, params=1,
              active_params=1, tokens=1, kind="train")
    rl = RA.roofline_terms(flops=3e14, flops_f32=2.75e12, **kw)
    assert rl.compute_s == (3e14 - 2.75e12) / 989e12 + 2.75e12 / 67e12
    assert RA.roofline_terms(flops=3e14, flops_f32=3e14, **kw).compute_s \
        == 3e14 / 67e12
    rec = dict(_record([1, 1]), flops_f32=1e12)
    assert RA.analyze_record(rec, 8, "train").compute_s == \
        (3.3e14 - 1e12) / 989e12 + 1e12 / 67e12
    assert RA.analyze_record(rec, 8, "train").hlo_flops == 3.3e14


def test_analyze_record_without_collectives():
    """A serve cell's null collectives price as none."""
    rec = dict(_record([1, 1]), collective_bytes=None)
    assert RA.analyze_record(rec, 8, "decode").collective_s == 0.0


def test_kernel_roofline_equal_reference():
    rows = [{"name": "qpack_fixed_encode_train", "bytes": 336068608,
             "us": 110.102},
            {"name": "flash_attention", "bytes": 167772160, "us": 209.894},
            {"name": "fused_promote", "bytes": 5944, "us": 2.968},
            {"name": "empty", "bytes": 0, "us": 1.0},
            {"name": "untimed", "bytes": 10, "us": 0.0}]
    assert RA.kernel_roofline(rows) == JA.kernel_roofline(
        rows, hbm_bw=RA.HBM_BW)
    assert [r["bound"] for r in RA.kernel_roofline(rows)] == \
        ["bandwidth", "overhead", "overhead"]


@pytest.mark.parametrize("shape", [s.name for s in ALL_SHAPES])
def test_tokens_for_equal_reference(shape):
    assert RR.tokens_for(shape) == JR.tokens_for(shape)


def test_fmt_equal_reference():
    for v in (0, 0.0, 3e-10, 1e-6, 2.5e-5, 1e-3, 0.0123, 0.5, 1.0, 123.456,
              7.0e6):
        assert RR.fmt(v) == JR.fmt(v), v


def test_markdown_equal_reference(tmp_path):
    """``markdown`` of the port's rows (``build_rows`` over two records
    written here and a skipped cell) against the reference's on the same
    rows; the roofline fraction uses the H100's peak."""
    recs = [dict(_record([4, 2]), cell="llama3_8b__train_4k__d8",
                 arch="llama3_8b", shape="train_4k", kind="train",
                 tokens=4096 * 256, fits=True,
                 memory={"argument_bytes": 5e10, "temp_bytes": 2e10}),
            dict(_record([1, 1]), cell="llama3_8b__decode_32k__d1",
                 arch="llama3_8b", shape="decode_32k", kind="decode",
                 tokens=128, fits=False, collective_bytes=None,
                 memory={"argument_bytes": 9e10, "temp_bytes": 1e9}),
            {"cell": "llama3_8b__long_500k__d8", "status": "skipped",
             "reason": "full attention"}]
    for r in recs:
        (tmp_path / f"{r['cell']}.json").write_text(json.dumps(r))
    rows = RR.build_rows(str(tmp_path))
    assert [r["cell"] for r in rows] == sorted(r["cell"] for r in recs)
    assert RR.markdown(rows) == JR.markdown(rows)
    train = next(r for r in rows if r["cell"].endswith("train_4k__d8"))
    assert train["roofline_frac"] == RA.model_flops(
        8_029_995_008, 8_029_995_008, 4096 * 256, "train") / (
        8 * RA.PEAK_FLOPS) / train["bound_s"]
    assert [r["cell"] for r in RR.build_rows(str(tmp_path), "d8")] == \
        ["llama3_8b__long_500k__d8", "llama3_8b__train_4k__d8"]


# PERF.md §6's kernel table: (row, bytes, operations, their type, the Bound
# column, bound by). Phase 5's B1/B2 rows count 18 f32 operations a value
# for encode and 2 for decode (chip_smoke.ENCODE/DECODE_OPS_PER_VALUE); the
# B3 steps count none.
ENC, DEC = 18, 2
KERNEL_ROWS = [
    ("B1 encode 32 x 512", 65792, ENC * 32 * 512, "float32", "0.0000196",
     "bytes"),
    ("B1 encode 65,536 x 512", 134742016, ENC * 65536 * 512, "float32",
     "0.040221", "bytes"),
    ("B1 demote 8 pages", 65888, ENC * 8 * 4 * 512, "float32", "0.0000197",
     "bytes"),
    ("B2 decode 4 x 512", 6172, DEC * 4 * 512, "float32", "0.0000018",
     "bytes"),
    ("B2 decode 65,536 x 512", 89786264, DEC * 65536 * 512, "float32",
     "0.026802", "bytes"),
    ("B2 promote 1 page", 5944, DEC * 4 * 512, "float32", "0.0000018",
     "bytes"),
    ("B3 encode 1 x 1024 x 8 x 128", 2654208, 0, "bfloat16", "0.000792",
     "bytes"),
    ("B3 ring step 8 x 8 x 128", 107072, 0, "bfloat16", "0.0000320",
     "bytes"),
    ("B3 prefill fill 8 x 128", 6356996, 0, "bfloat16", "0.001898", "bytes"),
    ("B3 lane flush 32 layers", 42467584, 0, "bfloat16", "0.012677",
     "bytes"),
    ("B4 8 x 2048 x 8 x 128", 42467328, 0, "bfloat16", "0.012677", "bytes"),
    ("B5 8 x 32 x 128", 2921952, 41009152, "bfloat16", "0.000872", "bytes"),
    ("B6 8 x 1024 32/8 x 128", 167772160, 68786585600, "bfloat16",
     "0.069552", "operations"),
    ("B6 4 x 1024 32/8 x 128", 83886080, 34393292800, "bfloat16", "0.034776",
     "operations"),
    ("B6 1 x 1024 32/8 x 128", 20971520, 8598323200, "bfloat16", "0.008694",
     "operations"),
    ("B3 latent ring step", 15072, 0, "bfloat16", "0.0000045", "bytes"),
    ("B3 latent prefill fill", 888836, 0, "bfloat16", "0.000265", "bytes"),
    ("B3 latent lane flush", 11491824, 0, "bfloat16", "0.003430", "bytes"),
    ("B4 block 288", 11862016, 0, "bfloat16", "0.003541", "bytes"),
    ("B5 latent bf16", 925996, 115338240, "bfloat16", "0.000276", "bytes"),
    ("B5 latent f32", 1110316, 115338240, "float32", "0.001721",
     "operations"),
    ("B6 MLA 8 x 1024", 209715200, 53739520000, "bfloat16", "0.062602",
     "bytes"),
    ("B6 MLA 4 x 1024", 104857600, 26869760000, "bfloat16", "0.031301",
     "bytes"),
    ("B6 MLA 1 x 1024", 26214400, 6717440000, "bfloat16", "0.007825",
     "bytes"),
    ("B3 ring step 4 KV heads", 53568, 0, "bfloat16", "0.0000160", "bytes"),
    ("B3 prefill fill 4 KV heads", 3178500, 0, "bfloat16", "0.000949",
     "bytes"),
    ("B3 lane flush 4 KV heads", 7962720, 0, "bfloat16", "0.002377",
     "bytes"),
    ("B5 G 16", 1758976, 82018304, "bfloat16", "0.000525", "bytes"),
    ("B5 G 7", 3070944, 71766016, "bfloat16", "0.000917", "bytes"),
    ("B6 64/4 8 x 1024", 285212672, 137573171200, "bfloat16", "0.139103",
     "operations"),
    ("B6 64/4 4 x 1024", 142606336, 68786585600, "bfloat16", "0.069552",
     "operations"),
    ("B6 64/4 1 x 1024", 35651584, 17196646400, "bfloat16", "0.017388",
     "operations"),
    ("B3 ring step 24 x 64", 161344, 0, "bfloat16", "0.0000482", "bytes"),
    ("B3 prefill fill 24 x 64", 9633796, 0, "bfloat16", "0.002876", "bytes"),
    ("B3 lane flush 24 x 64", 96731520, 0, "bfloat16", "0.028875", "bytes"),
    ("B5 G 1 D 64", 4179296, 14592000, "bfloat16", "0.001248", "bytes"),
    ("B5 G 8 64 heads", 2981344, 77824000, "bfloat16", "0.000890", "bytes"),
    ("B6 24/24 x 64 8 x 1024", 100663296, 25794969600, "bfloat16",
     "0.030049", "bytes"),
    ("B6 24/24 x 64 4 x 1024", 50331648, 12897484800, "bfloat16", "0.015024",
     "bytes"),
    ("B6 24/24 x 64 1 x 1024", 12582912, 3224371200, "bfloat16", "0.003756",
     "bytes"),
    ("B6 64/8 8 x 1024", 301989888, 137573171200, "bfloat16", "0.139103",
     "operations"),
    ("B6 64/8 4 x 1024", 150994944, 68786585600, "bfloat16", "0.069552",
     "operations"),
    ("B6 64/8 1 x 1024", 37748736, 17196646400, "bfloat16", "0.017388",
     "operations"),
    ("B3 ring step 32 x 80", 268352, 0, "bfloat16", "0.0000801", "bytes"),
    ("B3 prefill fill 32 x 80", 15990788, 0, "bfloat16", "0.004773",
     "bytes"),
    ("B3 lane flush 32 x 80", 30081096, 0, "bfloat16", "0.008979", "bytes"),
    ("B5 G 1 D 80", 6812960, 24320000, "bfloat16", "0.002034", "bytes"),
    ("B6 32/32 x 80 8 x 1024", 167772160, 42991616000, "bfloat16",
     "0.050081", "bytes"),
    ("B6 32/32 x 80 4 x 1024", 83886080, 21495808000, "bfloat16", "0.025041",
     "bytes"),
    ("B6 32/32 x 80 1 x 1024", 20971520, 5373952000, "bfloat16", "0.006260",
     "bytes"),
    ("B3 AdamW moments", 336068608, 1207959552, "float32", "0.100319",
     "bytes"),
    ("B4 AdamW moments", 336068608, 134217728, "float32", "0.100319",
     "bytes"),
    ("B6 train 8 x 512", 83886080, 17213423616, "bfloat16", "0.025041",
     "bytes"),
    ("B3 DP gradient leaf", 672137216, 2415919104, "float32", "0.200638",
     "bytes"),
    ("B4 DP gradient leaf", 672137216, 268435456, "float32", "0.200638",
     "bytes"),
    ("B6 16/4 f32 4 x 256", 20971520, 1077936128, "float32", "0.016089",
     "operations"),
    ("B6 16/4 bf16 8 x 512", 41943040, 8606711808, "bfloat16", "0.012520",
     "bytes"),
]


@pytest.mark.parametrize("row", KERNEL_ROWS, ids=[r[0] for r in KERNEL_ROWS])
def test_kernel_bound_reproduces_perf_table(row):
    _, nbytes, ops, dtype, want, by = row
    ms, got_by = RA.kernel_bound(nbytes, ops, dtype)
    decimals = len(want.split(".")[1])
    assert f"{ms:.{decimals}f}" == want and got_by == by


def test_kernel_bound_takes_torch_dtypes():
    import torch
    assert RA.kernel_bound(20971520, 1077936128, torch.float32) == \
        RA.kernel_bound(20971520, 1077936128, "float32")
    assert RA.kernel_bound(1, 0) == (1 / RA.HBM_BW * 1e3, "bytes")
