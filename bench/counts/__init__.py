"""Frozen counts of the yardstick: the chip's peaks, the model FLOPs of a
token or a training step, and the bytes and operations of the kernels whose
roofline share a metric reads (B5, B3, B4). A copy of the arithmetic of
``repro_torch.roofline`` and ``chip_smoke.py`` as they stood when the
benchmark was made; ``bench/tests/test_bench_counts.py`` holds them equal
there."""
