"""gloo's throughput between two ranks that share one card, the transport
of ``chip_smoke.py``'s phases 19b and 20b (NCCL refuses two ranks on one
card): ``all_reduce`` and ``broadcast`` of uint8 tensors of 64 MiB,
512 MiB and 2 GiB, on the card and on the host, three calls each.
Prints one line a case: the sizes, the seconds of each call and GiB/s
of the fastest.

    python3 tools/gloo_bw.py           # needs a card (~1 min)
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def bench(group) -> list:
    """A rank entry point (``common.sharding.spawn_ranks``)."""
    out = []
    for mib in (64, 512, 2048):
        for where in ("cuda", "cpu"):
            for op in ("all_reduce", "broadcast"):
                x = torch.zeros(mib << 20, dtype=torch.uint8,
                                device=group.device if where == "cuda"
                                else "cpu")
                secs = []
                for _ in range(3):
                    if where == "cuda":
                        torch.cuda.synchronize()
                    dist.barrier()
                    t = time.perf_counter()
                    if op == "all_reduce":
                        dist.all_reduce(x)
                    else:
                        dist.broadcast(x, src=0)
                    if where == "cuda":
                        torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                out.append((mib, where, op, [round(s, 3) for s in secs],
                            round(mib / 1024 / min(secs), 2)))
                del x
    return out


def main() -> int:
    from repro_torch.common import sharding as SH
    if not torch.cuda.is_available():
        print("gloo_bw: no CUDA device", file=sys.stderr)
        return 2
    for mib, where, op, secs, rate in SH.spawn_ranks(
            bench, 2, backend="gloo", device="cuda:0", timeout=600)[0]:
        print(f"gloo {op} {mib} MiB on the {where}: {secs} s, {rate} GiB/s "
              f"[{torch.cuda.get_device_name(0)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
