"""Roofline analysis at an NVIDIA H100 SXM's roofs (the reference's
``repro.roofline.analyze``, whose constants are a TPU v5e's).

Three terms per (arch x shape x mesh), in seconds:
    compute    = bf16 FLOPs / peak_FLOPs + f32 FLOPs / peak_FLOPs_f32
    memory     = HBM_bytes / HBM_bw
    collective = wire_bytes / link_bw
with every input a per-rank quantity of the dry run's record
(``launch/dryrun.py``).

Where the reference reads FLOPs and bytes from XLA's
``compiled.cost_analysis()`` and parses collective bytes out of the
post-SPMD HLO (``collective_bytes_from_hlo``), the port has no HLO: its
dry run counts them from the model config, the rule tables and the
meta device (``roofline/count.py``), so ``collective_bytes_from_hlo`` has
no counterpart here.

``kernel_bound`` is the bound of one kernel row (``chip_smoke.py``'s
kernel table): the larger of the bytes it must move over the HBM rate and
the operations it does over the peak rate of their type.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM5 80 GB data sheet (NVIDIA H100 Tensor Core GPU, "H100
# SXM" column), dense figures (the sparse ones are twice these):
PEAK_FLOPS = 989e12          # bf16 (and fp16) tensor cores, dense
PEAK_FLOPS_F32 = 67e12       # fp32 outside the tensor cores
HBM_BW = 3.35e12             # HBM3, bytes/s
LINK_BW = 450e9              # NVLink 4: 900 GB/s a card, 450 GB/s a direction
# what a process can have of the card's 80 GB of HBM3:
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 (chip_smoke.py phase 21 prints it), 0.82 GiB under 80 GiB
HBM_BYTES = 85_017_493_504

# the peak rate of an operation's type (``kernel_bound``)
PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": PEAK_FLOPS_F32}


def kernel_bound(nbytes: float, ops: float, dtype="bfloat16"
                 ) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the least time the card takes
    for a function that moves ``nbytes`` (each input read once, each output
    written once) and does ``ops`` operations of ``dtype`` (a torch dtype
    or its name; the f32 rate for float32, the tensor cores' for bf16),
    the larger of the two times."""
    name = str(dtype).replace("torch.", "")
    t_b, t_o = nbytes / HBM_BW, ops / PEAK_BY_DTYPE[name]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float

    def as_dict(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
                "useful_ratio": self.useful_ratio}


def model_flops(params: int, active_params: int, tokens: int,
                kind: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch tokens (1 step).
    Training includes backward (the 6x already counts fwd+bwd); inference
    steps use 2*N*D."""
    n = active_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective: Dict[str, float], chips: int,
                   params: int, active_params: int, tokens: int,
                   kind: str, flops_f32: float = 0.0) -> Roofline:
    """Every input but ``chips`` (and the model's sizes) is per rank, as
    the dry run counts it; ``hlo_flops`` is the whole program's (per-rank
    FLOPs x chips), the name kept from the reference. ``flops_f32`` is the
    part of ``flops`` that runs in float32, at ``PEAK_FLOPS_F32``. An
    all-reduce costs about 2x its bytes on the wire, the other kinds 1x."""
    compute_s = (flops - flops_f32) / PEAK_FLOPS + flops_f32 / PEAK_FLOPS_F32
    memory_s = bytes_accessed / HBM_BW
    wire = (2.0 * collective.get("all-reduce", 0.0)
            + collective.get("all-gather", 0.0)
            + collective.get("reduce-scatter", 0.0)
            + collective.get("all-to-all", 0.0)
            + collective.get("collective-permute", 0.0))
    collective_s = wire / LINK_BW
    mf = model_flops(params, active_params, tokens, kind)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    hlo_total = flops * chips
    return Roofline(compute_s, memory_s, collective_s, dominant, mf,
                    hlo_total, mf / hlo_total if hlo_total > 0 else 0.0)


def load_dryrun(results_dir: str = "results/dryrun_torch") -> List[Dict]:
    recs = []
    if not os.path.isdir(results_dir):
        return recs
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def analyze_record(rec: Dict, tokens: int, kind: str) -> Optional[Roofline]:
    """A record's roofline; a serve cell's null collectives (the port
    serves on one device) price as none."""
    if rec.get("status") != "ok":
        return None
    chips = 1
    for s in rec["mesh"]:
        chips *= s
    return roofline_terms(
        flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
        collective=rec["collective_bytes"] or {}, chips=chips,
        params=rec["params"], active_params=rec["active_params"],
        tokens=tokens, kind=kind, flops_f32=rec.get("flops_f32", 0.0))


def kernel_roofline(rows: List[Dict], hbm_bw: float = HBM_BW) -> List[Dict]:
    """Distance-from-bandwidth-bound for measured kernel rows (the qpack
    encode/decode/fused-demote kernels are pure streaming: ~0 FLOPs/byte,
    so the HBM roof *is* their speed-of-light). Each input row needs
    ``name``, ``bytes`` (bytes moved per call) and ``us`` (median time);
    emits GB/s, fraction of the HBM roof, and the bound classification."""
    out = []
    for r in rows:
        us = float(r.get("us", 0.0))
        nbytes = float(r.get("bytes", 0.0))
        if us <= 0 or nbytes <= 0:
            continue
        gbps = nbytes / (us * 1e-6) / 1e9
        frac = gbps * 1e9 / hbm_bw
        out.append({
            "name": r["name"],
            "gbps": gbps,
            "frac_of_hbm_roof": frac,
            "bound": "bandwidth" if frac >= 0.5 else "overhead",
        })
    return out
