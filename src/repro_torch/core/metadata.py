"""IBEX compression metadata (PyTorch port of ``repro.core.metadata``).

Entry = 8 uint32 words, held as int64 (a row of ``Pool.meta`` on the device,
or a list of 8 Python ints on the host while a slow access edits it):

word0 header
  bits  0..19 : 4 x (block_type 2b | block_sz 3b)     [co-location, §4.6]
  bits 20..23 : num_chunks (0..8)
  bits 24..27 : wr_cntr                                [incompressible retry]
  bit  28     : shadow_valid                           [shadowed promotion §4.5]
  bit  29     : dirty      (promoted copy modified)
  bit  30     : promoted   (P-chunk allocated)
  bit  31     : valid      (entry allocated)
words 1..6    : C-chunk pointers
word  7       : C-chunk pointer OR P-chunk pointer when promoted (29 bits)

Every accessor works on Python ints and on int64 tensors.
"""
from __future__ import annotations

from typing import List

from repro_torch.common.utils import get_bits, set_bits
from repro_torch.core.bitpack import RATE_4BIT, RATE_8BIT, RATE_RAW, RATE_ZERO

ENTRY_WORDS = 8

BT_ZERO = 0
BT_COMP = 1
BT_PROM = 2
BT_INCOMP = 3

RATE_TO_SZ = (0, 2, 4, 7)                                    # indexed by rate
RATE_TO_BT = (BT_ZERO, BT_COMP, BT_COMP, BT_INCOMP)
# sz -> rate (valid sz values 0,2,4,7; others map to zero)
SZ_TO_RATE = (RATE_ZERO, RATE_ZERO, RATE_4BIT, RATE_ZERO,
              RATE_8BIT, RATE_ZERO, RATE_ZERO, RATE_RAW)


# -- header fields of word0 -------------------------------------------------

def get_block_type(w0, i):
    """Block ``i``'s type; ``i`` may be an int or an int tensor."""
    return (w0 >> (i * 5)) & 0x3


def set_block_type(w0, i: int, v):
    return set_bits(w0, 5 * i, 2, v)


def get_block_sz(w0, i: int):
    return get_bits(w0, 5 * i + 2, 3)


def set_block_sz(w0, i: int, v):
    return set_bits(w0, 5 * i + 2, 3, v)


def get_num_chunks(w0):
    return get_bits(w0, 20, 4)


def set_num_chunks(w0, v):
    return set_bits(w0, 20, 4, v)


def get_wr_cntr(w0):
    return get_bits(w0, 24, 4)


def set_wr_cntr(w0, v):
    return set_bits(w0, 24, 4, v)


def get_shadow_valid(w0):
    return get_bits(w0, 28, 1)


def set_shadow_valid(w0, v):
    return set_bits(w0, 28, 1, v)


def get_dirty(w0):
    return get_bits(w0, 29, 1)


def set_dirty(w0, v):
    return set_bits(w0, 29, 1, v)


def get_promoted(w0):
    return get_bits(w0, 30, 1)


def set_promoted(w0, v):
    return set_bits(w0, 30, 1, v)


def get_valid(w0):
    return get_bits(w0, 31, 1)


def set_valid(w0, v):
    return set_bits(w0, 31, 1, v)


# -- pointer slots ------------------------------------------------------------

PTR_MASK = (1 << 29) - 1
PCHUNK_SLOT = ENTRY_WORDS - 2  # word7 == slot 6 (the paper's "last pointer")


def get_ptr(entry, slot: int):
    """Pointer ``slot`` of a host entry (list) or of entries [..., 8]."""
    if isinstance(entry, list):
        return entry[1 + slot] & PTR_MASK
    return entry[..., 1 + slot] & PTR_MASK


def set_ptr(entry: List[int], slot: int, v: int) -> List[int]:
    out = list(entry)
    out[1 + slot] = v & PTR_MASK
    return out


# -- rate <-> (type, sz) mapping (host entries) -------------------------------

def header_from_rates(rates) -> int:
    """word0 block fields from per-block rate codes (not promoted, not
    dirty, wr_cntr=0, valid=1)."""
    w0 = 0
    for i, r in enumerate(rates):
        w0 = set_block_type(w0, i, RATE_TO_BT[r])
        w0 = set_block_sz(w0, i, RATE_TO_SZ[r])
    return set_valid(w0, 1)


def rates_from_header(w0: int, nblocks: int = 4) -> List[int]:
    """Per-block rate codes from the (type, sz) fields."""
    return [RATE_ZERO if get_block_type(w0, i) == BT_ZERO
            else SZ_TO_RATE[get_block_sz(w0, i)] for i in range(nblocks)]


# -- page activity entries (§4.4) ---------------------------------------------

ACT_ALLOCATED_BIT = 31
ACT_REFERENCED_BIT = 30
ACT_OSPN_MASK = (1 << 30) - 1


def act_pack(allocated, referenced, ospn):
    return (allocated << ACT_ALLOCATED_BIT) | \
        (referenced << ACT_REFERENCED_BIT) | (ospn & ACT_OSPN_MASK)


def act_allocated(e):
    return (e >> ACT_ALLOCATED_BIT) & 1


def act_referenced(e):
    return (e >> ACT_REFERENCED_BIT) & 1


def act_ospn(e):
    return e & ACT_OSPN_MASK


def act_set_referenced(e, v):
    return set_bits(e, ACT_REFERENCED_BIT, 1, v)
