"""Pool engine: state, policies, mechanisms and the batched front-end."""
from repro_torch.core.engine.batch import replay_trace
from repro_torch.core.engine.ops import (demote_if_needed, demote_one,
                                         host_read_block, host_write_block,
                                         host_write_page)
from repro_torch.core.engine.policy import DEFAULT_POLICY, POLICIES, Policy
from repro_torch.core.engine.state import (COUNTER_NAMES, NUM_COUNTERS, Pool,
                                           compression_ratio, counters_dict,
                                           make_pool, n_single_chunks)

__all__ = [
    "Pool", "make_pool", "n_single_chunks", "counters_dict",
    "compression_ratio", "COUNTER_NAMES", "NUM_COUNTERS", "Policy",
    "POLICIES", "DEFAULT_POLICY", "host_read_block", "host_write_block",
    "host_write_page", "demote_one", "demote_if_needed", "replay_trace",
]
