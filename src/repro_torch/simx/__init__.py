"""The paper's evaluation layer: workload traces (numpy only), the
delivered-time model and the per-cell evaluation engine."""
