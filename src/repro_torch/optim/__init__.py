"""The optimizer of the port (``repro.optim``): AdamW with the IBEX-
compressed state, and error-feedback gradient compression."""
