"""Configs, bit helpers, counted host syncs and the threefry PRNG."""
