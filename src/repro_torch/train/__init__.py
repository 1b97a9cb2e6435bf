"""The training stack of the port (``repro.train``): the train step,
checkpoints and elastic planning."""
