"""Roofline of the port on an NVIDIA H100 (the reference's
``repro.roofline``): ``analyze`` prices cells and kernel rows at the card's
roofs, ``count`` counts a step's work per rank from the model config,
``report`` tabulates the dry run's records."""
from repro_torch.roofline import analyze  # noqa: F401
