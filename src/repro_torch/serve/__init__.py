"""Serving engines of the port: the batched scheduler and its per-lane
baseline."""
from repro_torch.serve.engine import DONE, Engine, Request
from repro_torch.serve.serial import SerialEngine

__all__ = ["DONE", "Engine", "Request", "SerialEngine"]
