"""The synthetic training data of the port (``repro.data``)."""
