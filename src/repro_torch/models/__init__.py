"""The dense GQA language model of the port: layers, the full-sequence
forward, and the serving decode path over the compressed KV cache."""
