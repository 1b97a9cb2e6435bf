"""IBEX core: bit packing, metadata, compressor, free lists, metadata cache,
activity region and the pool engine."""
