"""PyTorch/CUDA port of the IBEX compressed-memory pool (``repro``'s main
path): pool state, mechanisms, the batched replay front-end, and the fused
demote/promote CUDA kernels. Imports ``torch`` and ``numpy`` only."""
