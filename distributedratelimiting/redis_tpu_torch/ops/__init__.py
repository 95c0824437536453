"""Device-side operations: bucket math (L0), the plain batch operations
(L1) and the hand-written CUDA kernels that replace them on the card."""
