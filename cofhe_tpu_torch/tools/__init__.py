"""Scripts that run beside chip_smoke.py: kernel measurements on a CUDA card
(kernel_compare) and the per-rank runner of the multi-card engine (mesh_check)."""
