"""PyTorch/CUDA port of cofhe_tpu: the same CL_HSM2k threshold cryptosystem
with its batched class-group kernels on int32 limb tensors (Hopper GPUs)."""
