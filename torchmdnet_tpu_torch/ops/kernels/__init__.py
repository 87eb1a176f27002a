"""Hand-written CUDA kernels of the port and their launch wrappers.

Each kernel module holds the wrapper (an ``autograd.Function`` where the
kernel has a gradient), the plain PyTorch version of the same function, and a
launch count on each wrapper.  A wrapper takes the plain version only for
tensors on the CPU; a CUDA tensor goes to the kernel or raises.
"""
