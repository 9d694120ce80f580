"""Hand-written Hopper kernels for the solver's hot ops.

The auction round's score/choose — a masked bid plus running argmax over
the [P, N] pod×node surface — is :mod:`bid_argmax`: a CUDA C++ kernel
(``csrc/bid_argmax.cu``) that keeps nothing [P, N]-shaped in device memory.
"""
