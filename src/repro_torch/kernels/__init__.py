"""Hand-written Hopper kernels, their plain PyTorch versions, and the ops that dispatch between them."""
