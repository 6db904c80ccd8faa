"""Checkpoints: the template-free ``pytree_v1`` artifact that both
packages read and write."""
