"""Voxel grid, eigensolver, voxel-map build and reductions on torch tensors."""
