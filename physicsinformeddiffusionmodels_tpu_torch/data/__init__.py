"""Darcy data: the dataset loader and the ground-truth generator."""
