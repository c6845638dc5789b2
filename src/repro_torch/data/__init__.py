"""Synthetic voxel scenes."""
