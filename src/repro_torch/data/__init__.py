"""Synthetic inputs: voxel scenes (``scenes``) and the LM token stream
(``tokens``)."""
