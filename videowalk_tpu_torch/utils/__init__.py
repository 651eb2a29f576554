"""Utilities: device resolution, checkpoints, argument parsing, colors,
the PCA feature images."""
