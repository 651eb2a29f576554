"""Walk-loss math: affinities, ZeroSoftmax, palindrome products,
Sinkhorn-Knopp, superpixel masks."""
