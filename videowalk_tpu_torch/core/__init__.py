"""Walk-loss math: affinities, ZeroSoftmax, palindrome products."""
