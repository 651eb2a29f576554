"""The benchmark harness: shared code of every cell."""
