"""Evaluation: label propagation, prediction dumping, DAVIS J&F, JHMDB PCK,
VIP mIoU and the sweep runner. Nothing is imported here, so that the
metric CLIs load neither torch nor a kernel library."""
