"""Tarema's phases in PyTorch: profiling, grouping, labeling, allocation."""
