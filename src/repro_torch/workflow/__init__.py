"""The simulated workflow engine and its inputs (numpy, shared layout)."""
