"""On-card measurement scripts for the port (need a CUDA device)."""
