"""Command-line tools of the port that run on the CUDA card."""
