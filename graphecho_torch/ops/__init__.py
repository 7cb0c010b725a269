"""Tensor ops of the port: resizes, sampling, Sinkhorn, spectral clustering, the pairwise-MLP kernel."""
