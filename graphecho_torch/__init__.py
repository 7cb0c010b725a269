"""graphecho_torch: the PyTorch/CUDA port of graphecho_tpu for one NVIDIA H100.

Module names follow the JAX package (`graphecho_tpu`), which stays in the
repository as the reference. This package imports neither JAX nor anything of
`graphecho_tpu`; where it needs a jax-free module of the reference (the
config, the synthetic data) it keeps its own copy.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no GPU
and no `device` argument they raise (`graphecho_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
