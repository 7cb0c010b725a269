"""The plain references: `reference/<config>.py` for each configuration,
over the frozen float32 math in `reference/uda/`. They are plain PyTorch and
import nothing of the system under test, nor JAX."""
