"""Plain reference of the `cardiac` configuration: the CardiacUDA recipe
(VGG16-FPN, the temporal graph and the cycle loss) in float32."""

from benchmark.reference.uda import config  # noqa: F401  (the factories the config names)
from benchmark.reference.uda.step import TrainReference, kernel_call_shapes  # noqa: F401
