"""Plain reference of the `camus` configuration: the CAMUS->EchoNet recipe
(ResNet50-quirk FPN, graph matching and discriminators) in float32."""

from benchmark.reference.uda import config  # noqa: F401  (the factories the config names)
from benchmark.reference.uda.step import TrainReference, kernel_call_shapes  # noqa: F401
