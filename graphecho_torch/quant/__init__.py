from graphecho_torch.quant.ptq import (  # noqa: F401
    QuantizedBackbone,
    fold_bn,
    make_quantized_infer,
    quantize_fpn_backbone,
)
