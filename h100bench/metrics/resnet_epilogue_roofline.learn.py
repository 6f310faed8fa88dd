"""resnet_epilogue_roofline.learn: the ResNet post-convolution kernels'
share of their bound in the learning window (percent); see
``metrics/resnet_epilogue_roofline.py``."""

from h100bench.metrics.resnet_epilogue_roofline import read  # noqa: F401
